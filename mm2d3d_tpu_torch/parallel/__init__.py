"""Data parallelism of mm2d3d_tpu_torch: one process per device
(`parallel.mesh`)."""
