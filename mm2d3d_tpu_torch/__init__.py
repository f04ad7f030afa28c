"""PyTorch + CUDA port of mm2d3d_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (`ops/`, `models/`, `train/`, `data/`); the
TPU's Pallas kernels become hand-written CUDA kernels in `csrc/`, built at
first use (`ops/kernels`).  Imports torch and numpy only, never jax.
"""
