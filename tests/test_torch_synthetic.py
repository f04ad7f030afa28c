"""mm2d3d_tpu_torch.data.synthetic.make_batch vs the JAX package's: every
field bit-identical for the same RandomState."""

import numpy as np
import pytest
import torch

from _torch_port import assert_equal, jax_batch

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.train.batch import prepare_device_batch as prepare_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.train.batch import prepare_device_batch

DRYRUN = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256)
FLAGSHIP_SCAN = dict(batch_size=1, height=225, width=400, n_points=8192,
                     full_scale=4096)
KITTI_SCAN = dict(batch_size=1, height=302, width=480, n_points=10240,
                  full_scale=4096, variant="kitti")
FIELDS = ("img", "depth", "img_indices", "coords", "feats", "seg_label",
          "point_mask", "seg_labels_2d", "point_perm")


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", ["dryrun", "flagship_scan", "kitti_scan"])
def test_make_batch_bit_identical(seed, wire, size):
    kw = {"dryrun": DRYRUN, "flagship_scan": FLAGSHIP_SCAN, "kitti_scan": KITTI_SCAN}[size]
    port = make_batch(np.random.RandomState(seed), wire=wire, **kw)
    ref = make_batch_jax(np.random.RandomState(seed), wire=wire, **kw)
    for name in FIELDS:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, name
            assert_equal(a, b, name)
    assert port.coords_sorted == ref.coords_sorted
    assert port.feats_from_img == ref.feats_from_img == wire


def test_make_batch_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        make_batch(np.random.RandomState(0), variant="velodyne", **DRYRUN)


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_device_batch_wire(seed):
    """uint8 wire batch -> float image and gathered feats, as the JAX
    prepare_device_batch gives them."""
    port = prepare_device_batch(
        make_batch(np.random.RandomState(seed), wire=True, **DRYRUN))
    ref = prepare_jax(jax_batch(
        make_batch_jax(np.random.RandomState(seed), wire=True, **DRYRUN)))
    for name in ("img", "feats"):
        assert_equal(getattr(port, name), getattr(ref, name), name)
    assert not port.feats_from_img


def test_prepare_device_batch_refuses_jitter():
    """Colour jitter applies to the uint8 wire image only: a float batch
    carrying `jitter_params` is refused the jitter and passes through
    untouched, as in the JAX package."""
    params = torch.tensor([[1.3, 1.0, 1.0, 0.0]] * 2)  # brightness x1.3
    flt = make_batch(np.random.RandomState(0), **DRYRUN)
    flt.jitter_params = params
    assert prepare_device_batch(flt) is flt
    wire = make_batch(np.random.RandomState(0), wire=True, **DRYRUN)
    plain = prepare_device_batch(wire)
    wire.jitter_params = params
    jittered = prepare_device_batch(wire)
    assert jittered.jitter_params is None
    assert torch.equal(jittered.img, torch.clamp(plain.img * params[0, 0], 0, 1))


def test_port_imports_without_jax():
    """The port's modules and chip_smoke.py import with jax made
    unimportable (the card's machine has no JAX)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'mm2d3d_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "import mm2d3d_tpu_torch.train.step, mm2d3d_tpu_torch.flagship\n"
        "import mm2d3d_tpu_torch.data.synthetic, mm2d3d_tpu_torch.models.convert\n"
        "import mm2d3d_tpu_torch.train.optim, mm2d3d_tpu_torch.ops.image\n"
        "import mm2d3d_tpu_torch.tools.profile_forward\n"
        "import mm2d3d_tpu_torch.native, mm2d3d_tpu_torch.data.host_topology\n"
        "import mm2d3d_tpu_torch.parallel.mesh, mm2d3d_tpu_torch.tools.ddp_check\n"
        "import mm2d3d_tpu_torch.run, mm2d3d_tpu_torch.train.trainer\n"
        "import mm2d3d_tpu_torch.tools.bench_loader, mm2d3d_tpu_torch.tools.mlflow_ops\n"
        "import mm2d3d_tpu_torch.data.preprocess.nuscenes_lidarseg\n"
        "import mm2d3d_tpu_torch.tools.autotune, mm2d3d_tpu_torch.tools.doctor\n"
        "import mm2d3d_tpu_torch.models.torch_import\n"
        "import mm2d3d_tpu_torch.tools.exp_dma_gather\n"
        "import mm2d3d_tpu_torch.tools.exp_bandmm_variants\n"
        "import mm2d3d_tpu_torch.tools.bench_e2e\n"
        "import mm2d3d_tpu_torch.tools.profile_topology\n"
        "from mm2d3d_tpu_torch.ops import kernels\n"
        "assert sorted(kernels.all_kernels()) == ['bandmm', 'bandmm_dw', 'batchnorm2d', "
        "'exp_bandmm', "
        "'exp_group_gather', 'exp_window_copy', 'exp_window_gather', 'head2d', "
        "'maxpool', 'propagate', 'slot_gather', 'tapsum']\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
