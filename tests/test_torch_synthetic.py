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
FIELDS = ("img", "depth", "img_indices", "coords", "feats", "seg_label",
          "point_mask", "seg_labels_2d", "point_perm")


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", ["dryrun", "flagship_scan"])
def test_make_batch_bit_identical(seed, wire, size):
    kw = DRYRUN if size == "dryrun" else FLAGSHIP_SCAN
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
    b = make_batch(np.random.RandomState(0), wire=True, **DRYRUN)
    b.jitter_params = torch.zeros((2, 4))
    with pytest.raises(NotImplementedError):
        prepare_device_batch(b)


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
        "from mm2d3d_tpu_torch.ops import kernels\n"
        "assert sorted(kernels.all_kernels()) == ['bandmm', 'maxpool', 'propagate']\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
