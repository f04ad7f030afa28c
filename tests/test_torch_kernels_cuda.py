"""The hand-written CUDA kernels of mm2d3d_tpu_torch against their plain
PyTorch versions on the card, at edge shapes the flagship does not reach:
ragged voxel counts, more than 128 output channels, Ci = 3 and 224, odd
image sizes, empty inputs, NaN, and the inputs the kernels refuse.

Needs a CUDA device (and nvcc to build the kernels); skips without one.  On
a machine with a card and no JAX, run it without the repo's conftest.py
(which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

K3 and K4 must be bit-identical to their plain versions; K1 within
1e-4 * max|plain| (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.ops.kernels import bandmm, maxpool, propagate

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _taps(r, h, v, k):
    """Ascending random taps per column with ~30% misses (k); never the
    centre for 27-tap tables."""
    t = np.sort(r.randint(0, k, size=(h, v)), axis=0)
    if k == 27:
        t[t == 13] = 14
    t[r.rand(h, v) < 0.3] = k
    return t.astype(np.int32)


BANDMM = {
    # name: (V, H, K, Ci, Co, with_xm)
    "ragged_v_two_co_blocks": (1000, 4, 27, 16, 200, True),
    "ci3_input_conv": (777, 3, 27, 3, 16, True),
    "ci224_decoder_concat": (300, 5, 27, 224, 112, False),
    "strided_k8": (513, 1, 8, 48, 64, False),
    "centre_only": (130, 0, 27, 8, 24, True),
    "empty": (0, 3, 27, 16, 16, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BANDMM))
def test_bandmm_matches_plain_version(dev, case, dtype):
    v, h, k, ci, co, with_xm = BANDMM[case]
    r = np.random.RandomState(v + h)

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    xm = t(r.randn(v, ci).astype(np.float32)) if with_xm else None
    x_src = t(r.randn(h, v, ci).astype(np.float32)) if h else None
    tap = t(_taps(r, h, v, k), torch.int32) if h else None
    w = t((r.randn(k, ci, co) * 0.1).astype(np.float32))
    before = bandmm.KERNEL.launches
    out = bandmm.slot_conv_apply(xm, x_src, tap, w)
    assert bandmm.KERNEL.launches == before + 1
    ref = bandmm.slot_conv_apply_ref(xm, x_src, tap, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (v, co)
    if v:
        err = float((out - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


def test_bandmm_refuses_what_it_cannot_take(dev):
    w = torch.randn(27, 16, 8, device=dev)
    x = torch.randn(3, 64, 16, device=dev)
    tap = torch.zeros((3, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        bandmm.slot_conv_apply(None, x.transpose(0, 1).contiguous().transpose(0, 1),
                               tap, w)
    with pytest.raises(TypeError):
        bandmm.slot_conv_apply(None, x.bfloat16(), tap, w)
    with pytest.raises(ValueError, match="several devices"):
        bandmm.slot_conv_apply(None, x, tap.cpu(), w)


@pytest.mark.parametrize("h1", [0, 3, 8, 26])
def test_propagate_bit_identical(dev, h1):
    r = np.random.RandomState(h1)
    v = 1111
    # candidate ids in [0, V], with V (the miss) about half the time
    crows = np.where(r.rand(8, 8, v) < 0.5, v, r.randint(0, v, (8, 8, v)))
    par = r.randint(0, 2, (3, v))
    valid = (r.rand(1, v) < 0.9).astype(np.int32)
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (crows, par, valid)]
    out = propagate.propagate_slots(*args, h1)
    ref = propagate.propagate_slots_ref(*args, h1)
    for name, a, b in zip(("nbr", "src1", "tap1", "cnt"), out, ref):
        assert a.dtype == torch.int32 and torch.equal(a, b), name


MAXPOOL = {
    "odd_hw": (2, 33, 47, 64),
    "odd_h_even_w": (2, 17, 10, 64),
    "one_pixel": (1, 1, 1, 8),
    "c8": (3, 6, 5, 8),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(MAXPOOL))
def test_maxpool_bit_identical(dev, case, dtype):
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(MAXPOOL[case], generator=g, device=dev).to(dtype)
    x = torch.where(x > 1.5, torch.full_like(x, float("nan")), x)  # NaN wins
    x = torch.where(x < -1.5, torch.full_like(x, float("-inf")), x)
    x = x.round(decimals=1)  # ties: the first in window order is kept
    out, ref = maxpool.maxpool3x3s2(x), maxpool.maxpool3x3s2_ref(x)
    assert out.shape == ref.shape
    assert torch.equal(out.isnan(), ref.isnan())
    assert torch.equal(out.nan_to_num(), ref.nan_to_num())


def test_maxpool_refuses_what_it_cannot_take(dev):
    flat = torch.randn(1 + 2 * 9 * 11 * 16, device=dev)
    x = flat[1:].view(2, 9, 11, 16)  # contiguous, 4 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        maxpool.maxpool3x3s2(x)
    with pytest.raises(ValueError, match="multiple of 8"):
        maxpool.maxpool3x3s2(torch.randn(2, 9, 11, 12, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        maxpool.maxpool3x3s2(torch.randn(2, 9, 11, 16, device=dev).transpose(1, 2))
