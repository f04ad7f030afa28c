"""The hand-written CUDA kernels of mm2d3d_tpu_torch against their plain
PyTorch versions on the card, at edge shapes the flagship does not reach:
ragged voxel counts, more than 128 output channels, Ci = 3 and 224, odd
image sizes and crops, empty inputs, NaN, and the inputs the kernels
refuse; the autograd Functions around them (the sparse-conv adjoints, the
dense form's included, the stem pool's and the fused head's backward) on
the card against the same Functions on the CPU; and the 2D branch's
train-mode gradients on the card against the CPU's.

Needs a CUDA device (and nvcc to build the kernels); skips without one.  On
a machine with a card and no JAX, run it without the repo's conftest.py
(which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

K3 and K4 must be bit-identical to their plain versions; K1, K2, K5 and K6
within 1e-4 * max|plain| (fp32 sums in another order), K1, K2 and K6
bit-identical between two calls; the adjoints' gradients within 1e-4 * max|CPU| and the
2D branch's within 1e-3 of its largest CPU gradient (TF32 off).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import spconv as S
from mm2d3d_tpu_torch.ops.kernels import bandmm, bandmm_dw, head2d, maxpool, propagate, tapsum
from mm2d3d_tpu_torch.ops.voxelize import voxelize

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _taps(r, h, v, k, tap13=False, hole=0):
    """Ascending random taps per column with ~30% misses (k), duplicates
    among them; never the centre for 27-tap tables, unless `tap13` puts it
    in slot 0 of every third column.  The first `hole` columns are all
    misses."""
    t = np.sort(r.randint(0, k, size=(h, v)), axis=0)
    if k == 27:
        t[t == 13] = 14
    t[r.rand(h, v) < 0.3] = k
    if tap13 and h:
        t[0, ::3] = 13
    t[:, :hole] = k
    return t.astype(np.int32)


BANDMM = {
    # name: (V, H, K, Ci, Co, with_xm, tap options)
    "ragged_v_two_co_blocks": (1000, 4, 27, 16, 200, True, {}),
    "ci3_input_conv": (777, 3, 27, 3, 16, True, {}),
    "ci224_decoder_concat": (300, 5, 27, 224, 112, False, {}),
    "strided_k8": (513, 1, 8, 48, 64, False, {}),
    "centre_only": (130, 0, 27, 8, 24, True, {}),
    "empty": (0, 3, 27, 16, 16, True, {}),
    # the tensor-core kernel's tile and split edges
    "input_conv_adjoint_co3": (5000, 3, 27, 16, 3, True, {}),
    "up_conv_l5_to_l4": (8192, 1, 8, 96, 80, False, {}),
    "long_tile_ragged_v": (17001, 3, 27, 16, 16, True, {}),
    "heavy_h20_split": (2049, 20, 27, 16, 16, False, {}),
    "h26": (1000, 26, 27, 24, 40, False, {}),
    "tile_of_misses": (300, 3, 27, 16, 16, False, {"hole": 128}),
    "tap13_beside_centre": (700, 4, 27, 32, 16, True, {"tap13": True}),
    "split_dec_l5_concat": (4096, 8, 27, 192, 96, True, {}),
    "split_dec_l5_heavy": (1024, 18, 27, 192, 96, False, {}),
    "ci8_under_one_k_step": (650, 5, 27, 8, 16, True, {}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BANDMM))
def test_bandmm_matches_plain_version(dev, case, dtype):
    """Within 1e-4 * max|plain|, duplicate taps included, and the same bits
    from two calls (the band groups' partials are summed in a fixed
    order)."""
    v, h, k, ci, co, with_xm, opts = BANDMM[case]
    r = np.random.RandomState(v + h)

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    xm = t(r.randn(v, ci).astype(np.float32)) if with_xm else None
    x_src = t(r.randn(h, v, ci).astype(np.float32)) if h else None
    tap = t(_taps(r, h, v, k, **opts), torch.int32) if h else None
    w = t((r.randn(k, ci, co) * 0.1).astype(np.float32))
    if case.startswith("split") or case == "heavy_h20_split":
        assert bandmm.apply_plan(k, v, h, ci, co).splits > 1
    before = bandmm.KERNEL.launches
    out = bandmm.slot_conv_apply(xm, x_src, tap, w)
    assert bandmm.KERNEL.launches == before + 1
    again = bandmm.slot_conv_apply(xm, x_src, tap, w)
    ref = bandmm.slot_conv_apply_ref(xm, x_src, tap, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (v, co)
    assert torch.equal(out, again)
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


BANDMM_DW = {
    # name: (V, H, K, Ci, Co, with_xm, tap options)
    "ragged_v_tier1_centre": (1000, 4, 27, 16, 16, True, {}),
    "ci3_input_conv": (777, 3, 27, 3, 16, True, {}),
    "ci192_decoder_concat": (300, 8, 27, 192, 96, True, {}),
    "heavy_tier": (129, 20, 27, 24, 40, False, {}),
    "strided_k8": (513, 1, 8, 48, 112, False, {}),
    "centre_only": (130, 0, 27, 8, 24, True, {}),
    "empty": (0, 3, 27, 16, 16, True, {}),
    # the tensor-core kernel's tile and chunk edges
    "h26": (300, 26, 27, 16, 16, False, {}),
    "tile_of_misses": (300, 3, 27, 16, 16, False, {"hole": 160}),
    "tap13_beside_centre": (700, 4, 27, 32, 16, True, {"tap13": True}),
    "two_column_blocks_co200": (1000, 4, 27, 16, 200, True, {}),
    "ci8_nine_bands": (650, 5, 27, 8, 16, True, {}),
    "chunks_enc_l0_tier1": (65536, 3, 27, 16, 16, True, {}),
    "chunks_dec_l5_concat": (4096, 8, 27, 192, 96, True, {}),
    "up_conv_l5_to_l4": (8192, 1, 8, 96, 80, False, {}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BANDMM_DW))
def test_bandmm_dw_matches_plain_version_and_repeats(dev, case, dtype):
    v, h, k, ci, co, with_xm, opts = BANDMM_DW[case]
    r = np.random.RandomState(v + h + ci)

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    xm = t(r.randn(v, ci).astype(np.float32)) if with_xm else None
    x_src = t(r.randn(h, v, ci).astype(np.float32)) if h else None
    tap = t(_taps(r, h, v, k, **opts), torch.int32) if h else None
    g = t(r.randn(v, co).astype(np.float32))
    before = bandmm_dw.KERNEL.launches
    out = bandmm_dw.slot_conv_dw(xm, x_src, tap, g, k_taps=k)
    again = bandmm_dw.slot_conv_dw(xm, x_src, tap, g, k_taps=k)
    assert bandmm_dw.KERNEL.launches == before + 2
    ref = bandmm_dw.slot_conv_dw_ref(xm, x_src, tap, g, k_taps=k)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (k, ci, co)
    assert torch.equal(out, again)
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * max(float(ref.abs().max()), 1e-30), err


def _hierarchies(dev):
    """A 3-level hierarchy (3-tier L0, 2-tier L1, 3-tier L2) built on the
    card and on the CPU from the same points."""
    r = np.random.RandomState(11)
    n, fs = 2000, 64
    coords = torch.from_numpy(r.randint(0, fs, size=(n, 3)).astype(np.int32))
    batch = torch.from_numpy(np.repeat(np.arange(2, dtype=np.int32), n // 2))
    valid = torch.from_numpy(r.rand(n) < 0.95)
    caps = (2048, 1024, 512)
    slot_caps = ((3, 6, 26, 512, 128), (8, 26, 256), (4, 8, 26, 256, 256))
    out = []
    for d in (dev, torch.device("cpu")):
        grid = voxelize(coords.to(d), batch.to(d), valid.to(d), fs, capacity=caps[0])
        out.append(H.build_hierarchy(grid, 3, caps, slot_caps, num_batches=2))
    return out


CONV_FORMS = ["subm_3tier", "subm_2tier", "subm_1tier", "subm_dense", "down", "up"]
NO_SLOTS = dict(slot_src=None, slot_tap=None, slot_overflow=None, slot_idx=None,
                slot_src2=None, slot_tap2=None, slot_idxm=None, slot_invm=None,
                slot_srcm=None, slot_tapm=None)


@pytest.mark.parametrize("form", CONV_FORMS)
def test_conv_adjoints_on_card_match_cpu(dev, form):
    torch.backends.cuda.matmul.allow_tf32 = False
    hg, hc = _hierarchies(dev)
    r = np.random.RandomState(CONV_FORMS.index(form))
    cin, cout = 12, 20
    if form.startswith("subm"):
        l = 1 if form == "subm_2tier" else 0
        lg, lc = hg.levels[l], hc.levels[l]
        if form == "subm_1tier":
            drop = dict(slot_idx=None, slot_src2=None, slot_tap2=None, slot_idxm=None,
                        slot_invm=None, slot_srcm=None, slot_tapm=None)
            lg, lc = (dataclasses.replace(x, **drop) for x in (lg, lc))
        if form == "subm_dense":  # the dense 27-tap path: K6 both ways
            lg, lc = (dataclasses.replace(x, **NO_SLOTS) for x in (lg, lc))
        else:
            assert int(lc.slot_overflow) == 0
        rows_in = rows_out = lc.capacity
        fn = {dev.type: lambda x, w: S.subm_conv3(x, lg, w, torch.float32),
              "cpu": lambda x, w: S.subm_conv3(x, lc, w, torch.float32)}
        k = 27
    else:
        tg, tc = hg.transitions[0], hc.transitions[0]
        fine, coarse = hc.levels[0].capacity, hc.levels[1].capacity
        op = S.down_conv2 if form == "down" else S.up_conv2
        rows_in, rows_out = (fine, coarse) if form == "down" else (coarse, fine)
        fn = {dev.type: lambda x, w: op(x, tg, w, torch.float32),
              "cpu": lambda x, w: op(x, tc, w, torch.float32)}
        k = 8
    x = r.randn(rows_in, cin).astype(np.float32)
    w = (r.randn(k, cin, cout) * 0.1).astype(np.float32)
    cot = r.randn(rows_out, cout).astype(np.float32)
    grads = {}
    for d in (dev, torch.device("cpu")):
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        wt = torch.from_numpy(w).to(d).requires_grad_(True)
        # a column slice, as the decoder's concat hands the up conv its gradient
        wide = torch.from_numpy(np.concatenate([cot, cot], 1)).to(d)
        fn[d.type](xt, wt).backward(wide[:, :cout])
        grads[d.type] = (xt.grad.cpu(), wt.grad.cpu())
    for name, a, b in zip(("d_feats", "d_weight"), grads[dev.type], grads["cpu"]):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), (name, err)


def test_maxpool_backward_matches_max_pool2d(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.relu(torch.randn((2, 33, 47, 64), generator=g, device=dev))
    x = x.round(decimals=1)  # ties
    cot = torch.randn((2, 17, 24, 64), generator=g, device=dev)
    xa = x.clone().requires_grad_(True)
    maxpool.MaxPool3x3s2.apply(xa).backward(cot)
    xb = x.clone().requires_grad_(True)
    y = F.max_pool2d(xb.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    y.permute(0, 2, 3, 1).backward(cot)
    assert torch.equal(xa.grad, xb.grad)


def test_net2dseg_gradients_on_card_match_cpu(dev, monkeypatch):
    """The 2D branch in train mode at an image size that is cropped after
    padding (45 x 60), the same weights and batch on the card and the CPU,
    fp32 with TF32 off.  Every parameter gradient within 1e-3 of the
    branch's largest gradient, as tests/test_torch_models.py holds the CPU
    against flax (a deep leaf's own maximum is no scale: rounding tips
    ReLU and max-pool decisions)."""
    from mm2d3d_tpu_torch.data.synthetic import make_batch
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.train.batch import prepare_device_batch

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    batch = prepare_device_batch(make_batch(
        np.random.RandomState(0), batch_size=2, height=45, width=60, n_points=256,
        full_scale=256))
    grads = {}
    for d in (dev, torch.device("cpu")):
        task = flagship_task(compute_dtype=torch.float32, device=d, full_scale=256,
                             num_planes=3, m=8)
        task.init_params(torch.Generator().manual_seed(0))
        net = task.model2d.train()
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():  # 1-D leaves near 1, see test_torch_models.py
            for p in net.parameters():
                if p.dim() == 1:
                    p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
        for enc in (net.rgb_backbone, net.depth_backbone):
            enc.dropout_rate = 0.0
        b = batch.to(d)
        preds, _, aux = net(b.img, b.depth, b.img_indices, b.point_mask)
        r = np.random.RandomState(2)
        cot = [torch.from_numpy(r.randn(*t.shape).astype(np.float32)).to(d)
               for t in (preds["seg_logit"], aux["seg_logit_avg"])]
        ((preds["seg_logit"] * cot[0]).sum() + (aux["seg_logit_avg"] * cot[1]).sum()
         ).backward()
        grads[d.type] = {n: p.grad.cpu() for n, p in net.named_parameters()}
    scale = max(float(g.abs().max()) for g in grads["cpu"].values())
    for name, ref in grads["cpu"].items():
        err = float((grads[dev.type][name] - ref).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)


TAPSUM = {
    # name: (K, V, Ci, Co)
    "ragged_v_ci3_co12": (27, 1001, 3, 12),
    "ragged_v_two_co_blocks": (27, 777, 16, 40),
    "ci192_co96": (27, 300, 192, 96),
    "ci112_co112": (27, 129, 112, 112),
    "eight_taps": (8, 513, 48, 64),
    "empty": (27, 0, 16, 16),
    # tile edges of the tensor-core kernel (64 voxels, 16-channel k steps)
    "input_conv_adjoint_co3": (27, 1000, 16, 3),
    "ci8_under_one_k_step": (27, 650, 8, 16),
    "two_column_blocks_co192": (27, 500, 96, 192),
    # the 128-voxel tile (V long enough that its tiles alone fill the card)
    "long_tile_ragged_v": (27, 17000, 16, 16),
    "long_tile_co3": (27, 17001, 16, 3),
    "long_tile_ci48_co40": (27, 20000, 48, 40),
    # split-K shapes of the flagship's deep levels (L5 decoder concat, L6)
    "split_dec_l5_concat": (27, 4096, 192, 96),
    "split_enc_l6": (27, 2048, 112, 112),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(TAPSUM))
def test_tapsum_matches_plain_version(dev, case, dtype):
    """Within 1e-4 * max|plain|, and the same bits from two calls (the
    split-K partials are summed in a fixed order, with no atomics)."""
    k, v, ci, co = TAPSUM[case]
    if dtype == torch.bfloat16 and ci % 8 == 0 and v:
        bm = tapsum.tapsum_plan(k, v, ci, co).bm
        assert bm == (128 if case.startswith("long_tile") else 64), bm
    gen = torch.Generator(device=dev).manual_seed(v + ci)
    g = torch.randn((k, v, ci), generator=gen, device=dev).to(dtype)
    g[:, ::3] = 0  # the pad row's zeros, as a gather of missing taps gives
    w = (0.1 * torch.randn((k, ci, co), generator=gen, device=dev)).to(dtype)
    before = tapsum.KERNEL.launches
    out = tapsum.tapsum(g, w)
    assert tapsum.KERNEL.launches == before + 1
    again = tapsum.tapsum(g, w)
    ref = tapsum.tapsum_ref(g, w)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (v, co)
    assert torch.equal(out, again)
    if v:
        err = float((out - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


def test_tapsum_refuses_what_it_cannot_take(dev):
    g = torch.randn(27, 64, 16, device=dev)
    w = torch.randn(27, 16, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tapsum.tapsum(g.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(TypeError):
        tapsum.tapsum(g.bfloat16(), w)
    gb = torch.empty(27 * 64 * 16 + 1, dtype=torch.bfloat16, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        tapsum.tapsum(gb.view(27, 64, 16), w.bfloat16())
    with pytest.raises(ValueError, match="several devices"):
        tapsum.tapsum(g, w.cpu())


HEAD = {
    # name: (b, hp, wp, h_real, w_real, cins, c2); the first three are
    # tests/test_pallas.py's boundary shapes
    "odd_crop_both_dims": (1, 48, 32, 37, 25, (8, 16, 8), 8),
    "single_strip_no_crop": (2, 16, 16, 16, 16, (8,), 8),
    "just_past_one_strip": (1, 32, 24, 17, 24, (16, 8), 16),
    "flagship_crop_c2_12": (2, 240, 72, 225, 70, (64, 64, 64), 12),
    "c2_20_two_oc_blocks": (1, 32, 40, 30, 33, (24, 8, 16), 20),
    # one row and one column past the tensor-core pass's 16 x 32 tiles
    "crop_past_the_pixel_tile": (1, 48, 96, 33, 65, (16, 24), 12),
    "flagship_batch1": (1, 240, 400, 225, 400, (64, 64, 64), 12),
}


@pytest.mark.parametrize("dtypes", ["fp32", "bf16_inputs", "fp32_rounded"])
@pytest.mark.parametrize("case", sorted(HEAD))
def test_head_pool_matches_plain_version(dev, case, dtypes, monkeypatch):
    """fp32 pieces; bf16 pieces; fp32 pieces rounded to bf16 as they load
    (the flagship's form: its BatchNorms hand the head fp32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the plain conv
    b, hp, wp, h_real, w_real, cins, c2 = HEAD[case]
    gen = torch.Generator(device=dev).manual_seed(hp + wp + c2)
    xs = [0.5 * torch.randn((b, hp, wp, c), generator=gen, device=dev) for c in cins]
    w12 = 0.2 * torch.randn((3, 3, sum(cins), c2), generator=gen, device=dev)
    b12 = torch.randn((c2,), generator=gen, device=dev)
    cd = None
    if dtypes == "bf16_inputs":
        xs = [x.bfloat16() for x in xs]
    elif dtypes == "fp32_rounded":
        cd = torch.bfloat16
    before = head2d.KERNEL.launches
    out = head2d.head_pool(xs, w12, b12, h_real, w_real, cd)
    assert head2d.KERNEL.launches == before + 1
    ref = head2d.head_pool_ref(xs, w12, b12, h_real, w_real, cd)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (b, h_real, w_real, c2)
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()), err


def test_head_pool_reads_the_rows_below_the_crop(dev):
    """The conv's zero padding is at the padded map's edge: changing the
    first row under the crop moves the last real output row."""
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = [torch.randn((1, 32, 16, 8), generator=gen, device=dev)]
    w12 = torch.randn((3, 3, 8, 8), generator=gen, device=dev)
    b12 = torch.zeros(8, device=dev)
    a = head2d.head_pool(xs, w12, b12, 30, 16)
    xs[0][:, 30] += 1.0
    b = head2d.head_pool(xs, w12, b12, 30, 16)
    assert not torch.equal(a[:, 29], b[:, 29])
    assert torch.equal(a[:, :27], b[:, :27])


def test_head_pool_backward_on_card_matches_cpu(dev, monkeypatch):
    """HeadPool's backward on channels_last pieces (NHWC views of NCHW
    tensors, as `Net2DSeg(fused_head=True)` hands them), card vs CPU, fp32:
    the layout at which CUDA's avg_pool2d backward goes wrong."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    r = np.random.RandomState(4)
    b, hp, wp, h_real, w_real, cins, c2 = 2, 48, 40, 45, 37, (16, 16, 16), 12
    xs = [r.randn(b, c, hp, wp).astype(np.float32) for c in cins]
    w12 = (0.2 * r.randn(3, 3, sum(cins), c2)).astype(np.float32)
    b12 = r.randn(c2).astype(np.float32)
    cot = r.randn(b, h_real, w_real, c2).astype(np.float32)
    grads = {}
    for d in (dev, torch.device("cpu")):
        nchw = [torch.from_numpy(x).to(d).contiguous(memory_format=torch.channels_last)
                .requires_grad_(True) for x in xs]
        w = torch.from_numpy(w12).to(d).requires_grad_(True)
        bb = torch.from_numpy(b12).to(d).requires_grad_(True)
        pieces = [x.permute(0, 2, 3, 1) for x in nchw]
        assert all(p.is_contiguous() for p in pieces)
        head2d.HeadPool.apply(h_real, w_real, torch.float32, w, bb, *pieces).backward(
            torch.from_numpy(cot).to(d))
        grads[d.type] = [t.grad.cpu() for t in (w, bb, *nchw)]
    for name, a, ref in zip(("w12", "b12", "x0", "x1", "x2"), grads[dev.type],
                            grads["cpu"]):
        err = float((a - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), (name, err)
