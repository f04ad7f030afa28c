"""The hand-written CUDA kernels of mm2d3d_tpu_torch against their plain
PyTorch versions on the card, at edge shapes the flagship does not reach:
ragged voxel counts, more than 128 output channels, Ci = 3 and 224, odd
image sizes and crops, empty inputs, NaN, and the inputs the kernels
refuse, and the shapes the KITTI-family configs give K1, K2 (the dense
slot profile's level-0 tiers, MinkUNet34C's Ci 384 / Co 256 convs), K6
(MinkUNet34C's 5^3 stem) and K4 (their stem outputs); the 125-neighbour
table; the autograd Functions around them (the sparse-conv adjoints, the
dense form's, the 5^3 stem's and the strided convs' child-slot form (K = 8)
included, the stem pool's and the fused head's backward) on
the card against the same Functions on the CPU; the 2D branch's
train-mode gradients on the card against the CPU's; host-built
topologies copied to the card against the card's own build; and the
train-form BatchNorm kernels against their plain versions at the
flagship's and KITTI's BatchNorm shapes and at edges, with their launch
count per BatchNorm and per 2D train step, and in the masked form at the 3D
branches' level shapes (the SCN U-Net's C 16-192, MinkUNet34C's 32-384,
50-100% of the rows valid), where every row valid gives the 2D form's bits;
the sparse convolutions' slot
gather bit for bit against its plain version at the path's shapes (the 5^3
stem's 125-tap tables at C 3 and 32, a level-3 slot table at Ci 384, fp32,
channel slices, ids outside the rows), with MinkUNet34C's launches per
forward and backward (the slot gathers' and the masked BatchNorms').

Needs a CUDA device (and nvcc to build the kernels); skips without one.  On
a machine with a card and no JAX, run it without the repo's conftest.py
(which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

K3, K4 and the slot gather must be bit-identical to their plain versions; K1, K2, K5 and K6
within 1e-4 * max|plain| (fp32 sums in another order), K1, K2 and K6
bit-identical between two calls; the adjoints' gradients within 1e-4 * max|CPU| and the
2D branch's within 1e-3 of its largest CPU gradient (TF32 off); the
BatchNorm kernels' outputs within 1e-4 * max|plain| in fp32 and 2^-7 *
max|plain| in bf16 (one rounding step), and bit-identical between two calls.
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
    # the dense slot profile's L0 tiers, KITTI train step (16 x 10,240)
    "kitti_l0_tier1_centre": (163840, 3, 27, 16, 16, True, {}),
    "kitti_l0_mid": (76800, 5, 27, 16, 16, False, {}),
    "kitti_l0_heavy": (15360, 18, 27, 16, 16, False, {}),
    # MinkUNet34C's widest 3^3 convs: block5.0's conv1 (Ci 384, Co 256) at
    # level 3 of the KITTI train step, tier 1 with the centre and the mid tier
    "mink_l3_ci384_tier1_centre": (40960, 4, 27, 384, 256, True, {}),
    "mink_l3_ci384_mid": (19200, 4, 27, 384, 256, False, {}),
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
    # the stem outputs of the KITTI configs: 480x302 crops padded to
    # 480x304, and SemanticKITTI's 1241x376 eval frames padded to 1248x384
    "kitti_train_stem": (2, 152, 240, 64),
    "skitti_eval_stem": (1, 192, 624, 64),
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
    # the dense slot profile's L0 tiers, KITTI train step (16 x 10,240)
    "kitti_l0_tier1_centre": (163840, 3, 27, 16, 16, True, {}),
    "kitti_l0_mid": (76800, 5, 27, 16, 16, False, {}),
    "kitti_l0_heavy": (15360, 18, 27, 16, 16, False, {}),
    # MinkUNet34C's widest 3^3 convs (block5.0's conv1, level 3, KITTI)
    "mink_l3_ci384_tier1_centre": (40960, 4, 27, 384, 256, True, {}),
    "mink_l3_ci384_mid": (19200, 4, 27, 384, 256, False, {}),
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


def _hierarchies(dev, child_slot_caps=None):
    """A 3-level hierarchy (3-tier L0, 2-tier L1, 3-tier L2) built on the
    card and on the CPU from the same points (with child slots where
    `child_slot_caps` asks)."""
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
        out.append(H.build_hierarchy(grid, 3, caps, slot_caps, num_batches=2,
                                     child_slot_caps=child_slot_caps, stem_kernel=5))
    return out


def test_nbr5_on_card_equals_cpu(dev):
    hg, hc = _hierarchies(dev)
    assert torch.equal(hg.levels[0].nbr5.cpu(), hc.levels[0].nbr5)


CONV_FORMS = ["subm_3tier", "subm_2tier", "subm_1tier", "subm_dense", "down", "up",
              "down_slots", "up_slots", "subm5_dense"]
NO_SLOTS = dict(slot_src=None, slot_tap=None, slot_overflow=None, slot_idx=None,
                slot_src2=None, slot_tap2=None, slot_idxm=None, slot_invm=None,
                slot_srcm=None, slot_tapm=None)


@pytest.mark.parametrize("form", CONV_FORMS)
def test_conv_adjoints_on_card_match_cpu(dev, form):
    torch.backends.cuda.matmul.allow_tf32 = False
    hg, hc = _hierarchies(dev, "default" if form.endswith("_slots") else None)
    r = np.random.RandomState(CONV_FORMS.index(form))
    cin, cout = 12, 20
    if form == "subm5_dense":  # the 5^3 stem: K6 both ways over 125 taps
        lg, lc = hg.levels[0], hc.levels[0]
        rows_in = rows_out = lc.capacity
        fn = {dev.type: lambda x, w: S.subm_conv5(x, lg, w, torch.float32),
              "cpu": lambda x, w: S.subm_conv5(x, lc, w, torch.float32)}
        k = 125
    elif form.startswith("subm"):
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
        assert (tc.cslot_src is not None) == form.endswith("_slots")
        op = S.down_conv2 if form.startswith("down") else S.up_conv2
        rows_in, rows_out = (fine, coarse) if form.startswith("down") else (coarse, fine)
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
    # MinkUNet34C's 5^3 stem at level 0 of the KITTI train step: the
    # forward (Ci = 3, CUDA cores) and its input gradient (Ci 32 -> Co 3)
    "stem5_ci3_co32": (125, 163840, 3, 32),
    "long_tile_stem5_adjoint": (125, 163840, 32, 3),
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


def test_bf16_train_step_reproducible(dev):
    """Two default bf16 train steps from one saved state (optimizer moments
    included), with PyTorch's deterministic mode off, give the same bits in
    every weight, running statistic, moment, generator state and log: the
    step sums rows in a fixed order, with no float atomics."""
    from mm2d3d_tpu_torch.data.synthetic import make_batch
    from mm2d3d_tpu_torch.flagship import flagship_task
    from mm2d3d_tpu_torch.tools.train_repro import check_reproducible

    assert not torch.are_deterministic_algorithms_enabled()
    task = flagship_task(device=dev)
    task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    src, trg = (make_batch(np.random.RandomState(s), batch_size=2, height=225,
                           width=400, n_points=8192, wire=True).to(dev)
                for s in (4, 5))
    task.train_step(src, trg, gen)  # the optimizers hold moments from here on
    n, differ = check_reproducible(task, src, trg, gen)
    assert n > 1000 and not differ, differ[:10]


@pytest.mark.parametrize("profile", ["default", "dense"])
def test_host_topology_on_card_equals_the_cards_build(dev, profile):
    """`data.host_topology` built on the CPU and copied to the card
    (`to_device`: two packed copies) equals `build_topology` on the card,
    table by table, child slots included."""
    from mm2d3d_tpu_torch.data.host_topology import to_device, topology_for_batch
    from mm2d3d_tpu_torch.data.synthetic import make_batch
    from mm2d3d_tpu_torch.train.batch import build_topology

    batch = make_batch(np.random.RandomState(4), batch_size=2, height=32, width=48,
                       n_points=2048, full_scale=512)
    kw = dict(slot_profile=profile, child_slot_caps="default")
    host = to_device(topology_for_batch(batch, 512, 4, **kw), dev)
    card = build_topology(batch.to(dev), 512, 4, **kw)
    n = 0
    for a, b in [(host[0], card[0])] + list(zip(host[1].levels, card[1].levels)) + \
            list(zip(host[1].transitions, card[1].transitions)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (x is None) == (y is None), f.name
            if isinstance(x, torch.Tensor):
                assert x.device == y.device and torch.equal(x, y), f.name
                n += 1
    assert n > 50


# ---- the probe kernels K7-K10 (ops/kernels/exp_gather.py, exp_bandmm.py) ----

def _bf16_dev(r, dev, *shape):
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)


@pytest.mark.parametrize("group,tile", [(8, 512), (1, 4096), (2, 64)])
def test_group_gather_kernel_bit_equal(dev, group, tile):
    """K7 at the TPU's grain, per row and between, ids outside the groups
    included: bit-equal to the plain version; one launch per call."""
    from mm2d3d_tpu_torch.ops.kernels import exp_gather as G

    r = np.random.RandomState(group)
    x = _bf16_dev(r, dev, 8192, 128)
    ids = torch.from_numpy(r.randint(-2, 8192 // group + 2, (3, 2 * tile))
                           .astype(np.int32)).to(dev)
    before = G.GROUP_KERNEL.launches
    out = G.group_gather(x, ids, group, tile)
    assert G.GROUP_KERNEL.launches == before + 1
    assert torch.equal(out, G.group_gather_ref(x, ids, group, tile))
    with pytest.raises(ValueError):
        G.group_gather(x[:, :4].contiguous(), ids, 1, tile)  # 8-byte groups


@pytest.mark.parametrize("ci", [16, 32, 48])
@pytest.mark.parametrize("w", [1024, 2048])
def test_window_copy_kernel_bit_equal(dev, ci, w):
    """K8 at Ci 16, 32, 48: one copy per window, then windows split into
    20 KB chunks; windows outside x give zeros; a misaligned x raises."""
    from mm2d3d_tpu_torch.ops.kernels import exp_gather as G

    r = np.random.RandomState(ci + w)
    v = 24576
    x = _bf16_dev(r, dev, v, ci)
    offs = torch.from_numpy((r.randint(0, (v - w) // 8, 48) * 8).astype(np.int32))
    offs[:2] = torch.tensor([-8, v - w + 8])
    offs = offs.to(dev)
    ref = G.window_copy_ref(x, offs, w)
    assert torch.equal(G.window_copy(x, offs, w), ref)
    assert torch.equal(G.window_copy(x, offs, w, max_chunk_bytes=20_000), ref)
    with pytest.raises(ValueError, match="aligned"):
        G.window_copy(x.reshape(-1)[1:1 + (v - 1) * ci].reshape(v - 1, ci), offs, w)


@pytest.mark.parametrize("ci", [16, 32, 48])
@pytest.mark.parametrize("w", [1024, 2048])
def test_window_gather_kernel_bit_equal(dev, ci, w):
    """K9 at Ci 16, 32, 48, ids outside the window included: bit-equal; a
    window larger than a CTA's shared memory (multicast whole to each CTA
    of the cluster) raises."""
    from mm2d3d_tpu_torch.ops.kernels import exp_gather as G

    r = np.random.RandomState(ci * w)
    xw = _bf16_dev(r, dev, w, ci)
    idx = torch.from_numpy(r.randint(-2, w + 2, (4, 24576)).astype(np.int32)).to(dev)
    assert torch.equal(G.window_gather(xw, idx), G.window_gather_ref(xw, idx))
    with pytest.raises(ValueError, match="shared memory"):
        G.window_gather(_bf16_dev(r, dev, 4096, 48), idx)


@pytest.mark.parametrize("v", [65536, 65496, 1001, 64])
@pytest.mark.parametrize("centre", [True, False])
def test_band_apply_kernel_within_tolerance(dev, v, centre):
    """K10, both E builds and tiles: within 1e-4 * max|plain| and bit-stable
    over two calls, on real-table taps with the first two tiles all
    missing, and on the TPU probe's own recipe (duplicates, tap 13)."""
    from mm2d3d_tpu_torch.ops.kernels import exp_bandmm as B

    r = np.random.RandomState(v)
    xm = _bf16_dev(r, dev, 16, v) if centre else None
    x = _bf16_dev(r, dev, 3, 16, v)
    w = _bf16_dev(r, dev, 16, 27 * 16)
    real = B.real_table_taps(r, 3, v)
    real[:, :256] = 27
    probe = np.sort(r.randint(0, 27, size=(3, v)), axis=0).astype(np.int32)
    probe[r.rand(3, v) > 0.8] = 27
    for taps in (real, probe):
        tap = torch.from_numpy(taps).to(dev)
        ref = B.band_apply_ref(xm, x, tap, w)
        for e_build in B.E_BUILDS:
            for voxels in B.VOXELS_PER_BLOCK:
                out = B.band_apply(xm, x, tap, w, e_build, voxels)
                assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
                assert torch.equal(out, B.band_apply(xm, x, tap, w, e_build, voxels))


def test_band_apply_kernel_refuses(dev):
    from mm2d3d_tpu_torch.ops.kernels import exp_bandmm as B

    r = np.random.RandomState(0)
    x = _bf16_dev(r, dev, 3, 16, 256)
    tap = torch.from_numpy(B.real_table_taps(r, 3, 256)).to(dev)
    with pytest.raises(TypeError):
        B.band_apply(None, x.float(), tap, _bf16_dev(r, dev, 16, 432).float())
    with pytest.raises(ValueError):
        B.band_apply(None, x, tap, _bf16_dev(r, dev, 8, 432))  # Co % 16
    with pytest.raises(ValueError, match="shared memory"):
        B.band_apply(None, _bf16_dev(r, dev, 3, 64, 256), tap,
                     _bf16_dev(r, dev, 64, 27 * 64), "full", 128)


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("rows", [1, 7, 131 * 256 + 3, 100003])
def test_window_gather_kernel_rows_not_whole_clusters(dev, cluster, rows):
    """K9 whose rows do not divide into whole clusters' worth (the last
    CTAs' ranges short or empty, fewer rows than one cluster has CTAs):
    bit-equal, both cluster sizes; one launch per call."""
    from mm2d3d_tpu_torch.ops.kernels import exp_gather as G

    r = np.random.RandomState(rows)
    xw = _bf16_dev(r, dev, 1000, 48)
    idx = torch.from_numpy(r.randint(0, 1000, (rows,)).astype(np.int32)).to(dev)
    plan = G.window_gather_plan(rows, 1000, 96, cluster)
    assert plan["ctas"] % cluster == 0
    before = G.WINDOW_GATHER_KERNEL.launches
    out = G.window_gather(xw, idx, cluster)
    assert G.WINDOW_GATHER_KERNEL.launches == before + 1
    assert torch.equal(out, G.window_gather_ref(xw, idx))


@pytest.mark.parametrize("ci,w", [(16, 1024), (48, 2048)])
def test_window_gather_kernel_ids_outside_window(dev, ci, w):
    """K9: ids below 0, at w and at the int32 extremes give rows of zeros,
    the others their window rows, both cluster sizes."""
    from mm2d3d_tpu_torch.ops.kernels import exp_gather as G

    r = np.random.RandomState(ci + w)
    xw = _bf16_dev(r, dev, w, ci)
    ids = r.randint(0, w, (3, 4096)).astype(np.int32)
    ids[0, :5] = [-1, w, w + 7, 2**31 - 1, -2**31]
    ids[1, r.rand(4096) < 0.3] = -5
    idx = torch.from_numpy(ids).to(dev)
    for cluster in (2, 4):
        out = G.window_gather(xw, idx, cluster)
        assert torch.equal(out, G.window_gather_ref(xw, idx))
        assert not out[0, :5].any()


def _band_case(r, dev, v, h=3, ci=16, co=16, taps="real", centre=True):
    from mm2d3d_tpu_torch.ops.kernels import exp_bandmm as B

    xm = _bf16_dev(r, dev, ci, v) if centre else None
    x = _bf16_dev(r, dev, h, ci, v)
    w = _bf16_dev(r, dev, co, 27 * ci)
    if taps == "real":
        t = B.real_table_taps(r, h, v)
    else:  # the TPU probe's recipe, tools/exp_bandmm_variants.py:33-35
        t = np.sort(r.randint(0, 27, size=(h, v)), axis=0).astype(np.int32)
        t[r.rand(h, v) > 0.8] = 27
    return xm, x, torch.from_numpy(t).to(dev), w


def _band_holds(xm, x, tap, w):
    """Both E builds and tiles within 1e-4 * max|plain|, two calls bit-equal."""
    from mm2d3d_tpu_torch.ops.kernels import exp_bandmm as B

    ref = B.band_apply_ref(xm, x, tap, w)
    for e_build in B.E_BUILDS:
        for voxels in B.VOXELS_PER_BLOCK:
            out = B.band_apply(xm, x, tap, w, e_build, voxels)
            assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
            assert torch.equal(out, B.band_apply(xm, x, tap, w, e_build, voxels))


@pytest.mark.parametrize("case", ["more tiles than blocks", "less than one tile",
                                  "v not a multiple of 8", "tpu probe taps",
                                  "tpu probe taps, no centre"])
def test_band_apply_kernel_edges(dev, case):
    """K10's persistent grid and ring at their edges: V spanning more tiles
    than the grid has blocks (each block walks several, the last one
    ragged), V under one tile, V not a multiple of 8 (no tensor maps: the
    producer copies elements), and the TPU probe's own taps (duplicates and
    tap 13 beside the centre: the fp32 path)."""
    from mm2d3d_tpu_torch.ops.kernels import exp_bandmm as B

    r = np.random.RandomState(len(case))
    v = {"more tiles than blocks": 3 * 396 * 64 + 40, "less than one tile": 40,
         "v not a multiple of 8": 4093}.get(case, 8192)
    if case == "more tiles than blocks":
        plan = B.band_plan(v, 3, 16, 16, 27, 64)
        assert plan["tiles"] > 3 * plan["blocks"]
    taps = "probe" if case.startswith("tpu") else "real"
    xm, x, tap, w = _band_case(r, dev, v, taps=taps, centre=not case.endswith("no centre"))
    if taps == "probe":
        t = tap.cpu().numpy()
        hit = t < 27
        assert (t == 13).any() and (hit[1:] & (t[1:] == t[:-1])).any()
    _band_holds(xm, x, tap, w)


@pytest.mark.parametrize("h,ci,co,v", [(5, 16, 16, 3000), (2, 32, 16, 1500),
                                       (2, 16, 64, 1003), (0, 16, 16, 500)])
def test_band_apply_kernel_other_shapes(dev, h, ci, co, v):
    """K10 off the probe's shape (the kernel's general path): more slots
    than the probe's three, two 16-channel steps, four 16-row chunks of W,
    the centre alone."""
    r = np.random.RandomState(h * 1000 + v)
    _band_holds(*_band_case(r, dev, v, h, ci, co, taps="probe"))


# --------------------------------------------------------------------------
# the train-form BatchNorm kernels (ops/kernels/batchnorm2d.py)
# --------------------------------------------------------------------------

BN_EDGES = {
    # name: ((N, C, H, W) of the conv output, channel slice, epilogue, x, y dtypes)
    "ragged_rows": ((3, 64, 7, 11), (0, 64), "residual", torch.bfloat16, torch.float32),
    "one_pixel_per_image": ((5, 64, 1, 1), (0, 64), "relu", torch.bfloat16, torch.bfloat16),
    "c192_partial_tile": ((2, 192, 9, 13), (0, 192), "relu", torch.float32, torch.float32),
    "c8": ((4, 8, 5, 6), (0, 8), "none", torch.bfloat16, torch.float32),
    "slice_of_wider_rows": ((2, 128, 10, 12), (64, 128), "none", torch.float32, torch.float32),
    "rows_of_many_blocks": ((7, 256, 61, 67), (0, 256), "residual", torch.bfloat16,
                            torch.float32),
}


def _bn_case(name):
    from mm2d3d_tpu_torch.tools.kernel_cases import BN_CASES

    return BN_EDGES[name] if name in BN_EDGES else BN_CASES[name]


def _bn_case_names():
    from mm2d3d_tpu_torch.tools.kernel_cases import BN_CASES

    return sorted(BN_CASES) + sorted(BN_EDGES)


@pytest.mark.parametrize("name", _bn_case_names())
def test_batchnorm2d_matches_plain_version_and_repeats(dev, name):
    """Forward and backward at the flagship's and KITTI's BatchNorm shapes
    and at edges, against the plain versions on the card
    (`kernel_cases.bn_check`): each output within its tolerance, 1e-4 *
    max|plain| in fp32 (the sums in another order and finished in fp64, y
    by one fma) and 2^-7 * max|plain| in bf16 (one rounding step of values
    that differ before it), the running statistics within 1e-4; the ReLU
    bits as the plain mask wherever the pre-ReLU value lies beyond the
    rounding band; two calls bit-identical (no float atomics); four
    launches per BatchNorm."""
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.kernel_cases import bn_check, bn_inputs, bn_run

    case = _bn_case(name)
    epi, y_dtype = case[2], case[4]
    inputs = bn_inputs(case, dev, seed=11)
    kernels.reset_counts()
    bn_run(inputs, epi, y_dtype)
    torch.cuda.synchronize()
    assert kernels.counts()["batchnorm2d"] == 4
    errs = bn_check(inputs, epi, y_dtype)
    assert max(errs.values()) <= 1.0, errs


def test_batchnorm2d_constant_channel(dev):
    """A channel of one value: variance 0 (or a rounding below it, clipped),
    y = bias there, and the gradients finite and within tolerance of the
    plain version's."""
    from mm2d3d_tpu_torch.tools.kernel_cases import bn_check, bn_inputs, bn_run

    case = ((4, 64, 9, 10), (0, 64), "relu", torch.bfloat16, torch.float32)
    x, *rest = bn_inputs(case, dev, seed=12)
    x = x.clone(memory_format=torch.channels_last)
    x[:, 5] = 2.375
    inputs = (x, *rest)
    out = bn_run(inputs, "relu", torch.float32)
    assert all(torch.isfinite(v).all() for v in out.values() if v is not None)
    assert torch.equal(out["y"][:, 5], torch.relu(rest[1][5]).expand_as(out["y"][:, 5]))
    errs = bn_check(inputs, "relu", torch.float32)
    assert max(errs.values()) <= 1.0, errs


def test_batchnorm2d_refuses_what_it_cannot_take(dev):
    from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B

    w = torch.ones(64, device=dev)
    rm, rv = torch.zeros(64, device=dev), torch.ones(64, device=dev)
    nchw = torch.randn((2, 64, 5, 6), device=dev).to(torch.bfloat16)  # not NHWC
    with pytest.raises(ValueError, match="channels_last"):
        B.bn_stats(nchw, w, rm, rv, 1e-5, 0.9)
    nhwc = nchw.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels_last"):
        B.bn_stats(nhwc.transpose(2, 3), w, rm, rv, 1e-5, 0.9)
    with pytest.raises(ValueError, match="multiple of 8"):
        B.bn_stats(nhwc[:, :60], w[:60], rm[:60], rv[:60], 1e-5, 0.9)
    with pytest.raises(TypeError):
        B.bn_stats(nhwc.half(), w, rm, rv, 1e-5, 0.9)
    wide = torch.zeros((2, 72, 5, 6), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # 8 bytes past an alignment
        B.bn_stats(wide.contiguous(memory_format=torch.channels_last)[:, 4:68], w, rm,
                   rv, 1e-5, 0.9)
    stats = B.bn_stats(nhwc, w, rm, rv, 1e-5, 0.9)
    with pytest.raises(TypeError, match="output dtype"):
        B.bn_apply(nhwc.float(), stats, w, None, True, torch.float16)
    with pytest.raises(ValueError, match="identity"):
        B.bn_apply(nhwc, stats, w, nhwc, True, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        B.bn_stats(nhwc.float().requires_grad_(True), w, rm, rv, 1e-5, 0.9)


@pytest.mark.parametrize("frozen", [False, True])
def test_net2dseg_train_step_launches_batchnorm_kernels(dev, frozen):
    """Every train-mode BatchNorm2d of the 2D branch goes through the
    kernels: four launches each per forward and backward
    (`kernel_cases.expected_train_launches`), 79 BatchNorms, 43 with the RGB
    stem and encoder frozen; the eval forward launches none."""
    from mm2d3d_tpu_torch.models.net2d import Net2DSeg
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.kernel_cases import BN2D_FROZEN, BN2D_PER_FORWARD

    net = Net2DSeg(6, frozen_batch_norm=frozen).to(dev, memory_format=torch.channels_last)
    g = torch.Generator(device=dev).manual_seed(13)
    img = torch.rand((2, 45, 60, 3), generator=g, device=dev)
    depth = torch.rand((2, 45, 60, 1), generator=g, device=dev)
    idx = torch.zeros((2, 16, 2), dtype=torch.int32, device=dev)
    mask = torch.ones((2, 16), dtype=torch.bool, device=dev)
    kernels.reset_counts()
    net.train()
    preds, _, aux = net(img, depth, idx, mask, generator=g, with_features=False)
    (preds["seg_logit_2d"].square().mean() + aux["seg_logit_avg_2d"].mean()).backward()
    torch.cuda.synchronize()
    n_bn = BN2D_PER_FORWARD - (BN2D_FROZEN if frozen else 0)
    assert kernels.counts()["batchnorm2d"] == 4 * n_bn
    kernels.reset_counts()
    net.eval()
    with torch.no_grad():
        net(img, depth, idx, mask, with_features=False)
    assert kernels.counts()["batchnorm2d"] == 0


def _masked_bn_case_names():
    from mm2d3d_tpu_torch.tools.kernel_cases import MASKED_BN_CASES

    return sorted(MASKED_BN_CASES)


@pytest.mark.parametrize("name", _masked_bn_case_names())
def test_masked_batchnorm_matches_plain_version_and_repeats(dev, name):
    """The masked form at the 3D branches' level shapes, each epilogue and
    both output dtypes, against the eager masked form's plain versions on
    the card (`kernel_cases.bn_check`, tolerances as above): the statistics
    over the valid rows (counted on the card), the apply and the gradient's
    sums over every row; two calls bit-identical; four launches."""
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.kernel_cases import (
        MASKED_BN_CASES, bn_check, bn_run, masked_bn_inputs)

    case = MASKED_BN_CASES[name]
    epi, y_dtype, eps = case[2], case[3], case[4]
    inputs = masked_bn_inputs(case, dev, seed=11)
    kernels.reset_counts()
    bn_run(inputs, epi, y_dtype, eps)
    torch.cuda.synchronize()
    assert kernels.counts()["batchnorm2d"] == 4
    errs = bn_check(inputs, epi, y_dtype, eps)
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("epi", ["none", "relu", "residual"])
def test_masked_batchnorm_with_every_row_valid_is_the_2d_form(dev, epi):
    """Every row valid: n = M, the same sums in the same order, so the
    masked kernels give the 2D form's y, gradients and running statistics
    bit for bit on the same (M, C) rows; no valid row: n clamped to 1, the
    mean 0, y = x rstd weight + bias, finite gradients."""
    from mm2d3d_tpu_torch.tools.kernel_cases import bn_run, masked_bn_inputs

    case = ((20000, 96), 1.0, epi, torch.float32, 1e-5)
    *rest, valid = masked_bn_inputs(case, dev, seed=13)
    assert bool(valid.all())
    masked = bn_run((*rest, valid), epi, torch.float32, 1e-5)
    plain2d = bn_run((*rest, None), epi, torch.float32, 1e-5)
    for k, v in masked.items():
        assert (v is None) == (plain2d[k] is None), k
        if v is not None:
            assert torch.equal(v, plain2d[k]), k
    x, weight, bias, _, rm, rv, dy = rest
    out = bn_run((x, weight, bias, None, rm, rv, dy, torch.zeros_like(valid)), "none",
                 torch.float32, 1e-5)
    assert torch.allclose(out["running_mean"], 0.9 * rm)
    assert torch.allclose(out["y"], x * float(1e-5 ** -0.5) * weight + bias,
                          rtol=1e-5, atol=1e-3)
    assert all(torch.isfinite(v).all() for v in out.values() if v is not None)


def test_masked_batchnorm_refuses_a_bad_row_mask(dev):
    from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B

    x = torch.randn((100, 32), device=dev)
    w, rm, rv = (torch.ones(32, device=dev), torch.zeros(32, device=dev),
                 torch.ones(32, device=dev))
    for bad in (torch.ones(100, dtype=torch.uint8, device=dev),
                torch.ones(99, dtype=torch.bool, device=dev),
                torch.ones(200, dtype=torch.bool, device=dev)[::2]):
        with pytest.raises(ValueError, match="row mask"):
            B.bn_stats(x, w, rm, rv, 1e-5, 0.9, bad)
    with pytest.raises(ValueError, match="multiple of 8"):
        B.bn_stats(x[:, :12].contiguous(), w[:12], rm[:12], rv[:12], 1e-5, 0.9,
                   torch.ones(100, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# the sparse convolutions' slot-row gather (ops/kernels/slot_gather.py)
# ---------------------------------------------------------------------------

# (x rows, x channels, id table shape, share of ids at the pad, dtype) at the
# path's shapes: MinkUNet34C's 5^3 stem over the KITTI step's level 0 (16 x
# 10,240 rows; its forward gathers Ci 3, its input gradient Co 32; 93% of
# the ids are the pad), block5.0's tier-1 slot gather at level 3 (Ci 384),
# and an fp32 child gather (the down conv's K1 output, parity dtype)
SLOT_GATHER_CASES = {
    "stem_fwd_c3": (163840, 3, (125, 163840), 0.93, torch.bfloat16),
    "stem_grad_c32": (163840, 32, (125, 163840), 0.93, torch.bfloat16),
    "mink_l3_slots_ci384": (40960, 384, (4, 40960), 0.5, torch.bfloat16),
    "child_fp32_c64": (65536, 64, (16384, 8), 0.6, torch.float32),
}


def _gather_ids(r, v, shape, pad_share, dev):
    ids = r.randint(0, v, size=shape)
    ids[r.rand(*shape) < pad_share] = v
    flat = ids.reshape(-1)
    flat[:4] = (-1, v + 1, 2**31 - 1, v)  # outside the rows: zeros
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


@pytest.mark.parametrize("name", sorted(SLOT_GATHER_CASES))
def test_slot_gather_is_its_plain_version_bit_for_bit(dev, name):
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.ops.kernels.slot_gather import slot_gather, slot_gather_ref

    v, c, shape, pad, dtype = SLOT_GATHER_CASES[name]
    r = np.random.RandomState(23)
    x = torch.randn((v, c), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(dtype)
    ids = _gather_ids(r, v, shape, pad, dev)
    kernels.reset_counts()
    out = slot_gather(x, ids)
    again = slot_gather(x, ids)
    torch.cuda.synchronize()
    assert kernels.counts()["slot_gather"] == 2
    assert out.shape == (*shape, c) and out.dtype == dtype
    ref = slot_gather_ref(x, ids)
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
    assert torch.equal(out.view(torch.uint8), again.view(torch.uint8))


@pytest.mark.parametrize("first,width", [(32, 32), (3, 32), (1, 5), (64, 320)])
def test_slot_gather_reads_a_channel_slice_through_its_stride(dev, first, width):
    """Slices of a (V, 384) bf16 map: 16-byte chunks at channel 32, 2-byte
    ones at channel 3 or for 5 channels; no copy of the slice."""
    from mm2d3d_tpu_torch.ops.kernels.slot_gather import slot_gather, slot_gather_ref

    r = np.random.RandomState(29)
    wide = torch.randn((5000, 384), device=dev).to(torch.bfloat16)
    part = wide[:, first:first + width]
    ids = _gather_ids(r, 5000, (3, 4096), 0.4, dev)
    out = slot_gather(part, ids)
    assert torch.equal(out, slot_gather_ref(part.contiguous(), ids))
    assert torch.equal(out, slot_gather(part.contiguous(), ids))


def test_slot_gather_edges_and_refusals(dev):
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.ops.kernels.slot_gather import slot_gather, slot_gather_ref

    r = np.random.RandomState(31)
    for v, c, n in ((1, 8, 33), (37, 3, 1), (100, 1, 65), (0, 16, 40), (513, 7, 1000)):
        x = torch.randn((v, c), device=dev)
        ids = torch.from_numpy(r.randint(-2, v + 3, size=n).astype(np.int32)).to(dev)
        for t in (x, x.to(torch.bfloat16)):
            assert torch.equal(slot_gather(t, ids), slot_gather_ref(t, ids))
    kernels.reset_counts()
    empty = slot_gather(torch.randn((10, 16), device=dev),
                        torch.zeros((3, 0), dtype=torch.int32, device=dev))
    assert empty.shape == (3, 0, 16) and kernels.counts()["slot_gather"] == 0
    x = torch.randn((10, 16), device=dev)
    with pytest.raises(TypeError):
        slot_gather(x, torch.zeros(4, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        slot_gather(x, torch.zeros((4, 2), dtype=torch.int32, device=dev).t())
    with pytest.raises(ValueError):
        slot_gather(x.t(), torch.zeros(4, dtype=torch.int32, device=dev))


def test_minkunet_gathers_launch_as_kernel_cases_counts(dev):
    """MinkUNet34C's forward and backward on the card launch the slot gather
    as `kernel_cases.minkunet_gathers` counts and the BatchNorm kernels four
    times per train-form masked BatchNorm (`minkunet_batch_norms`, 62), and
    agree with the CPU's within the card-vs-CPU tolerance of
    `chip_smoke.py` (1e-3 of the largest, fp32: sums in another order over
    55 convolutions and 62 BatchNorms)."""
    from mm2d3d_tpu_torch.data.synthetic import make_batch
    from mm2d3d_tpu_torch.models.minkunet import MinkUNet34CSeg
    from mm2d3d_tpu_torch.ops import kernels
    from mm2d3d_tpu_torch.tools.kernel_cases import minkunet_batch_norms, minkunet_gathers
    from mm2d3d_tpu_torch.train.batch import build_topology, flatten_points
    from mm2d3d_tpu_torch.train.step import _init_

    b = make_batch(np.random.RandomState(2), batch_size=2, height=32, width=48,
                   n_points=2048, full_scale=256, variant="kitti")
    net = MinkUNet34CSeg(6, compute_dtype=torch.float32)
    with torch.no_grad():
        _init_(net, torch.Generator().manual_seed(1))
    outs = {}
    for d in ("cpu", dev):
        bd = b.to(d)
        grid, hier = build_topology(bd, 256, 5, capacities=(2560, 1536, 768, 384, 192),
                                    slot_profile="dense", stem_kernel=5)
        model = net.to(d)
        model.zero_grad()
        kernels.reset_counts()
        preds, _, _ = model(flatten_points(bd)[1], grid, hier)
        preds["seg_logit"].square().mean().backward()
        if d != "cpu":
            torch.cuda.synchronize()
            assert kernels.counts()["slot_gather"] == sum(minkunet_gathers(hier))
            assert kernels.counts()["batchnorm2d"] == 4 * minkunet_batch_norms()
        outs[str(d)] = (preds["seg_logit"].detach().to("cpu", copy=True),
                        model.net_3d.conv0p1s1.weight.grad.to("cpu", copy=True))
    (lc, gc), (lg, gg) = outs["cpu"], outs[str(dev)]
    assert float((lc - lg).abs().max()) <= 1e-3 * float(lc.abs().max())
    assert float((gc - gg).abs().max()) <= 1e-3 * float(gc.abs().max())
