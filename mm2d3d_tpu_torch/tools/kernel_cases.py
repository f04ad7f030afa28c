"""What `chip_smoke.py` and the kernel tools (`tools/slotconv_ab.py`,
`tools/slotconv_tiles.py`, the probe tools) share: the flagship batch, the
device timer, the kernel launches a hierarchy predicts (also for
`tools/ddp_check.py`; the slot gathers' per convolution and the
train-form BatchNorms per forward, for the SCN U-Net and MinkUNet34C), the
BatchNorm kernels' call forms and checks (2D, and masked at the 3D
branches' level shapes), K1's and K2's call forms at the flagship's shapes,
at the KITTI-family configs' level-0 tiers (the dense slot profile, batch
16 x 10,240 points), over the strided convs' child slots (K = 8, H = 3 and
5) and at the tensor-core kernels' edges, and K9's and K10's at the TPU
probes' sizes.

The imports of the package sit inside the functions and name it in full,
so that `tools/slotconv_ab.py` can load this file beside another checkout's
package and give both trees the same inputs.
"""

from __future__ import annotations

import functools
import statistics

import numpy as np
import torch

BATCH = 8
FLAGSHIP_BATCH = dict(height=225, width=400, n_points=8192, num_classes=6,
                      full_scale=4096)
# the KITTI-family configs' train step: 64-beam scans, batch 16 per domain,
# 480x302 crops, the dense slot profile
KITTI_BATCH = 16
KITTI_SCAN = dict(height=302, width=480, n_points=10240, num_classes=6,
                  full_scale=4096, variant="kitti")
# the probe kernels K7-K10 (`ops/kernels/exp_gather.py`, `exp_bandmm.py`):
# only the probe tools launch them, never a path of the system
PROBE_KERNELS = ("exp_group_gather", "exp_window_copy", "exp_window_gather",
                 "exp_bandmm")
# train-form BatchNorm2d of one Net2DSeg forward (`ops/kernels/batchnorm2d.py`,
# four launches each a train step): 36 per ResNet-34 encoder with its stem,
# 7 in the decoder; `frozen_batch_norm` freezes the RGB stem and encoder's 36
BN2D_PER_FORWARD = 79
BN2D_FROZEN = 36
SLEEP_CYCLES = 100_000_000  # ~50-300 ms of SM clock: longer than the queued calls' dispatch


def flagship_batch(seed: int, batch_size: int, device):
    """A synthetic batch at the flagship's shapes, from `seed`."""
    from mm2d3d_tpu_torch.data.synthetic import make_batch

    return make_batch(np.random.RandomState(seed), batch_size=batch_size,
                      **FLAGSHIP_BATCH).to(device)


def kitti_batch(seed: int, batch_size: int, device):
    """A synthetic batch of 64-beam scans at the KITTI configs' train
    shapes, from `seed`."""
    from mm2d3d_tpu_torch.data.synthetic import make_batch

    return make_batch(np.random.RandomState(seed), batch_size=batch_size,
                      **KITTI_SCAN).to(device)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of fn(), by CUDA events around `reps` calls,
    median of 3 samples.  The calls are queued behind a sleep kernel, so
    the host's dispatch between them is hidden and the events time the
    device's work alone (a call that synchronises still waits its turn)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def no_launches() -> dict:
    """Every registered kernel at zero launches: the base of each
    prediction, so a new kernel is predicted never to launch until a
    prediction says otherwise."""
    from mm2d3d_tpu_torch.ops.kernels import all_kernels

    return dict.fromkeys(all_kernels(), 0)


def tiers(level) -> int:
    """K1 launches of one submanifold conv at `level`: one a tier of its slot
    plan, none on the dense path."""
    return len(level.slot_tiers())


def _launched(*tables) -> int:
    """Slot-gather launches over these id tables: one each, none for an
    empty table."""
    return sum(t.numel() > 0 for t in tables)


def _apply_tables(plan) -> list:
    """The id tables `ops/spconv.py::_apply_tiers` gathers by over a slot
    plan: each tier's sources, and the inverse map of a tier merged by a
    gather."""
    return [t for tier in plan for t in (tier.src, tier.inv) if t is not None]


def _row_tables(plan) -> list:
    """The id tables `_dw_tiers` gathers the output gradient by: each
    compacted tier's rows."""
    return [tier.rows for tier in plan if tier.rows is not None]


def subm_gathers(level, mutate: bool = False) -> tuple:
    """(forward, backward) slot-gather launches of one submanifold 3^3 conv
    at `level`: the forward's and the input gradient's over its slot plan,
    the weight gradient's at the compacted tiers' rows (the dense form: the
    27-neighbour table once each way); `mutate`: the learning check's
    fault, a 3-tier backward without its mid and heavy tiers."""
    plan = level.slot_tiers()
    if not plan:
        return _launched(level.nbr), _launched(level.nbr)
    bwd = plan[:1] if mutate and len(plan) == 3 else plan
    return (_launched(*_apply_tables(plan)),
            _launched(*_apply_tables(bwd), *_row_tables(bwd)))


def down_gathers(trans) -> tuple:
    """(forward, backward) slot gathers of one stride-2 down conv: over the
    child slots (the input gradient by the parents), or the child table and
    the parents (input gradient and weight gradient) without them."""
    plan = trans.child_tiers()
    if plan:
        return (_launched(*_apply_tables(plan)),
                _launched(trans.parent, *_row_tables(plan)))
    return _launched(trans.child), _launched(trans.parent, trans.parent)


def up_gathers(trans) -> tuple:
    """(forward, backward) slot gathers of one stride-2 transposed conv."""
    plan = trans.child_tiers()
    if plan:
        return (_launched(trans.parent),
                _launched(*_apply_tables(plan), trans.parent))
    return _launched(trans.parent), _launched(trans.child, trans.parent)


def _sum_pairs(pairs) -> tuple:
    pairs = list(pairs)
    return sum(f for f, _ in pairs), sum(b for _, b in pairs)


def scn_gathers(hier, residual: bool = False, mutate: bool = False) -> tuple:
    """(forward, backward) slot gathers of the SCN U-Net (block_reps 1): the
    input conv, one block per level in the encoder and per level but the
    coarsest in the decoder (two convs a block with `residual`), one down
    and one up conv per transition."""
    lv = hier.levels
    convs = [lv[0]] + (2 if residual else 1) * (list(lv) + list(lv[:-1]))
    return _sum_pairs([subm_gathers(l, mutate) for l in convs]
                      + [down_gathers(t) for t in hier.transitions]
                      + [up_gathers(t) for t in hier.transitions])


def minkunet_gathers(hier) -> tuple:
    """(forward, backward) slot gathers of MinkUNet34C
    (`models/minkunet.py`): the 5^3 stem over level 0's 125-neighbour table,
    then per encoder stage a down conv and two convs per BasicBlock at the
    next level, per decoder stage an up conv and two convs per BasicBlock."""
    from mm2d3d_tpu_torch.models.minkunet import LAYERS

    lv, tr = hier.levels, hier.transitions
    pairs = [(_launched(lv[0].nbr5), _launched(lv[0].nbr5))]
    for i in range(4):
        pairs += [down_gathers(tr[i])] + [subm_gathers(lv[i + 1])] * 2 * LAYERS[i]
    for j in range(4):
        pairs += [up_gathers(tr[3 - j])] + [subm_gathers(lv[3 - j])] * 2 * LAYERS[4 + j]
    return _sum_pairs(pairs)


def _count_batch_norms(make) -> int:
    """Train-form MaskedBatchNorms of the 3D trunk `make()` builds, each
    called once a forward; built on the meta device, so no weight is
    allocated."""
    from mm2d3d_tpu_torch.models.sparse_unet import MaskedBatchNorm

    with torch.device("meta"):
        return sum(isinstance(m, MaskedBatchNorm) for m in make().modules())


@functools.lru_cache(maxsize=None)
def scn_batch_norms(num_planes: int, residual: bool = False) -> int:
    """Train-form masked BatchNorms of one SCN U-Net forward (block_reps 1):
    one a VGG block (two a residual block) in the encoder and decoder, one
    before each down and up conv, `out_bn`; 26 for the 7-plane VGG form,
    39 for the residual one."""
    from mm2d3d_tpu_torch.models.sparse_unet import UNetSCN3D

    return _count_batch_norms(lambda: UNetSCN3D(3, 16, 1, num_planes, torch.bfloat16,
                                                residual))


@functools.lru_cache(maxsize=None)
def minkunet_batch_norms() -> int:
    """Train-form masked BatchNorms of one MinkUNet34C forward: 62 (`bn0`,
    `bn1`-`bn4`, `bntr4`-`bntr7`, two a BasicBlock, one a widening
    shortcut)."""
    from mm2d3d_tpu_torch.models.minkunet import MinkUNet34C

    return _count_batch_norms(lambda: MinkUNet34C(3, torch.bfloat16))


def expected_launches(hier, residual: bool = False, fused_head: bool = False) -> dict:
    """Kernel launches of one forward, from the hierarchy: K3 at every level
    but the coarsest, K4 once per encoder, K5 once with `fused_head`; per
    submanifold conv (input conv, encoder and decoder blocks, two per block
    with `residual`) K1 once per tier of its level's slot plan, or K6 once
    on a level without one; K1 once per up conv, and per down conv once
    per tier of its child slots' plan or once without one; the slot gathers
    as `scn_gathers`; every other kernel never."""
    lv = hier.levels
    convs = [lv[0]] + (2 if residual else 1) * (list(lv) + list(lv[:-1]))
    return {**no_launches(), "propagate": len(lv) - 1, "maxpool": 2,
            "head2d": int(fused_head),
            "tapsum": sum(not l.slot_tiers() for l in convs),
            "bandmm": sum(tiers(l) for l in convs) + sum(
                (len(t.child_tiers()) or 1) + 1 for t in hier.transitions),
            "slot_gather": scn_gathers(hier, residual)[0]}


def expected_train_launches(hiers, residual: bool = False, host_built: bool = False,
                            frozen_bn: bool = False, fused_head: bool = False) -> dict:
    """Kernel launches of one train step, from the two domains' hierarchies:
    per domain, K1 and K6 twice per eval-forward launch (forward and input
    gradient), K2 once per eval-forward K1 launch (weight gradient; the
    dense convs' is a plain product), K3 per topology (none for topologies
    built on the host), K4 and K5 per encoder and head as in the forward
    (their backwards are PyTorch's), the BatchNorm kernels four times per
    train-form BatchNorm2d of the 2D forward (fewer with `frozen_bn`) and
    per masked BatchNorm of the 3D forward (`scn_batch_norms`), and the slot
    gathers of the forward and the backward (`scn_gathers`).  Over
    child slots the count holds too: the down conv's two K1 and two K2
    calls, the up conv's input gradient's two K1 calls."""
    from mm2d3d_tpu_torch.ops.kernels.batchnorm2d import LAUNCHES_PER_CALL

    out = no_launches()
    bn = LAUNCHES_PER_CALL * (BN2D_PER_FORWARD - (BN2D_FROZEN if frozen_bn else 0))
    for hier in hiers:
        ev = expected_launches(hier, residual, fused_head)
        out["bandmm"] += 2 * ev["bandmm"]
        out["bandmm_dw"] += ev["bandmm"]
        out["tapsum"] += 2 * ev["tapsum"]
        out["propagate"] += 0 if host_built else ev["propagate"]
        out["maxpool"] += ev["maxpool"]
        out["head2d"] += ev["head2d"]
        out["batchnorm2d"] += bn + LAUNCHES_PER_CALL * scn_batch_norms(len(hier.levels),
                                                                     residual)
        out["slot_gather"] += sum(scn_gathers(hier, residual))
    return out


def _tier_label(tier) -> str:
    return ("tier1+center" if tier.rows is None else "mid tier" if tier.inv is not None
            else "heavy tier")


def _hierarchy(dev, kitti: bool = False):
    from mm2d3d_tpu_torch.train.batch import build_topology

    if kitti:
        return build_topology(kitti_batch(0, KITTI_BATCH, dev), 4096, 7,
                              slot_profile="dense")[1]
    return build_topology(flagship_batch(0, BATCH, dev), 4096, 7)[1]


def k1_forms(dev, seed: int = 1, kitti: bool = False):
    """(name, (xm, x_src, tap, w)) in fp32 for the K1 calls of the default
    path at level 0 (the input conv and its adjoint, Ci = 16 -> Co = 3; the
    encoder's three tiers; the decoder concat; the strided conv to L1) and
    at level 5 (the decoder concat in each tier, the strided conv to L6,
    the up conv to L4), from a batch-8 flagship topology; with `kitti`,
    the encoder's three level-0 tiers of a batch-16 KITTI topology."""
    hier = _hierarchy(dev, kitti)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def subm(l, ci, co, name, every_tier):
        lev = hier.levels[l]
        v = lev.capacity
        x = torch.cat([rnd(v, ci), torch.zeros((1, ci), device=dev)])
        w = rnd(27, ci, co) * 0.1
        xm = torch.where(lev.valid[:, None], x[:v], 0)
        plan = lev.slot_tiers() if every_tier else lev.slot_tiers()[:1]
        return [(f"{name} {_tier_label(t)} H={t.src.shape[0]}",
                 (xm if t.rows is None else None, x[t.src.long()], t.tap, w))
                for t in plan]

    def strided(l, ci, co, up=False):
        off_id = hier.transitions[l].off_id
        name = (f"up L{l + 1}->L{l}" if up else f"down L{l}->L{l + 1}")
        return (f"{name} K=8 H=1 {ci}->{co}",
                (None, rnd(1, off_id.shape[0], ci), off_id[None].contiguous(),
                 rnd(8, ci, co) * 0.1))

    if kitti:
        return subm(0, 16, 16, "KITTI enc L0", True)
    return (subm(0, 3, 16, "input conv Ci=3", False)
            + subm(0, 16, 3, "input conv adjoint 16->3", False)
            + subm(0, 16, 16, "enc L0", True)
            + subm(0, 32, 16, "dec L0 (concat)", False)
            + [strided(0, 16, 32)]
            + subm(5, 192, 96, "dec L5 (concat)", True)
            + [strided(5, 96, 112), strided(4, 96, 80, up=True)])


def k2_forms(dev, seed: int = 2, kitti: bool = False):
    """(name, (xm, x_src, tap, g), K) in fp32 for the K2 calls of the train
    step at the same places: the mid and heavy tiers take the gradient at
    their compacted rows, as the adjoint does."""
    hier = _hierarchy(dev, kitti)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rows(x, idx):
        return torch.cat([x, x.new_zeros((1, x.shape[1]))])[idx.long()]

    def subm(l, ci, co, name, every_tier):
        lev = hier.levels[l]
        v = lev.capacity
        x = torch.cat([rnd(v, ci), torch.zeros((1, ci), device=dev)])
        g = rnd(v, co)
        xm = torch.where(lev.valid[:, None], x[:v], 0)
        plan = lev.slot_tiers() if every_tier else lev.slot_tiers()[:1]
        return [(f"{name} {_tier_label(t)} H={t.src.shape[0]}",
                 (xm if t.rows is None else None, x[t.src.long()], t.tap,
                  g if t.rows is None else rows(g, t.rows)), 27)
                for t in plan]

    def strided(l, ci, co, up=False):
        off_id = hier.transitions[l].off_id
        name = (f"up L{l + 1}->L{l}" if up else f"down L{l}->L{l + 1}")
        return (f"{name} K=8 H=1 {ci}->{co}",
                (None, rnd(1, off_id.shape[0], ci), off_id[None].contiguous(),
                 rnd(off_id.shape[0], co)), 8)

    if kitti:
        return subm(0, 16, 16, "KITTI enc L0", True)
    return (subm(0, 3, 16, "input conv Ci=3", False)
            + subm(0, 16, 16, "enc L0", True)
            + subm(0, 32, 16, "dec L0 (concat)", False)
            + [strided(0, 16, 32)]
            + subm(5, 192, 96, "dec L5 (concat)", True)
            + [strided(5, 96, 112), strided(4, 96, 80, up=True)])


def child_slot_forms(dev, seed: int = 3):
    """(name, (x_src, tap, w, g), K = 8) in fp32 for the strided convs' calls
    over child slots (`child_slot_caps="default"`) in a batch-8 flagship
    topology: the down conv L0 -> L1 and L5 -> L6 in tier 1 (H = 3, every
    coarse voxel) and in the heavy tier (H = 5, the compacted parents).  K1
    takes (x_src, tap, w), K2 (x_src, tap, g), g at the tier's rows as the
    weight gradient takes it."""
    from mm2d3d_tpu_torch.train.batch import build_topology

    hier = build_topology(flagship_batch(0, BATCH, dev), 4096, 7,
                          child_slot_caps="default")[1]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    forms = []
    for l, ci, co in ((0, 16, 32), (5, 96, 112)):
        t = hier.transitions[l]
        vf, vc = hier.levels[l].capacity, hier.levels[l + 1].capacity
        x = torch.cat([rnd(vf, ci), torch.zeros((1, ci), device=dev)])
        g = torch.cat([rnd(vc, co), torch.zeros((1, co), device=dev)])
        w = rnd(8, ci, co) * 0.1
        for label, tier in zip(("tier1", "heavy"), t.child_tiers()):
            gt = g[:vc] if tier.rows is None else g[tier.rows.long()]
            forms.append((f"child slots down L{l}->L{l + 1} {label} K=8 "
                          f"H={tier.src.shape[0]} {ci}->{co}",
                          (x[tier.src.long()], tier.tap, w, gt), 8))
    return forms


# name: (V, H, K, Ci, Co, with_xm, tap options)
EDGES = {
    "edge V=17001 long tile": (17001, 3, 27, 16, 16, True, {}),
    "edge V=1000 Co=200 two column blocks": (1000, 4, 27, 16, 200, True, {}),
    "edge V=2049 H=20 split": (2049, 20, 27, 16, 16, False, {}),
    "edge V=1000 H=26": (1000, 26, 27, 24, 40, False, {}),
    "edge V=300 a tile of misses": (300, 3, 27, 16, 16, False, {"hole": 160}),
    "edge V=700 duplicate taps, tap 13 beside xm": (700, 4, 27, 32, 16, True,
                                                    {"tap13": True, "dup": True}),
    "edge V=1024 H=18 Ci=192 split": (1024, 18, 27, 192, 96, False, {}),
}


def edge_forms(dev):
    """(name, (xm, x_src, tap, w, g), K) in fp32 at the tensor-core
    kernels' edges: ragged V, two column blocks, H = 20 and 26, a tile whose
    rows are all misses, duplicate taps and tap 13 beside the centre, and
    split shapes; numpy inputs from fixed seeds.  Taps are distinct and
    ascending per row, as real tables hold them, but in the duplicates'
    case."""
    out = []
    for name, (v, h, k, ci, co, with_xm, opts) in EDGES.items():
        r = np.random.RandomState(v + h + ci)
        allowed = np.array([t for t in range(k) if t != 13])
        t = np.sort(allowed[np.argsort(r.rand(len(allowed), v), axis=0)[:h]], axis=0)
        t[r.rand(h, v) < 0.3] = k
        if opts.get("dup"):
            t[1, ::2] = t[0, ::2]
        if opts.get("tap13"):
            t[0, ::3] = 13
        t[:, :opts.get("hole", 0)] = k

        def f(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)

        xm = f(r.randn(v, ci)) if with_xm else None
        out.append((name, (xm, f(r.randn(h, v, ci)),
                           torch.from_numpy(t.astype(np.int32)).to(dev),
                           f(0.1 * r.randn(k, ci, co)), f(r.randn(v, co))), k))
    return out


# the TPU probes' sizes: the gather probe's (H, V, Ci) cases and windows
# (`tools/exp_dma_gather.py`), the E-build probe's V, H, Ci, Co, K
# (`tools/exp_bandmm_variants.py`)
GATHER_CASES = ((3, 65536, 16), (4, 40960, 32), (4, 24576, 48))
GATHER_WINDOWS = (1024, 2048)
BAND_CASE = (65536, 3, 16, 16, 27)


def band_inputs(dev, seed: int = 0, v: int = BAND_CASE[0], taps: str = "real-table") -> tuple:
    """K10's inputs at the E-build probe's sizes: (xm (Ci, V), x (H, Ci, V),
    tap (H, V), w (Co, K * Ci)) on `dev`, bf16 but the int32 taps, from
    `seed`; taps "real-table" (`ops/kernels/exp_bandmm.py::real_table_taps`)
    or "flagship L0" (the level-0 tier-1 table of a batch-8 flagship
    topology, V its capacity)."""
    from mm2d3d_tpu_torch.ops.kernels.exp_bandmm import real_table_taps

    _, h, ci, co, k = BAND_CASE
    rng = np.random.RandomState(seed)
    if taps == "flagship L0":
        tap = _hierarchy(dev).levels[0].slot_tap.contiguous()
        v = tap.shape[1]
    else:
        tap = torch.from_numpy(real_table_taps(rng, h, v, k)).to(dev)

    def bf16(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    return bf16(ci, v), bf16(h, ci, v), tap, bf16(co, k * ci)


def probe_calls(dev):
    """(name, call) for K9 (`window_gather`) and K10 (`band_apply`) at the
    TPU probes' cases, each through its wrapper's default plan: K9 at the
    gather probe's three (H, V, Ci) cases and both windows, ids drawn in the
    window (seed 0); K10 with both E builds and both tiles over the
    real-table and flagship L0 taps (`band_inputs`)."""
    from mm2d3d_tpu_torch.ops.kernels.exp_bandmm import E_BUILDS, VOXELS_PER_BLOCK, band_apply
    from mm2d3d_tpu_torch.ops.kernels.exp_gather import window_gather

    calls = []
    rng = np.random.RandomState(0)
    for h, v, ci in GATHER_CASES:
        x = torch.from_numpy(rng.randn(v, ci).astype(np.float32)).to(dev, torch.bfloat16)
        for w in GATHER_WINDOWS:
            idx = torch.from_numpy(rng.randint(0, w, (h, v)).astype(np.int32)).to(dev)
            calls.append((f"K9 H={h} V={v} Ci={ci} w={w}",
                           lambda xw=x[:w], idx=idx: window_gather(xw, idx)))
    for taps in ("real-table", "flagship L0"):
        args = band_inputs(dev, taps=taps)
        for e_build in E_BUILDS:
            for voxels in VOXELS_PER_BLOCK:
                calls.append((f"K10 {taps} E={e_build} {voxels} voxels",
                              lambda e=e_build, n=voxels, a=args: band_apply(*a, e, n)))
    return calls


# The train-form BatchNorm's call forms: name -> (the conv output's shape
# (N, C, H, W), the channels this BatchNorm normalises, epilogue
# ("none", "relu", "residual": + identity and ReLU), x's dtype, y's dtype).
# The flagship's at its train batch, 16 per domain (240 x 400 padded
# images), and the KITTI configs' stem on 480 x 304 padded crops; a stem's
# x is one half of the fused stems' 128-channel output, read in place.
BN_TRAIN_BATCH = 16
BN_CASES = {
    "flagship stem rgb (16, 64, 240, 400) of 128": ((16, 128, 240, 400), (0, 64), "relu",
                                                    torch.bfloat16, torch.float32),
    "flagship stem depth (16, 64, 240, 400) of 128": ((16, 128, 240, 400), (64, 128),
                                                      "relu", torch.bfloat16, torch.float32),
    "flagship up2 (16, 64, 240, 400)": ((16, 64, 240, 400), (0, 64), "relu",
                                        torch.bfloat16, torch.float32),
    "flagship layer1 cb1 (16, 64, 120, 200)": ((16, 64, 120, 200), (0, 64), "relu",
                                               torch.bfloat16, torch.bfloat16),
    "flagship layer1 cb2 (16, 64, 120, 200)": ((16, 64, 120, 200), (0, 64), "residual",
                                               torch.bfloat16, torch.float32),
    "flagship layer4 downsample (16, 512, 15, 25)": ((16, 512, 15, 25), (0, 512), "none",
                                                     torch.bfloat16, torch.float32),
    "flagship layer4 cb2 (16, 512, 15, 25)": ((16, 512, 15, 25), (0, 512), "residual",
                                              torch.bfloat16, torch.float32),
    "flagship layer4 cb1 (16, 512, 15, 25)": ((16, 512, 15, 25), (0, 512), "relu",
                                              torch.bfloat16, torch.bfloat16),
    "KITTI stem rgb (16, 64, 304, 480) of 128": ((16, 128, 304, 480), (0, 64), "relu",
                                                 torch.bfloat16, torch.float32),
    "KITTI layer1 cb2 (16, 64, 152, 240)": ((16, 64, 152, 240), (0, 64), "residual",
                                            torch.bfloat16, torch.float32),
    "fp32 flagship layer1 cb2 (16, 64, 120, 200)": ((16, 64, 120, 200), (0, 64),
                                                    "residual", torch.float32,
                                                    torch.float32),
}


# The 3D branches' masked BatchNorm call forms: name -> ((V, C) of the level's
# rows, the share of valid rows, epilogue, y's dtype, eps); x is the fp32
# conv output, the rows the level's capacity in the KITTI train step
# (16 x 10,240 points, the dense profile: levels 0-4 163,840, 112,640,
# 71,680, 40,960, 20,480 rows) for MinkUNet34C (eps 1e-5) and in the
# flagship's (16 x 8,192: 131,072, 81,920, 49,152, 32,768, 16,384, 8,192,
# 4,096) for the SCN U-Net (eps 1e-4).  A y in bf16 is a BatchNorm whose
# only reader is a convolution.
MASKED_BN_CASES = {
    "mink L0 bn0 (163840, 32)": ((163840, 32), 0.7, "relu", torch.float32, 1e-5),
    "mink L0 block8 norm1 (163840, 96)": ((163840, 96), 0.7, "relu", torch.bfloat16, 1e-5),
    "mink L0 block8 norm2 (163840, 96)": ((163840, 96), 0.7, "residual", torch.float32,
                                          1e-5),
    "mink L0 block8 shortcut (163840, 96)": ((163840, 96), 0.7, "none", torch.float32,
                                             1e-5),
    "mink L3 block5 norm2 (40960, 256)": ((40960, 256), 0.85, "residual", torch.float32,
                                          1e-5),
    "mink L4 block4 norm1 (20480, 256)": ((20480, 256), 0.95, "relu", torch.bfloat16, 1e-5),
    "C 384 (40960, 384)": ((40960, 384), 0.5, "relu", torch.float32, 1e-5),
    "scn L0 enc (131072, 16)": ((131072, 16), 0.6, "relu", torch.bfloat16, 1e-4),
    "scn L0 out_bn (131072, 16)": ((131072, 16), 0.6, "relu", torch.float32, 1e-4),
    "scn L1 dec concat (81920, 64)": ((81920, 64), 0.75, "relu", torch.bfloat16, 1e-4),
    "scn L5 dec concat (8192, 192)": ((8192, 192), 0.9, "relu", torch.bfloat16, 1e-4),
    "scn L6 enc (4096, 112)": ((4096, 112), 1.0, "relu", torch.bfloat16, 1e-4),
}


def bn_inputs(case, dev, seed: int = 0):
    """The inputs of one BatchNorm call form (a `BN_CASES` value): x (a
    channels_last view, a channel slice for the stems), weight, bias,
    identity (fp32, or None), running mean and variance, the output
    gradient dy in y's dtype, and no row mask; channel means and scales
    spread as a conv's output spreads them."""
    shape, (lo, hi), epi, x_dtype, y_dtype = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, c_all, h, w = shape
    c = hi - lo

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev)

    base = (rnd(n, c_all, h, w) * (0.5 + rnd(1, c_all, 1, 1).abs()) + rnd(1, c_all, 1, 1))
    x = base.to(x_dtype).contiguous(memory_format=torch.channels_last)[:, lo:hi]
    del base
    ident = (rnd(n, c, h, w).contiguous(memory_format=torch.channels_last)
             if epi == "residual" else None)
    dy = rnd(n, c, h, w).to(y_dtype).contiguous(memory_format=torch.channels_last)
    return (x, 1 + 0.1 * rnd(c), 0.1 * rnd(c), ident, 0.1 * rnd(c), 1 + rnd(c).abs(), dy,
            None)


def masked_bn_inputs(case, dev, seed: int = 0):
    """`bn_inputs` of one masked call form (a `MASKED_BN_CASES` value): x
    (V, C) fp32, the row mask (its share of the rows valid, scattered), and
    at the invalid rows x and dy as they come (a conv writes 0 there, a
    gradient need not)."""
    (v, c), share, epi, y_dtype, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev)

    x = rnd(v, c) * (0.5 + rnd(c).abs()) + rnd(c)
    valid = torch.rand(v, generator=gen, device=dev) < share
    ident = rnd(v, c) if epi == "residual" else None
    return (x, 1 + 0.1 * rnd(c), 0.1 * rnd(c), ident, 0.1 * rnd(c), 1 + rnd(c).abs(),
            rnd(v, c).to(y_dtype), valid)


def _bn_stats_ref(x, valid, weight, rm, rv, eps):
    from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B

    return (B.stats_ref(x, weight, rm, rv, eps, 0.9) if valid is None
            else B.masked_stats_ref(x, valid, weight, rm, rv, eps, 0.9))


def bn_passes(inputs, epi: str, y_dtype, plain: bool = False, bits=None,
              eps: float = 1e-5) -> dict:
    """The four passes of one train-form BatchNorm, forward then backward,
    without autograd: the kernels' wrappers or, with `plain`, the plain
    versions, on the inputs' device; the plain backward takes the kernels'
    ReLU `bits` where given.  The running statistics of `inputs` move in
    place.  Returns y, dx, dweight, dbias, didentity (or None) and the mask."""
    from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B

    x, weight, bias, ident, rm, rv, dy, valid = inputs
    eager_w = None if valid is None else weight
    if plain:
        stats = _bn_stats_ref(x, valid, weight, rm, rv, eps)
        y, mask = B.apply_ref(x, stats, bias, ident, epi != "none", y_dtype, eager_w)
    else:
        stats = B.bn_stats(x, weight, rm, rv, eps, 0.9, valid)
        y, mask = B.bn_apply(x, stats, bias, ident, epi != "none", y_dtype, eager_w)
    used = mask if bits is None else B.unpack_mask(bits, x.shape)
    fns = ((B.grad_sums_ref, B.grad_apply_ref) if plain
           else (B.bn_grad_sums, B.bn_grad_apply))
    coef = fns[0](dy, x, used, stats, weight, valid)
    dx, did = fns[1](dy, x, used, stats, coef, ident is not None, valid)
    return {"y": y, "dx": dx, "dweight": coef[0], "dbias": coef[1], "didentity": did,
            "mask": mask}


def bn_run(inputs, epi: str, y_dtype, eps: float = 1e-5) -> dict:
    """One train-form BatchNorm, forward and backward, through
    `BatchNormTrain` and autograd, from fresh copies of the running
    statistics: `bn_passes`'s outputs but the mask, and the moved running
    statistics."""
    from mm2d3d_tpu_torch.ops.kernels.batchnorm2d import BatchNormTrain

    x, weight, bias, ident, rm, rv, dy, valid = inputs
    rm, rv = rm.clone(), rv.clone()
    xg = x.detach().requires_grad_(True)
    wg = weight.clone().requires_grad_(True)
    bg = bias.clone().requires_grad_(True)
    ig = None if ident is None else ident.clone().requires_grad_(True)
    y = BatchNormTrain.apply(xg, wg, bg, ig, rm, rv, epi != "none", y_dtype, eps, 0.9,
                             valid)
    y.backward(dy)
    return {"y": y.detach(), "dx": xg.grad, "dweight": wg.grad, "dbias": bg.grad,
            "didentity": None if ig is None else ig.grad, "running_mean": rm,
            "running_var": rv}


def bn_check(inputs, epi: str, y_dtype, eps: float = 1e-5) -> dict:
    """The kernels of one BatchNorm call form (2D, or masked where the
    inputs hold a row mask) against the plain versions on the same device.
    Raises unless two calls through `BatchNormTrain` give the same bits,
    the Function gives its four passes' bits, and the ReLU bits agree with
    the plain mask wherever the plain pre-ReLU value lies beyond 1e-4 * its
    max (nearer 0 the two roundings may tip it; the plain backward then
    takes the kernels' bits).  Returns each output's error as a share of its
    tolerance (`bn_errors`)."""
    from mm2d3d_tpu_torch.ops.kernels import batchnorm2d as B

    x, weight, bias, ident, rm, rv, dy, valid = inputs
    run, again = bn_run(inputs, epi, y_dtype, eps), bn_run(inputs, epi, y_dtype, eps)
    for k, v in run.items():
        if v is not None and not torch.equal(v, again[k]):
            raise AssertionError(f"two calls differ in {k}")
    fresh = lambda: (x, weight, bias, ident, rm.clone(), rv.clone(), dy, valid)  # noqa: E731
    out = bn_passes(fresh(), epi, y_dtype, eps=eps)
    for k, v in out.items():
        if k != "mask" and v is not None and not torch.equal(v, run[k]):
            raise AssertionError(f"BatchNormTrain and its passes differ in {k}")
    plain_in = fresh()
    ref = bn_passes(plain_in, epi, y_dtype, plain=True, bits=out["mask"], eps=eps)
    if epi != "none":
        stats = _bn_stats_ref(x, valid, weight, rm.clone(), rv.clone(), eps)
        pre = B.apply_ref(x, stats, bias, ident, False, torch.float32,
                          None if valid is None else weight)[0]
        flip = B.unpack_mask(out["mask"], x.shape) != ref["mask"]
        if bool((pre.abs() > 1e-4 * float(pre.abs().max()))[flip].any()):
            raise AssertionError("ReLU bits differ beyond the rounding band")
    ref = {**{k: v for k, v in ref.items() if k != "mask"},
           "running_mean": plain_in[4], "running_var": plain_in[5]}
    return bn_errors(run, ref)


def bn_bytes(case) -> int:
    """The bytes one BatchNorm call form moves, each once, forward and
    backward: x read twice in each direction, y and dx written, dy read
    twice, the ReLU bits written once and read twice, the identity read and
    its gradient written after a residual."""
    shape, (lo, hi), epi, x_dtype, y_dtype = case
    n = shape[0] * shape[2] * shape[3] * (hi - lo)
    xs, ys = torch.finfo(x_dtype).bits // 8, torch.finfo(y_dtype).bits // 8
    bits = n / 8 if epi != "none" else 0
    ident = 4 * n if epi == "residual" else 0
    fwd = 2 * n * xs + n * ys + bits + ident
    bwd = 2 * n * ys + 3 * n * xs + 2 * bits + ident
    return int(fwd + bwd)


def masked_bn_bytes(case) -> int:
    """`bn_bytes` of one masked call form (fp32 x): the statistics read x
    at the valid rows, the apply and the gradient's sums at every row, dx's
    apply at the valid rows (a g alone elsewhere); the row mask read by
    the statistics and by dx's apply."""
    (v, c), share, epi, y_dtype, _ = case
    n = v * c
    ys = torch.finfo(y_dtype).bits // 8
    bits = n / 8 if epi != "none" else 0
    ident = 4 * n if epi == "residual" else 0
    fwd = 4 * n * share + v + 4 * n + n * ys + bits + ident
    bwd = 2 * n * ys + 4 * n + 4 * n * share + v + 4 * n + 2 * bits + ident
    return int(fwd + bwd)


def bn_errors(out: dict, ref: dict) -> dict:
    """Each output's max|kernel - plain| over max|plain|, as a share of its
    tolerance: 1e-4 for fp32 outputs (the sums in another order, the
    statistics finished in fp64, y by one fma), 2^-7 for bf16 outputs (one
    bf16 rounding step of values that differ in fp32 before it)."""
    return {k: float((out[k].float() - r.float()).abs().max())
            / max(float(r.float().abs().max()), 1e-30)
            / (2.0 ** -7 if r.dtype == torch.bfloat16 else 1e-4)
            for k, r in ref.items() if r is not None}
