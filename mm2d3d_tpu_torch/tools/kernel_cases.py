"""What `chip_smoke.py` and the kernel tools (`tools/slotconv_ab.py`,
`tools/slotconv_tiles.py`, the probe tools) share: the flagship batch, the
device timer, the kernel launches a hierarchy predicts (also for
`tools/ddp_check.py`), K1's and K2's call forms at the flagship's shapes,
at the KITTI-family configs' level-0 tiers (the dense slot profile, batch
16 x 10,240 points), over the strided convs' child slots (K = 8, H = 3 and
5) and at the tensor-core kernels' edges, and K9's and K10's at the TPU
probes' sizes.

The imports of the package sit inside the functions and name it in full,
so that `tools/slotconv_ab.py` can load this file beside another checkout's
package and give both trees the same inputs.
"""

from __future__ import annotations

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


def tiers(level) -> int:
    return 3 if level.slot_srcm is not None else (2 if level.slot_src2 is not None else 1)


def expected_launches(hier, residual: bool = False) -> dict:
    """Kernel launches of one forward, from the hierarchy: K3 at every level
    but the coarsest, K4 once per encoder, K1 once per tier of every
    submanifold conv (input conv, encoder and decoder blocks, two per
    block with `residual`) plus once per strided conv, and once more for
    a down conv over child slots (its heavy tier); the probe kernels
    never."""
    lv = hier.levels
    n = len(lv)
    blocks = sum(tiers(l) for l in lv) + sum(tiers(l) for l in lv[:-1])
    k1 = tiers(lv[0]) + (2 if residual else 1) * blocks
    k1 += sum(3 if t.cslot_src is not None else 2 for t in hier.transitions)
    return {"propagate": n - 1, "maxpool": 2, "bandmm": k1, "bandmm_dw": 0,
            "head2d": 0, "tapsum": 0, **dict.fromkeys(PROBE_KERNELS, 0)}


def expected_train_launches(hiers, residual: bool = False,
                            host_built: bool = False) -> dict:
    """Kernel launches of one train step, from the two domains' hierarchies:
    per domain, K1 twice per eval-forward launch (forward and input
    gradient), K2 once per eval-forward K1 launch (weight gradient), K3 per
    topology (none for topologies built on the host) and K4 per encoder as
    in the forward (the pool's backward is PyTorch's).  Over child slots
    the count holds too: the down conv's two K1 and two K2 calls, the up
    conv's input gradient's two K1 calls."""
    out = {"bandmm": 0, "bandmm_dw": 0, "propagate": 0, "maxpool": 0, "head2d": 0,
           "tapsum": 0, **dict.fromkeys(PROBE_KERNELS, 0)}
    for hier in hiers:
        ev = expected_launches(hier, residual)
        out["bandmm"] += 2 * ev["bandmm"]
        out["bandmm_dw"] += ev["bandmm"]
        out["propagate"] += 0 if host_built else ev["propagate"]
        out["maxpool"] += ev["maxpool"]
    return out


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
        forms = [(f"{name} tier1+center H={lev.slot_src.shape[0]}",
                  (xm, x[lev.slot_src.long()], lev.slot_tap, w))]
        if every_tier and lev.slot_srcm is not None:
            forms.append((f"{name} mid tier H={lev.slot_srcm.shape[0]}",
                          (None, x[lev.slot_srcm.long()], lev.slot_tapm, w)))
        if every_tier and lev.slot_src2 is not None:
            forms.append((f"{name} heavy tier H={lev.slot_src2.shape[0]}",
                          (None, x[lev.slot_src2.long()], lev.slot_tap2, w)))
        return forms

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
        forms = [(f"{name} tier1+center H={lev.slot_src.shape[0]}",
                  (xm, x[lev.slot_src.long()], lev.slot_tap, g), 27)]
        if every_tier and lev.slot_srcm is not None:
            forms.append((f"{name} mid tier H={lev.slot_srcm.shape[0]}",
                          (None, x[lev.slot_srcm.long()], lev.slot_tapm,
                           rows(g, lev.slot_idxm)), 27))
        if every_tier and lev.slot_src2 is not None:
            forms.append((f"{name} heavy tier H={lev.slot_src2.shape[0]}",
                          (None, x[lev.slot_src2.long()], lev.slot_tap2,
                           rows(g, lev.slot_idx)), 27))
        return forms

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
        for tier, src, tap, rows in (("tier1", t.cslot_src, t.cslot_tap, None),
                                     ("heavy", t.cslot_src2, t.cslot_tap2, t.cslot_idx)):
            gt = g[:vc] if rows is None else g[rows.long()]
            forms.append((f"child slots down L{l}->L{l + 1} {tier} K=8 H={src.shape[0]} "
                          f"{ci}->{co}", (x[src.long()], tap, w, gt), 8))
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
