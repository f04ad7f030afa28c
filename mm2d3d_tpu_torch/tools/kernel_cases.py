"""What `chip_smoke.py` and the K1/K2 tools (`tools/slotconv_ab.py`,
`tools/slotconv_tiles.py`) share: the flagship batch, the device timer, and
K1's and K2's call forms at the flagship's shapes and at the tensor-core
kernels' edges.

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
SLEEP_CYCLES = 100_000_000  # ~50-300 ms of SM clock: longer than the queued calls' dispatch


def flagship_batch(seed: int, batch_size: int, device):
    """A synthetic batch at the flagship's shapes, from `seed`."""
    from mm2d3d_tpu_torch.data.synthetic import make_batch

    return make_batch(np.random.RandomState(seed), batch_size=batch_size,
                      **FLAGSHIP_BATCH).to(device)


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


def _hierarchy(dev):
    from mm2d3d_tpu_torch.train.batch import build_topology

    return build_topology(flagship_batch(0, BATCH, dev), 4096, 7)[1]


def k1_forms(dev, seed: int = 1):
    """(name, (xm, x_src, tap, w)) in fp32 for the K1 calls of the default
    path at level 0 (the input conv and its adjoint, Ci = 16 -> Co = 3; the
    encoder's three tiers; the decoder concat; the strided conv to L1) and
    at level 5 (the decoder concat in each tier, the strided conv to L6,
    the up conv to L4), from a batch-8 flagship topology."""
    hier = _hierarchy(dev)
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

    return (subm(0, 3, 16, "input conv Ci=3", False)
            + subm(0, 16, 3, "input conv adjoint 16->3", False)
            + subm(0, 16, 16, "enc L0", True)
            + subm(0, 32, 16, "dec L0 (concat)", False)
            + [strided(0, 16, 32)]
            + subm(5, 192, 96, "dec L5 (concat)", True)
            + [strided(5, 96, 112), strided(4, 96, 80, up=True)])


def k2_forms(dev, seed: int = 2):
    """(name, (xm, x_src, tap, g), K) in fp32 for the K2 calls of the train
    step at the same places: the mid and heavy tiers take the gradient at
    their compacted rows, as the adjoint does."""
    hier = _hierarchy(dev)
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

    return (subm(0, 3, 16, "input conv Ci=3", False)
            + subm(0, 16, 16, "enc L0", True)
            + subm(0, 32, 16, "dec L0 (concat)", False)
            + [strided(0, 16, 32)]
            + subm(5, 192, 96, "dec L5 (concat)", True)
            + [strided(5, 96, 112), strided(4, 96, 80, up=True)])


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
