"""K1's and K2's launch plans (`ops.kernels.bandmm.apply_plan`,
`ops.kernels.bandmm_dw.dw_plan`) over every K1 and K2 call of the
flagship's default train step: the submanifold convs (input conv, 7 encoder
and 6 decoder blocks, m = 16, 7 planes) in each slot tier of their level,
the strided down and up convs, and the adjoints (K1 with Ci and Co
swapped), at the voxel capacities and slot plans of a batch-8 topology
(`default_capacities`, `default_slot_caps`), bf16.

K1's plan must cover each band exactly once, give the card's 132 SMs a
block each wherever the voxels and channels allow, and size its scratch;
K2's must cover every row of dW and every voxel exactly once, fill the card
where the shape allows, and keep its band table within 16 KB.  CPU
emulations of the tensor-core kernels' arithmetic (the band-selected E of
each pass built from `band_sources`, the passes summed per band group or
voxel chunk, the groups or chunks summed in order) must equal the plain versions within 1e-5 *
max|plain| (fp32 sums in another order), duplicate taps and tap 13 beside
the centre included.  The wrappers' CUDA bookkeeping runs with the library
replaced by a recorder.  No JAX here: the plans are the port's own.
"""

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.ops.kernels import bandmm as B
from mm2d3d_tpu_torch.ops.kernels import bandmm_dw as D
from mm2d3d_tpu_torch.ops.kernels import tapsum as T
from mm2d3d_tpu_torch.ops.kernels.propagate import rank_slots
from mm2d3d_tpu_torch.train.batch import default_capacities, default_slot_caps

M, LEVELS, BATCH = 16, 7, 8
CAPS = default_capacities(BATCH * 8192, LEVELS, batch_size=BATCH)
SPECS = default_slot_caps(LEVELS, CAPS)


def _tiers(l):
    """(name, V, H) of level l's slot tiers: tier 1 (with the centre), the
    mid tier (3-tier levels) and the heavy tier."""
    v, spec = CAPS[l], SPECS[l]
    if len(spec) == 5:
        h1, h2, h_max, vm, vh = spec
        return [("tier1", v, h1), ("mid", min(vm, v), h2 - h1),
                ("heavy", min(vh, v), h_max - h2)]
    h_lo, h_max, vh = spec
    return [("tier1", v, h_lo), ("heavy", min(vh, v), h_max - h_lo)]


def _calls():
    """{name: (K, V, H, Ci, Co)} of the K1 and K2 calls of one train step."""
    k1, k2 = {}, {}
    subm = [("input_conv", 0, 3, M)]
    subm += [(f"enc_l{l}", l, M * (l + 1), M * (l + 1)) for l in range(LEVELS)]
    subm += [(f"dec_l{l}_concat", l, 2 * M * (l + 1), M * (l + 1))
             for l in range(LEVELS - 1)]
    for name, l, ci, co in subm:
        for tier, v, h in _tiers(l):
            k1[f"{name}_{tier}_fwd"] = (27, v, h, ci, co)
            k1[f"{name}_{tier}_adjoint"] = (27, v, h, co, ci)
            k2[f"{name}_{tier}"] = (27, v, h, ci, co)
    for l in range(LEVELS - 1):
        v, c, c1 = CAPS[l], M * (l + 1), M * (l + 2)
        k1[f"down_l{l}_fwd"] = (8, v, 1, c, c1)
        k1[f"down_l{l}_adjoint"] = (8, v, 1, c1, c)
        k1[f"up_l{l + 1}_fwd"] = (8, v, 1, c1, c)
        k1[f"up_l{l + 1}_adjoint"] = (8, v, 1, c, c1)
        k2[f"down_l{l}"] = (8, v, 1, c, c1)
        k2[f"up_l{l + 1}"] = (8, v, 1, c1, c)
    return k1, k2


K1_CALLS, K2_CALLS = _calls()


def test_the_flagship_step_has_these_calls():
    assert len(K1_CALLS) == 2 * (3 * (1 + 5 + 5) + 2 * (2 + 1)) + 4 * 6
    assert len(K2_CALLS) == len(K1_CALLS) // 2
    # the shapes the redesign is about
    assert K1_CALLS["enc_l0_tier1_fwd"] == (27, 65536, 3, 16, 16)
    assert K1_CALLS["enc_l0_heavy_fwd"] == (27, 2048, 20, 16, 16)
    assert K1_CALLS["dec_l5_concat_tier1_fwd"] == (27, 4096, 8, 192, 96)
    assert K1_CALLS["dec_l5_concat_heavy_fwd"] == (27, 1024, 18, 192, 96)
    assert K1_CALLS["input_conv_tier1_adjoint"] == (27, 65536, 3, 16, 3)
    assert K1_CALLS["up_l5_fwd"] == (8, 8192, 1, 96, 80)  # L5 -> L4


@pytest.mark.parametrize("case", sorted(K1_CALLS))
def test_k1_route(case):
    k, v, h, ci, co = K1_CALLS[case]
    assert B.slot_tensor_cores(torch.bfloat16, ci, h, k) == (ci != 3)
    assert not B.slot_tensor_cores(torch.float32, ci, h, k)


@pytest.mark.parametrize("case", sorted(K1_CALLS))
def test_k1_plan_covers_each_band_once_and_fills_the_card(case):
    k, v, h, ci, co = K1_CALLS[case]
    plan = B.apply_plan(k, v, h, ci, co)
    groups = T.tap_groups(k, plan.splits)
    assert [t for t0, t1 in groups for t in range(t0, t1)] == list(range(k))
    assert all(t1 > t0 for t0, t1 in groups)
    need = plan.splits * v * co if plan.splits > 1 else 0
    assert int(np.prod(T.scratch_shape(plan, v, co))) == need
    if not B.slot_tensor_cores(torch.bfloat16, ci, h, k):
        assert plan == (1, 16, 128)
        return
    assert plan.bm in (64, 128) and plan.bn % 16 == 0 and 16 <= plan.bn <= 128
    assert -(-co // plan.bn) * plan.bn >= co
    unsplit = -(-v // plan.bm) * -(-co // plan.bn)
    blocks = unsplit * plan.splits
    if unsplit * k >= T.SMS:
        assert blocks >= T.SMS
    if unsplit >= T.SMS:
        assert plan.splits == 1
    if case.startswith("enc_l0_tier1"):
        assert plan.splits == 1 and plan.bm == 128  # the main case: no scratch
    if case.startswith(("enc_l0_heavy", "dec_l5", "enc_l6")):
        assert plan.splits > 1  # the short tiles the split is for


@pytest.mark.parametrize("case", sorted(K2_CALLS))
def test_k2_plan_covers_rows_and_voxels_once_and_fills_the_card(case):
    k, v, h, ci, co = K2_CALLS[case]
    plan = D.dw_plan(k, v, h, ci, co)
    chunks = [(c * plan.rows, min(v, (c + 1) * plan.rows)) for c in range(plan.chunks)]
    assert [i for a, b in chunks for i in range(a, b)] == list(range(v))
    assert all(b > a for a, b in chunks)
    tc = B.slot_tensor_cores(torch.bfloat16, ci, h, k)
    shape = D.partial_shape(plan, k, ci, co, tc)
    assert shape == (None if tc and plan.chunks == 1 else (plan.chunks, k, ci, co))
    if not tc:
        assert plan.tile in (16, 32)
        return
    assert plan.tile == T.column_tile(co)
    m_tiles = -(-k * ci // D.TC_ROWS)
    rows = [r for t in range(m_tiles)
            for r in range(t * D.TC_ROWS, min(k * ci, (t + 1) * D.TC_ROWS))]
    assert rows == list(range(k * ci))
    # every 16-byte chunk of a block's columns lies in one band
    assert ci % 8 == 0
    for t in range(m_tiles):
        bands = {r // ci for r in rows[t * D.TC_ROWS:(t + 1) * D.TC_ROWS]}
        assert len(bands) <= D.max_bands(ci, k)
    assert plan.rows * D.max_bands(ci, k) <= D.SEL_BYTES
    tiles = m_tiles * -(-co // plan.tile)
    if tiles * (v // 128) >= T.SMS:  # the voxels allow it
        assert tiles * plan.chunks >= T.SMS
    assert plan.rows >= min(v, 128)


def test_k2_plans_at_known_shapes():
    assert D.dw_plan(27, 65536, 3, 16, 16) == (16, 863, 76)  # a small dW: ~528 blocks
    assert D.dw_plan(27, 65536, 3, 32, 16) == (16, 1725, 38)
    assert D.dw_plan(27, 4096, 8, 192, 96) == (96, 1024, 4)  # a large dW: ~264
    assert D.dw_plan(27, 2048, 20, 16, 16) == (16, 128, 16)
    # CUDA cores keep the old chunking: the input conv, and fp32
    assert D.dw_plan(27, 65536, 3, 3, 16) == (16, 125, 525)
    assert D.dw_plan(27, 4096, 8, 192, 96, torch.float32) == (32, 512, 8)
    assert D.dw_plan(27, 0, 3, 16, 16) == (16, 128, 0)
    # Ci = 8: nine bands per block bound the chunk by the 16 KB table
    assert D.dw_plan(27, 1 << 20, 2, 8, 16).rows == D.SEL_BYTES // 9


@pytest.mark.parametrize("target", [132, 264, 528])
def test_k2_plan_takes_the_tile_probes_target(target):
    """tools/slotconv_tiles.py aims the tensor-core plan at other block
    counts; the default targets are two of them."""
    for k, v, h, ci, co in ((27, 65536, 3, 16, 16), (27, 4096, 8, 192, 96)):
        plan = D.dw_plan(k, v, h, ci, co, target=target)
        tiles = -(-k * ci // D.TC_ROWS) * -(-co // plan.tile)
        assert plan.chunks == -(-v // plan.rows)
        assert tiles * plan.chunks >= target or plan.rows == D.TC_MIN_ROWS
    assert D.dw_plan(27, 65536, 3, 16, 16, target=528) == D.dw_plan(27, 65536, 3, 16, 16)
    assert D.dw_plan(27, 4096, 8, 192, 96, target=264) == D.dw_plan(27, 4096, 8, 192, 96)
    # CUDA cores keep their own target
    assert D.dw_plan(27, 65536, 3, 3, 16, target=target) == (16, 125, 525)


# ---------------------------------------------------------------------------
# CPU emulations of the tensor-core kernels' arithmetic
# ---------------------------------------------------------------------------

def _inputs(seed, v, h, k, ci, co, with_xm, dup=False, tap13=False, hole=0):
    """Random slot rows and taps: distinct ascending taps with ~30% misses
    (K) and never 13, as real tables; `dup` repeats each row's first tap in its
    next slot, `tap13` puts tap 13 in slot 0 of a third of the rows, `hole`
    makes the first `hole` rows all misses."""
    r = np.random.RandomState(seed)
    allowed = np.array([t for t in range(k) if k != 27 or t != 13])
    t = np.sort(allowed[np.argsort(r.rand(len(allowed), v), axis=0)[:h]], axis=0)
    t[r.rand(h, v) < 0.3] = k
    if dup and h > 1:
        t[1, ::2] = t[0, ::2]
    if tap13 and h:
        t[0, ::3] = 13
    t[:, :hole] = k
    xm = torch.from_numpy(r.randn(v, ci).astype(np.float32)) if with_xm else None
    xs = torch.from_numpy(r.randn(h, v, ci).astype(np.float32))
    w = torch.from_numpy((0.1 * r.randn(k, ci, co)).astype(np.float32))
    g = torch.from_numpy(r.randn(v, co).astype(np.float32))
    return xm, xs, torch.from_numpy(t.astype(np.int32)), w, g


def _band_matrices(xm, xs, tap, k):
    """E (V, K * Ci) of each pass, from the kernels' band selection."""
    h, v, ci = xs.shape
    sel = B.band_sources(tap, k, v, xm is not None)
    rows = torch.cat([xs, (xm if xm is not None else xs.new_zeros((v, ci)))[None],
                      xs.new_zeros((1, v, ci))])  # slot h, the centre (H), none (-1)
    cols = torch.arange(v)[None].expand(k, v)
    return [rows[s, cols].permute(1, 0, 2).reshape(v, k * ci) for s in sel]


EDGES = {
    # name: (K, V, H, Ci, Co, with_xm, dup, tap13, hole)
    "l0_tier1_centre": (27, 300, 3, 16, 16, True, False, False, 0),
    "heavy_h20": (27, 200, 20, 16, 16, False, False, False, 0),
    "h26": (27, 130, 26, 24, 40, False, False, False, 0),
    "duplicate_taps": (27, 257, 4, 16, 24, True, True, False, 0),
    "tap13_beside_centre": (27, 190, 3, 16, 16, True, False, True, 0),
    "duplicates_and_tap13": (27, 160, 6, 32, 8, True, True, True, 0),
    "rows_all_misses": (27, 200, 3, 16, 16, False, False, False, 128),
    "strided_k8": (8, 333, 1, 48, 64, False, False, False, 0),
    "input_conv_adjoint_co3": (27, 150, 3, 16, 3, True, False, False, 0),
    "ci8": (27, 140, 5, 8, 16, True, True, False, 0),
}


def _edge_and_flagship_cases():
    """(K, V, H, Ci, Co, with_xm, dup, tap13, hole, plan shape) per case:
    the edge cases at their own shape, and every tensor-core flagship
    call at 192 voxels with the plan of its real shape."""
    out = {f"edge_{n}": c + ((c[0], c[1], c[2], c[3], c[4]),) for n, c in EDGES.items()}
    for name, (k, v, h, ci, co) in K1_CALLS.items():
        if B.slot_tensor_cores(torch.bfloat16, ci, h, k) and name.endswith("fwd"):
            out[name] = (k, 192, h, ci, co, name.split("_")[-2] == "tier1" and k == 27,
                         False, False, 0, (k, v, h, ci, co))
    return out


EMULATED = _edge_and_flagship_cases()


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_k1_emulation_matches_plain_version(case):
    """out = sum over band groups s = 0, 1, ... of the group's partial, the
    sum over passes of E_pass[:, group] @ W[group]."""
    k, v, h, ci, co, with_xm, dup, tap13, hole, real = EMULATED[case]
    plan = B.apply_plan(*real)
    xm, xs, tap, w, _ = _inputs(v + h + ci, v, h, k, ci, co, with_xm, dup, tap13, hole)
    es = _band_matrices(xm, xs, tap, k)
    assert (len(es) > 1) == (dup or (tap13 and with_xm))
    wf = w.reshape(k * ci, co)
    out = torch.zeros((v, co))
    for t0, t1 in T.tap_groups(k, plan.splits):
        part = torch.zeros((v, co))
        for e in es:
            part += e[:, t0 * ci:t1 * ci] @ wf[t0 * ci:t1 * ci]
        out += part
    ref = B.slot_conv_apply_ref(xm, xs, tap, w)
    if hole:
        assert torch.equal(out[:hole], torch.zeros((hole, co)))
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_k2_emulation_matches_plain_version(case):
    """dW = sum over voxel chunks c = 0, 1, ... of the chunk's partial, the
    sum over passes of E_pass[chunk]^T @ g[chunk]."""
    k, v, h, ci, co, with_xm, dup, tap13, hole, real = EMULATED[case]
    plan = D.dw_plan(real[0], v, real[2], real[3], real[4])
    xm, xs, tap, _, g = _inputs(v + 2 * h + ci, v, h, k, ci, co, with_xm, dup, tap13,
                                hole)
    es = _band_matrices(xm, xs, tap, k)
    dw = torch.zeros((k * ci, co))
    for c in range(plan.chunks):
        a, b = c * plan.rows, min(v, (c + 1) * plan.rows)
        part = torch.zeros((k * ci, co))
        for e in es:
            part += e[a:b].T @ g[a:b]
        dw += part
    ref = D.slot_conv_dw_ref(xm, xs, tap, g, k)
    assert float((dw.reshape(k, ci, co) - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())


def test_real_tables_have_no_second_sources():
    """rank_slots' tables hold each tap once per row, ascending, never 13:
    the kernels take one pass over the tile on the main path."""
    r = np.random.RandomState(3)
    v = 500
    nbr = np.where(r.rand(26, v) < 0.4, r.randint(0, v, (26, v)), v).astype(np.int32)
    for h, h_from in ((3, 0), (3, 3), (20, 6)):
        _, tap, _ = rank_slots(torch.from_numpy(nbr), v, h, h_from)
        sel = B.band_sources(tap, 27, v, True)
        assert sel.shape == (1, 27, v)
        assert bool((sel[0, 13] == h).all())


# ---------------------------------------------------------------------------
# the wrappers' CUDA bookkeeping, with the library replaced by a recorder
# ---------------------------------------------------------------------------

def _record(monkeypatch, mod, fn_name):
    calls, shapes = [], []
    empty = torch.empty

    def spy_empty(shape, *a, **kw):
        shapes.append(tuple(shape))
        return empty(shape, *a, **kw)

    class Lib:
        pass

    def record(*args):
        calls.append(args)
        return 0

    lib = Lib()
    setattr(lib, fn_name, record)
    monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(mod, "stream", lambda: 0)
    monkeypatch.setattr(mod.KERNEL, "lib", lambda: lib)
    monkeypatch.setattr(torch, "empty", spy_empty)
    return calls, shapes, empty


@pytest.mark.parametrize("split", [False, True])
def test_k1_wrapper_passes_the_plan_and_allocates_its_scratch(monkeypatch, split):
    k, v, h, ci, co = (27, 4096, 8, 192, 96) if split else (27, 65536, 3, 16, 16)
    plan = B.apply_plan(k, v, h, ci, co)
    assert (plan.splits > 1) == split
    calls, shapes, empty = _record(monkeypatch, B, "slot_conv_apply")
    xm = empty((v, ci), dtype=torch.bfloat16)
    xs = empty((h, v, ci), dtype=torch.bfloat16)
    tap = torch.zeros((h, v), dtype=torch.int32)
    w = empty((k, ci, co), dtype=torch.bfloat16)
    before = B.KERNEL.launches
    out = B.slot_conv_apply(xm, xs, tap, w)
    assert B.KERNEL.launches == before + 1
    assert out.shape == (v, co) and out.dtype == torch.float32
    assert shapes == ([(v, co), (plan.splits, v, co)] if split else [(v, co)])
    (args,) = calls
    assert args[6:] == (v, h, ci, co, k, 1, *plan, 0)
    assert (args[5] is not None) == split


def test_k1_wrapper_takes_cuda_cores_for_fp32_and_ci3(monkeypatch):
    calls, shapes, empty = _record(monkeypatch, B, "slot_conv_apply")
    for dt, ci in ((torch.float32, 16), (torch.bfloat16, 3)):
        B.slot_conv_apply(empty((100, ci), dtype=dt), empty((3, 100, ci), dtype=dt),
                          torch.zeros((3, 100), dtype=torch.int32),
                          empty((27, ci, 16), dtype=dt))
    assert [c[11:15] for c in calls] == [(0, 1, 16, 128), (1, 1, 16, 128)]
    assert all(c[5] is None for c in calls)


def test_k1_wrapper_refuses_misaligned_rows_on_tensor_cores(monkeypatch):
    _, _, empty = _record(monkeypatch, B, "slot_conv_apply")
    flat = empty(3 * 64 * 16 + 1, dtype=torch.bfloat16)
    xs = flat[1:].view(3, 64, 16)
    with pytest.raises(ValueError, match="aligned"):
        B.slot_conv_apply(None, xs, torch.zeros((3, 64), dtype=torch.int32),
                          empty((27, 16, 16), dtype=torch.bfloat16))


@pytest.mark.parametrize("chunks", ["one", "many"])
def test_k2_wrapper_passes_the_plan_and_allocates_its_partials(monkeypatch, chunks):
    k, v, h, ci, co = (27, 128, 3, 16, 16) if chunks == "one" else (27, 65536, 3, 16, 16)
    plan = D.dw_plan(k, v, h, ci, co)
    assert (plan.chunks == 1) == (chunks == "one")
    calls, shapes, empty = _record(monkeypatch, D, "slot_conv_dw")
    xm = empty((v, ci), dtype=torch.bfloat16)
    xs = empty((h, v, ci), dtype=torch.bfloat16)
    tap = torch.zeros((h, v), dtype=torch.int32)
    g = empty((v, co), dtype=torch.bfloat16)
    before = D.KERNEL.launches
    out = D.slot_conv_dw(xm, xs, tap, g)
    assert D.KERNEL.launches == before + 1
    assert out.shape == (k, ci, co) and out.dtype == torch.float32
    assert shapes == ([(k, ci, co)] if chunks == "one"
                      else [(plan.chunks, k, ci, co), (k, ci, co)])
    (args,) = calls
    assert args[6:15] == (v, h, ci, co, k, *plan, 1)
    assert (args[4] is None) == (chunks == "one")


def test_k2_wrapper_keeps_the_cuda_core_limits_off_tensor_cores(monkeypatch):
    """H = 27 slots plus the centre exceeds the CUDA-core kernel's shared
    memory, not the tensor-core kernel's band table."""
    calls, _, empty = _record(monkeypatch, D, "slot_conv_dw")
    v, h = 64, 27
    tap = torch.zeros((h, v), dtype=torch.int32)
    D.slot_conv_dw(empty((v, 16), dtype=torch.bfloat16),
                   empty((h, v, 16), dtype=torch.bfloat16), tap,
                   empty((v, 16), dtype=torch.bfloat16))
    assert len(calls) == 1
    with pytest.raises(ValueError, match="limits"):
        D.slot_conv_dw(empty((v, 16)), empty((h, v, 16)), tap, empty((v, 16)))
