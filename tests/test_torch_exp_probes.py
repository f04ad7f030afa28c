"""The port's probe kernels K7-K10 (`mm2d3d_tpu_torch/ops/kernels/
exp_gather.py`, `exp_bandmm.py`) and probe tools against the JAX package's
TPU probes `tools/exp_dma_gather.py` and `tools/exp_bandmm_variants.py`.

The TPU kernels are closures inside those tools' `main()` and `main2()`,
so this file carries a copy of each body, word for word but for the size
constants T and V, with its file:line, and runs it with
`pl.pallas_call(..., interpret=True)` on the CPU at small sizes, on the
same seeded numpy inputs as the port's plain versions (the wrappers' CPU
route).  K7-K9 copy rows: exact equality.  K10 in fp32 within 1e-5 *
max|plain| (fp32 sums in another order), on taps drawn as real slot tables
hold them; on the TPU probe's own tap recipe the TPU variants compute
different functions, which the last K10 test shows.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mm2d3d_tpu_torch.ops import kernels
from mm2d3d_tpu_torch.ops.kernels import exp_bandmm as B
from mm2d3d_tpu_torch.ops.kernels import exp_gather as G
from mm2d3d_tpu_torch.tools import exp_bandmm_variants, exp_dma_gather, kernel_cases, slotconv_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 8  # the TPU probe's output tile (512 there)
K10_REL_TOL = 1e-5


def _bf16(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _as_bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- copies of the TPU kernels of tools/exp_dma_gather.py ----------------

def make_grp(ntile, h, ci):
    # tools/exp_dma_gather.py:85-123, with interpret=True
    def kern(idx_ref, x_ref, o_ref, sem):
        j = pl.program_id(0)

        def start_body(i, _):
            hh, tt = i // T, i % T
            src = pl.multiple_of(idx_ref[hh, j * T + tt] * 8, 8)
            dst = pl.multiple_of((hh * T + tt) * 8, 8)
            pltpu.make_async_copy(
                x_ref.at[pl.ds(src, 8), :],
                o_ref.at[pl.ds(dst, 8), :], sem).start()
            return 0

        jax.lax.fori_loop(0, h * T, start_body, 0)

        def wait_body(i, _):
            # same-shape copies signal equal byte counts on the sem
            pltpu.make_async_copy(
                x_ref.at[pl.ds(0, 8), :],
                o_ref.at[pl.ds(0, 8), :], sem).wait()
            return 0

        jax.lax.fori_loop(0, h * T, wait_body, 0)

    def run(x, idx):
        return pl.pallas_call(
            kern,
            grid_spec=pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=1, grid=(ntile,),
                in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
                out_specs=pl.BlockSpec((h * T * 8, ci),
                                       lambda i, s: (i, 0)),
                scratch_shapes=[pltpu.SemaphoreType.DMA(())]),
            out_shape=jax.ShapeDtypeStruct((ntile * h * T * 8, ci),
                                           x.dtype),
            compiler_params=pltpu.CompilerParams(has_side_effects=True),
            interpret=True,
        )(idx, x)

    return run


def make_win(n, w, ci):
    # tools/exp_dma_gather.py:126-147, with interpret=True
    def kern(off_ref, x_ref, o_ref, sem):
        j = pl.program_id(0)
        off = pl.multiple_of(off_ref[j], 8)
        d = pltpu.make_async_copy(
            x_ref.at[pl.ds(off, w), :], o_ref.at[0], sem)
        d.start()
        d.wait()

    def run(x, offs):
        return pl.pallas_call(
            kern,
            grid_spec=pltpu.PrefetchScalarGridSpec(
                num_scalar_prefetch=1, grid=(n,),
                in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
                out_specs=pl.BlockSpec((1, w, ci), lambda i, s: (i, 0, 0)),
                scratch_shapes=[pltpu.SemaphoreType.DMA(())]),
            out_shape=jax.ShapeDtypeStruct((n, w, ci), x.dtype),
            compiler_params=pltpu.CompilerParams(has_side_effects=True),
            interpret=True,
        )(offs, x)

    return run


def make_onehot(w, h):
    # tools/exp_dma_gather.py:150-178, with interpret=True
    def onehot_kernel(idx_ref, x_ref, o_ref):
        xw = x_ref[:]  # (w, ci) window in VMEM
        for hh in range(h):
            iota = jax.lax.broadcasted_iota(jnp.int32, (T, w), 1)
            oh = (iota == idx_ref[pl.ds(hh, 1)][0][:, None]).astype(xw.dtype)
            o_ref[hh] = jnp.dot(
                oh, xw, preferred_element_type=jnp.float32
            ).astype(o_ref.dtype)

    def onehot(x, idx):
        hh, v = idx.shape
        ci = x.shape[1]
        grid = v // T
        return pl.pallas_call(
            onehot_kernel,
            grid=grid,
            in_specs=[
                pl.BlockSpec((hh, T), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((w, ci), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((hh, T, ci), lambda i: (0, i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((hh, v, ci), x.dtype),
            interpret=True,
        )(idx, x)

    return onehot


# ---- copies of the TPU kernels of tools/exp_bandmm_variants.py -----------

def tpu_band_kernels(H, CI, K):
    """The E-build variants' bodies, closed over the probe's constants as in
    `main()` and `main2()` (H, CI, K; CENTER = 13)."""
    CENTER = 13

    # tools/exp_bandmm_variants.py:70-89
    def kern_a(xm_ref, x_ref, tap_ref, w_ref, o_ref):
        t = x_ref.shape[2]
        zero = jnp.zeros((CI, t), x_ref.dtype)
        bands = []
        for k in range(K):
            if k == CENTER:
                bands.append(xm_ref[:])
                continue
            acc = None
            for hh in range(H):
                if k < hh:
                    continue
                tap_h = tap_ref[pl.ds(hh, 1)][0]
                x_h = x_ref[pl.ds(hh, 1)][0]
                sel = jnp.where(tap_h[None, :] == k, x_h, zero)
                acc = sel if acc is None else acc + sel
            bands.append(zero if acc is None else acc)
        e = jnp.concatenate(bands, axis=0)
        o_ref[:] = jnp.dot(w_ref[:], e, preferred_element_type=jnp.float32)

    # tools/exp_bandmm_variants.py:91-110
    def kern_b(xm_ref, x_ref, tap_ref, w_ref, o_ref):
        t = x_ref.shape[2]
        zero = jnp.zeros((CI, t), x_ref.dtype)
        xs = [x_ref[pl.ds(hh, 1)][0] for hh in range(H)]
        ts = [tap_ref[pl.ds(hh, 1)][0] for hh in range(H)]
        bands = []
        for k in range(K):
            if k == CENTER:
                bands.append(xm_ref[:])
                continue
            acc = None
            for hh in range(H):
                if k < hh:
                    continue
                sel = jnp.where(ts[hh][None, :] == k, xs[hh], zero)
                acc = sel if acc is None else acc + sel
            bands.append(zero if acc is None else acc)
        e = jnp.concatenate(bands, axis=0)
        o_ref[:] = jnp.dot(w_ref[:], e, preferred_element_type=jnp.float32)

    # tools/exp_bandmm_variants.py:112-132 (and mk_c's kernel, :189-210)
    def kern_c(xm_ref, x_ref, tap_ref, w_ref, o_ref):
        t = x_ref.shape[2]
        zero = jnp.zeros((CI, t), x_ref.dtype)
        xs = [x_ref[pl.ds(hh, 1)][0] for hh in range(H)]
        ts = [tap_ref[pl.ds(hh, 1)][0] for hh in range(H)]
        bands = []
        for k in range(K):
            if k == CENTER:
                bands.append(xm_ref[:])
                continue
            acc = None
            for hh in range(H):
                if k < hh:
                    continue
                m = (ts[hh][None, :] == k).astype(x_ref.dtype)
                sel = xs[hh] * m
                acc = sel if acc is None else acc + sel
            bands.append(zero if acc is None else acc)
        e = jnp.concatenate(bands, axis=0)
        o_ref[:] = jnp.dot(w_ref[:], e, preferred_element_type=jnp.float32)

    # tools/exp_bandmm_variants.py:134-157
    def kern_d(xm_ref, x_ref, tap_ref, w_ref, o_ref):
        t = x_ref.shape[2]
        zero = jnp.zeros((CI, t), x_ref.dtype)
        kio = jax.lax.broadcasted_iota(jnp.int32, (K, t), 0)
        ohs = [
            (kio == tap_ref[pl.ds(hh, 1)][0][None, :]).astype(x_ref.dtype)
            for hh in range(H)
        ]
        xs = [x_ref[pl.ds(hh, 1)][0] for hh in range(H)]
        bands = []
        for k in range(K):
            if k == CENTER:
                bands.append(xm_ref[:])
                continue
            acc = None
            for hh in range(H):
                if k < hh:
                    continue
                sel = xs[hh] * ohs[hh][pl.ds(k, 1) if False else k][None, :]
                acc = sel if acc is None else acc + sel
            bands.append(zero if acc is None else acc)
        e = jnp.concatenate(bands, axis=0)
        o_ref[:] = jnp.dot(w_ref[:], e, preferred_element_type=jnp.float32)

    # tools/exp_bandmm_variants.py:212-242
    def mk_pair(tile):
        # 2-band pairing: mask on tap>>1, pre-split slots into even/odd taps
        def kern(xm_ref, x_ref, tap_ref, w_ref, o_ref):
            t = x_ref.shape[2]
            zero = jnp.zeros((CI, t), x_ref.dtype)
            xs = [x_ref[pl.ds(hh, 1)][0] for hh in range(H)]
            ts = [tap_ref[pl.ds(hh, 1)][0] for hh in range(H)]
            xe, xo, th = [], [], []
            for hh in range(H):
                pe = (jnp.bitwise_and(ts[hh], 1)[None, :] == 0).astype(x_ref.dtype)
                xe.append(xs[hh] * pe)
                xo.append(xs[hh] - xs[hh] * pe)
                th.append(jnp.right_shift(ts[hh], 1))
            bands = [None] * K
            for j in range((K + 1) // 2):
                acce = accо = None
                for hh in range(H):
                    if 2 * j + 1 < hh:
                        continue
                    m = (th[hh][None, :] == j).astype(x_ref.dtype)
                    se = xe[hh] * m
                    so = xo[hh] * m
                    acce = se if acce is None else acce + se
                    accо = so if accо is None else accо + so
                bands[2 * j] = zero if acce is None else acce
                if 2 * j + 1 < K:
                    bands[2 * j + 1] = zero if accо is None else accо
            bands[CENTER] = xm_ref[:] + bands[CENTER]
            e = jnp.concatenate(bands, axis=0)
            o_ref[:] = jnp.dot(w_ref[:], e, preferred_element_type=jnp.float32)
        return kern

    return {"a": kern_a, "b": kern_b, "c": kern_c, "d": kern_d, "pair": mk_pair(0)}


def run_band_kernel(body, xm, x, tap, w, tile):
    # the pallas_call of tools/exp_bandmm_variants.py:39-51 and :244-256,
    # with interpret=True
    H, CI, V = x.shape
    CO, KCI = w.shape
    f = pl.pallas_call(
        body,
        grid=(V // tile,),
        in_specs=[
            pl.BlockSpec((CI, tile), lambda i: (0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec((H, CI, tile), lambda i: (0, 0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec((H, tile), lambda i: (0, i), memory_space=pltpu.VMEM),
            pl.BlockSpec((CO, KCI), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((CO, tile), lambda i: (0, i), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((CO, V), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(xm, x, tap, w))


# ---- K7 ------------------------------------------------------------------

@pytest.mark.parametrize("ntile,h,ci", [(1, 1, 128), (2, 2, 128), (3, 2, 16)])
def test_group_gather_matches_tpu_kernel(ntile, h, ci):
    """K7's plain version (G = 8, tile T) against `make_grp`'s body in
    interpret mode: the same rows, bit for bit."""
    r = np.random.RandomState(ntile * 10 + h)
    xj, xt = _as_bf16(_bf16(r, 48, ci))
    idx = r.randint(0, 6, (h, T * ntile)).astype(np.int32)
    tpu = make_grp(ntile, h, ci)(xj, jnp.asarray(idx))
    port = G.group_gather(xt, torch.from_numpy(idx), 8, T)
    np.testing.assert_array_equal(port.float().numpy(), _np(tpu))
    assert port.shape == (ntile * h * T * 8, ci)


@pytest.mark.parametrize("group", [1, 2, 8])
def test_group_gather_rows_and_misses(group):
    """Any G: out[((j H + h) T + t) G + r] = x[idx[h, j T + t] G + r],
    zeros for an id outside the groups (numpy rule)."""
    r = np.random.RandomState(group)
    x = _bf16(r, 40, 8)
    n_groups, h, tile = 40 // group, 3, 4
    idx = r.randint(-2, n_groups + 2, (h, 3 * tile)).astype(np.int32)
    want = []
    for j in range(3):
        for hh in range(h):
            for t in range(tile):
                g = idx[hh, j * tile + t]
                ok = 0 <= g < n_groups
                want.append(x[g * group:(g + 1) * group] if ok else np.zeros((group, 8)))
    out = G.group_gather(torch.from_numpy(x), torch.from_numpy(idx), group, tile)
    np.testing.assert_array_equal(out.numpy(), np.concatenate(want).astype(np.float32))


# ---- K8 ------------------------------------------------------------------

@pytest.mark.parametrize("n,w,ci", [(3, 16, 16), (4, 8, 48), (1, 24, 32)])
def test_window_copy_matches_tpu_kernel(n, w, ci):
    """K8's plain version against `make_win`'s body: bit for bit."""
    r = np.random.RandomState(n + w)
    v = 64
    xj, xt = _as_bf16(_bf16(r, v, ci))
    offs = (r.randint(0, (v - w) // 8, (n,)) * 8).astype(np.int32)
    tpu = make_win(n, w, ci)(xj, jnp.asarray(offs))
    port = G.window_copy(xt, torch.from_numpy(offs), w)
    np.testing.assert_array_equal(port.float().numpy(), _np(tpu))


def test_window_copy_outside_and_chunks():
    """A window not inside x gives zeros; the chunk plan splits a window
    only where it does not fit one copy."""
    x = torch.arange(20 * 8, dtype=torch.float32).reshape(20, 8)
    offs = torch.tensor([0, 12, 13, -1], dtype=torch.int32)
    out = G.window_copy(x, offs, 8)
    assert torch.equal(out[0], x[0:8]) and torch.equal(out[1], x[12:20])
    assert not out[2:].any()
    assert G.window_chunk_rows(96, 2048) == 2048  # Ci = 48 bf16: one copy
    assert G.window_chunk_rows(96, 2048, 20000) == 20000 // 96
    with pytest.raises(ValueError):
        G.window_chunk_rows(G.MAX_BULK_BYTES + 16, 4)


# ---- K9 ------------------------------------------------------------------

@pytest.mark.parametrize("w,h,ci", [(16, 3, 16), (32, 4, 32), (8, 2, 48)])
def test_window_gather_matches_tpu_kernel(w, h, ci):
    """K9's plain version against `make_onehot`'s body (a bf16 one-hot
    product selects exactly): bit for bit."""
    r = np.random.RandomState(w + h)
    v = 3 * T
    xj, xt = _as_bf16(_bf16(r, w, ci))
    idx = r.randint(0, w, (h, v)).astype(np.int32)
    tpu = make_onehot(w, h)(xj, jnp.asarray(idx))
    port = G.window_gather(xt, torch.from_numpy(idx))
    np.testing.assert_array_equal(port.float().numpy(), _np(tpu))


def test_window_gather_outside_ids_give_zeros():
    xw = torch.randn(6, 8)
    idx = torch.tensor([[0, 5, 6, -1]], dtype=torch.int32)
    out = G.window_gather(xw, idx)
    assert torch.equal(out[0, :2], xw[[0, 5]]) and not out[0, 2:].any()


@pytest.mark.parametrize("rows,w,ci", [
    (3 * 65536, 1024, 16), (3 * 65536, 2048, 16), (4 * 40960, 1024, 32),
    (4 * 40960, 2048, 32), (4 * 24576, 1024, 48), (4 * 24576, 2048, 48),
    (131 * 256 + 3, 1000, 48), (7, 1000, 48), (1, 3, 8),
])
def test_window_gather_plan(rows, w, ci):
    """K9's launch: clusters of 2 up to 96 KB of window and of 4 above, a
    whole number of clusters, at most one CTA per SM, the CTAs' parts
    covering the window and their contiguous ranges covering every row
    once, however the rows divide."""
    row_bytes = 2 * ci
    plan = G.window_gather_plan(rows, w, row_bytes)
    c, ctas = plan["cluster"], plan["ctas"]
    assert c == (2 if w * row_bytes <= 96 * 1024 else 4)
    assert ctas % c == 0 and c <= ctas <= G.SMS
    assert ctas - c < max(1, -(-rows // G.GATHER_MIN_ROWS))  # no cluster more than the rows need
    assert plan["part_rows"] * c >= w > plan["part_rows"] * (c - 1)
    assert plan["smem"] == w * row_bytes <= G.MAX_BULK_BYTES
    per = plan["rows_per_cta"]
    starts = [min(rows, b * per) for b in range(ctas)]
    counts = [min(rows - q0, per) for q0 in starts]
    assert sum(counts) == rows and all(n >= 0 for n in counts)
    assert all(q0 + n == q1 for q0, n, q1 in zip(starts, counts, starts[1:] + [rows]))
    for other in G.GATHER_CLUSTERS:
        assert G.window_gather_plan(rows, w, row_bytes, other)["cluster"] == other


def test_window_gather_refuses(monkeypatch):
    """What the kernel cannot take raises before any launch: a window past
    a CTA's shared memory (it is multicast whole to every CTA), a cluster
    other than 2 or 4, an empty window, rows that are not whole 16-byte
    chunks, a misaligned window."""
    with pytest.raises(ValueError, match="shared memory"):
        G.window_gather_plan(10, 4096, 96)
    with pytest.raises(ValueError, match="cluster"):
        G.window_gather_plan(10, 64, 32, cluster=3)
    with pytest.raises(ValueError, match="empty"):
        G.window_gather_plan(10, 0, 32)
    monkeypatch.setattr(G, "on_cuda", lambda *t: True)  # the kernel route, unlaunched
    idx = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        G.window_gather(torch.zeros((4096, 48), dtype=torch.bfloat16), idx)
    with pytest.raises(ValueError, match="16-byte"):
        G.window_gather(torch.zeros((64, 4), dtype=torch.bfloat16), idx)
    with pytest.raises(ValueError, match="aligned"):
        G.window_gather(torch.zeros(64 * 16 + 1, dtype=torch.bfloat16)[1:].reshape(64, 16),
                        idx)


# ---- K10 -----------------------------------------------------------------

def _band_inputs(seed, h, ci, co, v, taps):
    r = np.random.RandomState(seed)
    xm = _bf16(r, ci, v)
    x = _bf16(r, h, ci, v)
    w = (_bf16(r, co, 27 * ci) * 0.2).astype(np.float32)
    if taps == "real":
        tap = B.real_table_taps(r, h, v)
    else:  # the TPU probe's recipe, tools/exp_bandmm_variants.py:33-35
        tap = np.sort(r.randint(0, 27, size=(h, v)), axis=0).astype(np.int32)
        tap[r.rand(h, v) > 0.8] = 27
    return xm, x, tap, w


def _port_band(xm, x, tap, w):
    return B.band_apply(torch.from_numpy(xm), torch.from_numpy(x),
                        torch.from_numpy(tap), torch.from_numpy(w)).numpy()


def test_real_table_taps_hold_a_slot_tables_invariants():
    r = np.random.RandomState(0)
    tap = B.real_table_taps(r, 3, 4096)
    hit = tap < 27
    assert tap.dtype == np.int32 and not (tap == B.CENTER).any()
    assert (hit[:-1] | ~hit[1:]).all()  # hits packed into the first slots
    both = hit[:-1] & hit[1:]
    assert (tap[1:][both] > tap[:-1][both]).all()  # distinct, ascending
    assert (tap[hit] >= np.nonzero(hit)[0]).all()  # tap >= slot
    assert abs(hit.mean() - 0.8) < 0.02


@pytest.mark.parametrize("variant", ["a", "b", "c", "d", "pair"])
def test_band_apply_matches_tpu_variants_on_real_table_taps(variant):
    """On real-table taps every TPU variant computes the port's function:
    fp32 within 1e-5 * max|plain| (V = 1024, tile 256, the probe's H = 3,
    Ci = Co = 16, K = 27)."""
    xm, x, tap, w = _band_inputs(1, 3, 16, 16, 1024, "real")
    body = tpu_band_kernels(3, 16, 27)[variant]
    tpu = run_band_kernel(body, *(jnp.asarray(a) for a in (xm, x, tap, w)), 256)
    port = _port_band(xm, x, tap, w)
    np.testing.assert_allclose(port, tpu, rtol=0,
                               atol=K10_REL_TOL * np.abs(port).max())


def test_tpu_variants_differ_on_the_probes_own_taps():
    """The TPU probe's recipe (sorted randint, then 20% misses) holds tap
    13 beside the centre, duplicates and taps below their slot.  There
    `kern_a` (centre replaced, tap < h skipped, duplicates summed) and
    `mk_pair` (tap-13 rows added to the centre, tap < h - 1 skipped)
    compute different functions, and neither is the port's (every source
    summed); the port's plain version states its own rule exactly."""
    xm, x, tap, w = _band_inputs(2, 3, 16, 16, 1024, "probe")
    hit = tap < 27
    assert (tap == 13).sum() > 0
    assert (hit[1:] & (tap[1:] == tap[:-1])).sum() > 0  # duplicates
    assert (hit & (tap < np.arange(3)[:, None])).sum() > 0
    kernels_ = tpu_band_kernels(3, 16, 27)
    args = tuple(jnp.asarray(a) for a in (xm, x, tap, w))
    a = run_band_kernel(kernels_["a"], *args, 256)
    pair = run_band_kernel(kernels_["pair"], *args, 256)
    port = _port_band(xm, x, tap, w)
    scale = np.abs(port).max()
    assert np.abs(a - pair).max() > 0.1 * scale
    assert np.abs(pair - port).max() > 0.01 * scale
    assert np.abs(a - port).max() > 0.1 * scale
    # the port's rule in numpy: every source of band k, the centre first
    e = np.zeros((27, 16, 1024), np.float32)
    e[13] = xm
    for h in range(3):
        for k in range(27):
            e[k] = np.where(tap[h] == k, e[k] + x[h], e[k])
    np.testing.assert_allclose(port, w @ e.reshape(27 * 16, 1024), rtol=0,
                               atol=K10_REL_TOL * scale)


def test_band_apply_rounds_each_band_once_to_the_input_type():
    """bf16 inputs: E is the fp32 sum of a band's sources rounded once to
    bf16 (duplicates and tap 13 beside the centre), both E builds and
    tiles giving the same function on the CPU."""
    xm, x, tap, w = _band_inputs(3, 3, 16, 16, 200, "probe")
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (xm, x, w)]
    tp = torch.from_numpy(tap)
    e = B.band_matrix(t[0], t[1], tp, 27)
    want = np.zeros((27, 16, 200), np.float32)
    want[13] = t[0].float().numpy()
    for h in range(3):
        for k in range(27):
            want[k] = np.where(tap[h] == k, want[k] + t[1][h].float().numpy(), want[k])
    want = torch.from_numpy(want).to(torch.bfloat16).reshape(27 * 16, 200)
    assert e.dtype == torch.bfloat16 and torch.equal(e, want)
    outs = [B.band_apply(t[0], t[1], tp, t[2], eb, bv)
            for eb in B.E_BUILDS for bv in B.VOXELS_PER_BLOCK]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(outs[0], t[2].float() @ want.float())


def test_band_apply_all_misses_and_no_centre():
    """A table whose rows all miss: W[:, 13] @ xm with the centre, zeros
    without it (the compact E then has no band at all)."""
    xm, x, tap, w = _band_inputs(4, 3, 16, 16, 64, "real")
    tap[:] = 27
    t = [torch.from_numpy(a) for a in (xm, x, tap, w)]
    np.testing.assert_allclose(B.band_apply(*t, "compact").numpy(),
                               w[:, 13 * 16:14 * 16] @ xm, rtol=1e-6, atol=1e-5)
    assert not B.band_apply(None, *t[1:], "compact").any()


def test_band_apply_refuses_bad_shapes():
    xm, x, tap, w = (torch.from_numpy(a) for a in _band_inputs(5, 3, 16, 16, 32, "real"))
    with pytest.raises(ValueError):
        B.band_apply(xm, x, tap[:2], w)
    with pytest.raises(ValueError):
        B.band_apply(xm, x, tap, w, "sparse")
    with pytest.raises(ValueError):
        B.band_apply(xm, x, tap, w, "full", 96)
    with pytest.raises(TypeError):
        B.band_apply(xm, x, tap.long(), w)
    assert B.smem_bytes(128, 3, 16, 16, 27) <= B.MAX_SMEM_BYTES


@pytest.mark.parametrize("voxels", B.VOXELS_PER_BLOCK)
@pytest.mark.parametrize("v", [65536, 65496, 1001, 40, 0])
def test_band_plan_persistent_grid(voxels, v):
    """K10's launch: tiles of `voxels` voxels walked by a persistent grid of
    at most BLOCKS_PER_SM blocks per SM, never more blocks than tiles, as
    many blocks of one SM as fit its shared memory; a consumer warp per 16
    voxels and the producer warp.  At the probe's V each block walks
    several tiles."""
    plan = B.band_plan(v, 3, 16, 16, 27, voxels)
    assert plan["tiles"] == -(-v // voxels)
    assert 1 <= plan["blocks"] <= max(1, plan["tiles"])
    assert plan["blocks"] <= B.SMS * plan["per_sm"]
    assert plan["per_sm"] <= B.BLOCKS_PER_SM[voxels]
    assert plan["per_sm"] * (plan["smem"] + 1024) <= B.SM_SMEM_BYTES
    assert plan["threads"] == 32 * (voxels // 16 + 1)
    assert plan["smem"] == B.smem_bytes(voxels, 3, 16, 16, 27) <= B.MAX_SMEM_BYTES
    if v == 65536:
        assert plan["tiles"] > plan["blocks"]


def test_band_smem_bytes_layout():
    """One block's shared memory, by csrc/exp_bandmm.cu's layout: 1 KB of
    alignment slack, RING_STAGES stages of H + 1 (Ci, voxels) bf16 blocks
    and H int32 tap rows each rounded up to a KB, W with rows padded by 8
    bf16, two (Co, voxels + 4) fp32 out tiles, each consumer warp's source
    blocks."""
    assert B.RING_STAGES == 3
    assert B.smem_bytes(64, 3, 16, 16, 27) == (1024 + 3 * 9216 + 16 * 440 * 2
                                               + 2 * 16 * 68 * 4 + 4 * 5 * 512)
    assert B.smem_bytes(128, 3, 16, 16, 27) == (1024 + 3 * 18432 + 14080
                                                + 2 * 16 * 132 * 4 + 8 * 5 * 512)
    # H = 5: stages of 14 KB (6 blocks of 2 KB and 1,280 B of taps), 8 slots held
    assert B.smem_bytes(64, 5, 16, 16, 27) - B.smem_bytes(64, 3, 16, 16, 27) == (
        3 * (14336 - 9216) + 4 * (10 - 5) * 512)
    assert B.band_plan(65536, 3, 16, 16, 27, 64)["per_sm"] == 3
    assert B.band_plan(65536, 3, 16, 16, 27, 128)["per_sm"] == 2


@pytest.mark.parametrize("h,ci,co,k,match", [
    (9, 16, 16, 27, "H <= 8"), (3, 272, 16, 27, "Ci <= 256"), (3, 24, 16, 27, "multiples"),
    (3, 16, 80, 27, "Co <= 64"), (3, 16, 16, 33, "K <= 32"),
    (3, 64, 64, 27, "shared memory"),
])
def test_band_apply_kernel_route_refuses(monkeypatch, h, ci, co, k, match):
    """On the kernel route (CUDA tensors; here the CPU ones, unlaunched)
    every shape the kernel does not take raises before the launch."""
    monkeypatch.setattr(B, "on_cuda", lambda *t: True)
    v = 64
    x = torch.zeros((h, ci, v), dtype=torch.bfloat16)
    tap = torch.from_numpy(np.full((h, v), k, np.int32))
    w = torch.zeros((co, k * ci), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        B.band_apply(None, x, tap, w, "full", 64)


def _cut_source():
    with open(os.path.join(REPO, "mm2d3d_tpu_torch/csrc/exp_bandmm.cu")) as f:
        return f.read()


def test_stages_cut_texts_occur_once():
    """`--stages` cuts the kernel's own steps (the fragment build, the
    product, the band loop, the stores) or turns off the probe shape's own
    instantiation; each cut's text occurs exactly once in
    csrc/exp_bandmm.cu, and every variant's source carries its replacements
    and none of the texts it cut."""
    src = _cut_source()
    cuts = exp_bandmm_variants.CUTS
    assert set(cuts) == {"fragment build", "product", "bands", "stores",
                         "probe instantiation"}
    for name, (old, new) in cuts.items():
        assert src.count(old) == 1, name
        assert old != new
    assert set(exp_bandmm_variants.STAGE_VARIANTS) == {
        "no product", "no fragment build", "no stores", "ring and staging only",
        "general path"}
    for variant, names in exp_bandmm_variants.STAGE_VARIANTS.items():
        cut = src
        for name in names:
            old, new = cuts[name]
            cut = cut.replace(old, new)
        for name in names:
            assert cuts[name][0] not in cut and cuts[name][1] in cut, (variant, name)


# ---- registry, tools -----------------------------------------------------

def _source_line(ref: str) -> str:
    path, line = ref.rsplit(":", 1)
    with open(os.path.join(REPO, path)) as f:
        return f.read().splitlines()[int(line) - 1]


@pytest.mark.parametrize("name,fn", [
    ("exp_group_gather", "def kern(idx_ref"), ("exp_window_copy", "def kern(off_ref"),
    ("exp_window_gather", "def onehot_kernel("), ("exp_bandmm", "def kern_a("),
])
def test_registry_names_each_probe_kernel(name, fn):
    """Each probe kernel is registered with its own launch counter, and its
    `replaces` points at the TPU kernel's body."""
    k = kernels.all_kernels()[name]
    assert fn in _source_line(k.replaces)
    assert os.path.exists(os.path.join(REPO, k.source))
    assert kernels.counts()[name] == k.launches


def _calls(path: str, fn: str) -> list:
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    return [tuple(a.value for a in node.args) for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == fn]


def test_tool_cases_are_the_tpu_probes_sizes():
    assert tuple(_calls("tools/exp_dma_gather.py", "case")) == exp_dma_gather.CASES
    with open(os.path.join(REPO, "tools/exp_bandmm_variants.py")) as f:
        src = f.read()
    assert "V, H, CI, CO, K = 65536, 3, 16, 16, 27" in src
    t = exp_bandmm_variants
    assert (t.V, t.H, t.CI, t.CO, t.K) == (65536, 3, 16, 16, 27)
    assert exp_dma_gather.T == 512 and exp_dma_gather.WINDOWS == (1024, 2048)
    assert exp_dma_gather.GROUPS == (8, 1)


@pytest.mark.parametrize("tool", [exp_dma_gather, exp_bandmm_variants])
def test_tool_without_cuda_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


def test_probe_ab_cases_are_the_probes():
    """`tools/slotconv_ab.py --probes` times K9 at the gather probe's three
    cases and both windows and K10 at both tap tables, E builds and tiles;
    the calls take any device (here the plain versions), and the K10 inputs
    are the probe tool's."""
    calls = dict(kernel_cases.probe_calls(torch.device("cpu")))
    assert len(calls) == len(exp_dma_gather.CASES) * len(exp_dma_gather.WINDOWS) + 2 * 2 * 2
    h, v, ci = exp_dma_gather.CASES[0]
    out = calls[f"K9 H={h} V={v} Ci={ci} w=1024"]()
    assert out.shape == (h, v, ci) and out.dtype == torch.bfloat16
    assert [k for k in calls if k.startswith("K10")] == [
        f"K10 {taps} E={e} {n} voxels" for taps in ("real-table", "flagship L0")
        for e in B.E_BUILDS for n in B.VOXELS_PER_BLOCK]
    xm, x, tap, w = kernel_cases.band_inputs(torch.device("cpu"), v=256)
    assert (x.shape, tap.shape, w.shape) == ((3, 16, 256), (3, 256), (16, 27 * 16))


def test_probe_ab_child_loads_this_tree_and_needs_cuda(monkeypatch):
    """A child run of `slotconv_ab.py --probes` builds its inputs from this
    tree's `kernel_cases.py` (loaded from its file) and refuses without a
    CUDA device."""
    assert callable(slotconv_ab._kernel_cases().probe_calls)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert slotconv_ab.main(["--tree", REPO, "--probes"]) == 1
