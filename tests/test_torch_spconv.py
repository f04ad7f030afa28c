"""Sparse convolutions of mm2d3d_tpu_torch vs the JAX package.

K1's and K2's plain versions (the wrappers' CPU route) vs
`bandmm._apply_xla` and `bandmm._dw_xla`, then `subm_conv3` over each tier
form and the strided convolutions, forward and adjoint (torch autograd vs
`jax.vjp` of the custom VJPs), on the port's own topology vs the JAX ops on
the JAX tables.  fp32 throughout; forward rtol/atol 1e-5, K2 and the
adjoints within 1e-5 * max|ref|, since only the order of fp32 sums differs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t2n

from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops import spconv as SJ
from mm2d3d_tpu.ops.pallas import bandmm as BJ
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import spconv as S
from mm2d3d_tpu_torch.ops.kernels.bandmm import slot_conv_apply, slot_conv_apply_ref
from mm2d3d_tpu_torch.ops.kernels.bandmm_dw import slot_conv_dw, slot_conv_dw_ref
from mm2d3d_tpu_torch.ops.voxelize import voxelize

TOL = dict(rtol=1e-5, atol=1e-5)


def _taps(rng, h, v, k, tap_lo, miss_frac=0.4):
    """Random slot taps with the ascending-slot invariant tap[h] >= tap_lo + h
    (never the centre for 27-tap tables); k marks an empty slot."""
    tap = np.full((h, v), k, np.int32)
    for hh in range(h):
        t = rng.randint(min(tap_lo + hh, k - 1), k, size=v)
        if k == 27:
            t[t == 13] = 14
        t[rng.rand(v) < miss_frac] = k
        tap[hh] = t
    return tap


CASES = {
    "tier1_with_center": dict(h=4, k=27, ci=16, co=16, xm=True, tap_lo=0),
    "overflow_tier_tap_lo": dict(h=5, k=27, ci=24, co=8, xm=False, tap_lo=3),
    "strided_k8_h1": dict(h=1, k=8, ci=16, co=32, xm=False, tap_lo=0),
    "input_conv_ci3": dict(h=3, k=27, ci=3, co=16, xm=True, tap_lo=0),
    "center_only": dict(h=0, k=27, ci=8, co=8, xm=True, tap_lo=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slot_conv_apply_matches_apply_xla(rng, case):
    c = CASES[case]
    v = 700
    xm = rng.randn(v, c["ci"]).astype(np.float32) if c["xm"] else None
    x_src = rng.randn(c["h"], v, c["ci"]).astype(np.float32) if c["h"] else None
    tap = _taps(rng, c["h"], v, c["k"], c["tap_lo"]) if c["h"] else None
    w = (rng.randn(c["k"], c["ci"], c["co"]) * 0.1).astype(np.float32)

    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = BJ._apply_xla(j(xm), j(x_src), j(tap), j(w))
    for fn in (slot_conv_apply_ref, slot_conv_apply):
        out = fn(t(xm), t(x_src), t(tap), t(w))
        assert out.dtype == torch.float32 and out.shape == (v, c["co"])
        np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_slot_conv_dw_matches_dw_xla(rng, case):
    c = CASES[case]
    v = 700
    xm = rng.randn(v, c["ci"]).astype(np.float32) if c["xm"] else None
    x_src = rng.randn(c["h"], v, c["ci"]).astype(np.float32) if c["h"] else None
    tap = _taps(rng, c["h"], v, c["k"], c["tap_lo"]) if c["h"] else None
    g = rng.randn(v, c["co"]).astype(np.float32)

    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    ref = np.asarray(BJ._dw_xla(j(xm), j(x_src), j(tap), j(g), c["k"]))
    for fn in (slot_conv_dw_ref, slot_conv_dw):
        out = fn(t(xm), t(x_src), t(tap), t(g), k_taps=c["k"])
        assert out.dtype == torch.float32 and out.shape == (c["k"], c["ci"], c["co"])
        np.testing.assert_allclose(t2n(out), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_slot_conv_apply_refuses_grad(rng):
    w = torch.randn(27, 4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        slot_conv_apply(torch.randn(8, 4), None, None, w)


# 3-tier at level 0, 2-tier at level 1, 3-tier at the (unpropagated) level 2
SLOT_CAPS = ((3, 6, 26, 512, 128), (8, 26, 256), (4, 8, 26, 256, 256))


@pytest.fixture(scope="module")
def tables():
    r = np.random.RandomState(11)
    n, fs = 2000, 64
    coords = r.randint(0, fs, size=(n, 3)).astype(np.int32)
    batch = np.repeat(np.arange(2, dtype=np.int32), n // 2)
    valid = r.rand(n) < 0.95
    caps = (2048, 1024, 512)

    @jax.jit
    def build_jax(c, b, m):
        g = voxelize_jax(c, b, m, fs, capacity=caps[0])
        return HJ.build_hierarchy(g, 3, capacities=caps, slot_caps=SLOT_CAPS,
                                  num_batches=2)

    hj = build_jax(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid))
    gt = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                  torch.from_numpy(valid), fs, capacity=caps[0])
    ht = H.build_hierarchy(gt, 3, caps, SLOT_CAPS, num_batches=2)
    return hj, ht


def _strip(level_t, level_j):
    """Tier 1 only, on both sides (the 1-tier slot form)."""
    drop = dict(slot_idx=None, slot_src2=None, slot_tap2=None, slot_idxm=None,
                slot_invm=None, slot_srcm=None, slot_tapm=None)
    return dataclasses.replace(level_t, **drop), level_j.replace(**drop)


@pytest.mark.parametrize("form", ["3tier", "2tier", "1tier"])
def test_subm_conv3_matches_jax(tables, form):
    hj, ht = tables
    l = {"3tier": 0, "2tier": 1, "1tier": 0}[form]
    lt, lj = ht.levels[l], hj.levels[l]
    if form == "1tier":
        lt, lj = _strip(lt, lj)
    assert (lt.slot_srcm is not None) == (form == "3tier")
    assert (lt.slot_src2 is not None) == (form != "1tier")
    r = np.random.RandomState(l)
    cin, cout = 12, 20
    feats = r.randn(lt.capacity, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.1).astype(np.float32)
    out = S.subm_conv3(torch.from_numpy(feats), lt, torch.from_numpy(w),
                       torch.float32)
    ref = SJ.subm_conv3(jnp.asarray(feats), lj, jnp.asarray(w), jnp.float32)
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def _assert_grads_match(fn_t, fn_j, x, w, cot):
    """torch autograd of fn_t vs jax.vjp of fn_j: d_feats and d_weight
    within 1e-5 * max|ref|."""
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    fn_t(xt, wt).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(fn_j, jnp.asarray(x), jnp.asarray(w))
    for name, ours, ref in zip(("d_feats", "d_weight"), (xt.grad, wt.grad),
                               vjp(jnp.asarray(cot))):
        ref = np.asarray(ref)
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(t2n(ours), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("form", ["3tier", "2tier", "1tier"])
def test_subm_conv3_adjoint_matches_jax(tables, form):
    hj, ht = tables
    l = {"3tier": 0, "2tier": 1, "1tier": 0}[form]
    lt, lj = ht.levels[l], hj.levels[l]
    if form == "1tier":
        lt, lj = _strip(lt, lj)
    # dropped slot hits would void the adjoint (it drops per source row)
    assert int(lt.slot_overflow) == int(lj.slot_overflow) == 0
    r = np.random.RandomState(10 + l)
    cin, cout = 12, 20
    feats = r.randn(lt.capacity, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.1).astype(np.float32)
    cot = r.randn(lt.capacity, cout).astype(np.float32)
    _assert_grads_match(
        lambda x, k: S.subm_conv3(x, lt, k, torch.float32),
        lambda x, k: SJ.subm_conv3(x, lj, k, jnp.float32), feats, w, cot)


@pytest.mark.parametrize("op", ["down", "up"])
def test_strided_convs_match_jax(tables, op):
    hj, ht = tables
    r = np.random.RandomState(3)
    cin, cout = 16, 24
    w = (r.randn(8, cin, cout) * 0.1).astype(np.float32)
    tt, tj = ht.transitions[0], hj.transitions[0]
    rows = ht.levels[0 if op == "down" else 1].capacity
    x = r.randn(rows, cin).astype(np.float32)
    fn_t, fn_j = (S.down_conv2, SJ.down_conv2) if op == "down" else (
        S.up_conv2, SJ.up_conv2)
    out = fn_t(torch.from_numpy(x), tt, torch.from_numpy(w), torch.float32)
    ref = jax.jit(lambda a, b: fn_j(a, tj, b, jnp.float32))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("op", ["down", "up"])
def test_strided_convs_adjoint_matches_jax(tables, op):
    hj, ht = tables
    r = np.random.RandomState(4)
    cin, cout = 16, 24
    w = (r.randn(8, cin, cout) * 0.1).astype(np.float32)
    tt, tj = ht.transitions[0], hj.transitions[0]
    rows_in, rows_out = (ht.levels[0].capacity, ht.levels[1].capacity)
    if op == "up":
        rows_in, rows_out = rows_out, rows_in
    x = r.randn(rows_in, cin).astype(np.float32)
    cot = r.randn(rows_out, cout).astype(np.float32)
    fn_t, fn_j = (S.down_conv2, SJ.down_conv2) if op == "down" else (
        S.up_conv2, SJ.up_conv2)
    _assert_grads_match(lambda a, k: fn_t(a, tt, k, torch.float32),
                        lambda a, k: fn_j(a, tj, k, jnp.float32), x, w, cot)
