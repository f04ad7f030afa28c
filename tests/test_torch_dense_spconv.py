"""The dense 27-tap submanifold convolution of mm2d3d_tpu_torch vs the JAX
package: K6's plain version (the wrapper's CPU route) against the Pallas
`tapsum` kernel in interpret mode and against `_xla_tapsum`; `subm_conv3` on
a level without slot tables, forward and adjoint (torch autograd vs
`jax.vjp` of `_subm_apply`); and `build_hierarchy` over every slot-spec form
the JAX function takes, table for table.

fp32 throughout.  K6 and the forward: rtol/atol 1e-5 (only the order of
fp32 sums differs; 1e-5 also holds the interpret-mode kernel, which
test_pallas.py holds to its XLA form at 1e-5).  The adjoints: within
1e-5 * max|ref|.  Integer tables: bit-identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_equal, t2n

from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops import spconv as SJ
from mm2d3d_tpu.ops.pallas import tapsum as TJ
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import spconv as S
from mm2d3d_tpu_torch.ops.kernels.tapsum import tapsum, tapsum_ref
from mm2d3d_tpu_torch.ops.voxelize import voxelize

TOL = dict(rtol=1e-5, atol=1e-5)
LEVEL_FIELDS = ("key_hi", "key_lo", "coords", "batch", "valid", "num_voxels",
                "nbr", "slot_src", "slot_tap", "slot_overflow", "slot_idx",
                "slot_src2", "slot_tap2", "slot_idxm", "slot_invm",
                "slot_srcm", "slot_tapm")


def _gw(rng, k, v, ci, co):
    g = rng.randn(k, v, ci).astype(np.float32)
    w = (rng.randn(k, ci, co) * 0.1).astype(np.float32)
    return g, w


def test_tapsum_plain_version_matches_pallas_interpret(rng):
    """V = 1024, the TPU kernel's 512-row tiles, as tests/test_pallas.py."""
    from jax.experimental import pallas as pl

    k, v, ci, co = 27, 1024, 16, 16
    g, w = _gw(rng, k, v, ci, co)
    ref = pl.pallas_call(
        functools.partial(TJ._kernel, k_taps=k),
        grid=(v // 512,),
        in_specs=[pl.BlockSpec((k, 512, ci), lambda i: (0, i, 0)),
                  pl.BlockSpec((k, ci, co), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((512, co), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((v, co), jnp.float32),
        interpret=True,
    )(jnp.asarray(g), jnp.asarray(w))
    for fn in (tapsum_ref, tapsum):
        out = fn(torch.from_numpy(g), torch.from_numpy(w))
        assert out.dtype == torch.float32 and out.shape == (v, co)
        np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


TAPSUM_CASES = {
    # (K, V, Ci, Co)
    "ragged_v_co12": (27, 700, 16, 12),
    "input_conv_ci3": (27, 513, 3, 16),
    "wide": (27, 300, 48, 40),
    "eight_taps": (8, 256, 4, 4),
}


@pytest.mark.parametrize("case", sorted(TAPSUM_CASES))
def test_tapsum_matches_xla_tapsum(rng, case):
    k, v, ci, co = TAPSUM_CASES[case]
    g, w = _gw(rng, k, v, ci, co)
    ref = TJ._xla_tapsum(jnp.asarray(g), jnp.asarray(w), jax.lax.Precision.HIGHEST)
    for fn in (tapsum_ref, tapsum):
        out = fn(torch.from_numpy(g), torch.from_numpy(w))
        assert out.dtype == torch.float32 and out.shape == (v, co)
        np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


def test_tapsum_refuses_grad_and_mismatched_shapes():
    w = torch.randn(27, 4, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tapsum(torch.randn(27, 8, 4), w)
    with pytest.raises(ValueError):
        tapsum(torch.randn(27, 8, 5), torch.randn(27, 4, 4))
    with pytest.raises(TypeError):
        tapsum(torch.randn(27, 8, 4).bfloat16(), torch.randn(27, 4, 4))


CAPS = (2048, 1024, 512)


def _points(seed):
    r = np.random.RandomState(seed)
    n, fs = 2000, 64
    coords = r.randint(0, fs, size=(n, 3)).astype(np.int32)
    batch = np.repeat(np.arange(2, dtype=np.int32), n // 2)
    valid = r.rand(n) < 0.95
    return coords, batch, valid, fs


def _hierarchies(slot_caps, seed=11):
    """The same points through both packages' `build_hierarchy`."""
    coords, batch, valid, fs = _points(seed)

    @jax.jit
    def build_jax(c, b, m):
        g = voxelize_jax(c, b, m, fs, capacity=CAPS[0])
        return HJ.build_hierarchy(g, 3, capacities=CAPS, slot_caps=slot_caps,
                                  num_batches=2)

    hj = build_jax(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid))
    gt = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                  torch.from_numpy(valid), fs, capacity=CAPS[0])
    return hj, H.build_hierarchy(gt, 3, CAPS, slot_caps, num_batches=2)


SLOT_FORMS = {
    "none": None,
    # tests/test_pallas.py's mixed spec: 3-tier, 2-tier, 1-tier
    "mixed_5_3_int": ((2, 5, 26, 512, 128), (3, 26, 256), 4),
    "level1_none": ((3, 6, 26, 512, 128), None, (8, 26, 256)),
    "int_zero_int": (5, 0, 3),
    "short_list": ((3, 26, 256),),
}


@pytest.mark.parametrize("form", sorted(SLOT_FORMS))
def test_build_hierarchy_slot_forms_match_jax(form):
    hj, ht = _hierarchies(SLOT_FORMS[form])
    for l, (a, b) in enumerate(zip(ht.levels, hj.levels)):
        for name in LEVEL_FIELDS:
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), f"level{l}.{name}"
            if x is not None:
                assert_equal(x, y, f"level{l}.{name}")
    for l, (a, b) in enumerate(zip(ht.transitions, hj.transitions)):
        for name in ("parent", "off_id", "child"):
            assert_equal(getattr(a, name), getattr(b, name), f"trans{l}.{name}")


def test_build_hierarchy_refuses_unknown_specs():
    coords, batch, valid, fs = _points(0)
    gt = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                  torch.from_numpy(valid), fs, capacity=CAPS[0])
    for bad in ((3, 26), -1, "dense"):
        with pytest.raises(ValueError):
            H.build_hierarchy(gt, 3, CAPS, (bad, None, None), num_batches=2)


@pytest.fixture(scope="module")
def dense():
    return _hierarchies(None)


@pytest.mark.parametrize("level", [0, 1])
def test_subm_conv3_dense_matches_jax(dense, level):
    hj, ht = dense
    lt, lj = ht.levels[level], hj.levels[level]
    assert lt.slot_src is None and lj.slot_src is None
    r = np.random.RandomState(level)
    cin, cout = 12, 20
    feats = r.randn(lt.capacity, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.1).astype(np.float32)
    out = S.subm_conv3(torch.from_numpy(feats), lt, torch.from_numpy(w),
                       torch.float32)
    ref = SJ.subm_conv3(jnp.asarray(feats), lj, jnp.asarray(w), jnp.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(t2n(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("level", [0, 1])
def test_subm_conv3_dense_adjoint_matches_jax(dense, level):
    hj, ht = dense
    lt, lj = ht.levels[level], hj.levels[level]
    r = np.random.RandomState(10 + level)
    cin, cout = 12, 20
    x = r.randn(lt.capacity, cin).astype(np.float32)
    w = (r.randn(27, cin, cout) * 0.1).astype(np.float32)
    cot = r.randn(lt.capacity, cout).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    # a column slice, as the decoder's concat hands the conv its gradient
    wide = torch.from_numpy(np.concatenate([cot, cot], 1))
    S.subm_conv3(xt, lt, wt, torch.float32).backward(wide[:, :cout])
    _, vjp = jax.vjp(lambda a, k: SJ.subm_conv3(a, lj, k, jnp.float32),
                     jnp.asarray(x), jnp.asarray(w))
    for name, ours, ref in zip(("d_feats", "d_weight"), (xt.grad, wt.grad),
                               vjp(jnp.asarray(cot))):
        ref = np.asarray(ref)
        assert ours.shape == ref.shape, name
        np.testing.assert_allclose(t2n(ours), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=name)
