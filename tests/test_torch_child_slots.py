"""The child-slot form of the strided convolutions (`ops.hierarchy
.build_child_slots`; `ops.spconv._DownSlots` / `_UpSlots`, which apply
`LevelTransition.child_tiers()` through the submanifold conv's
`_apply_tiers` / `_dw_tiers`) against the JAX package's, fp32 on the CPU.

- The child slot tables of `build_hierarchy(child_slot_caps=)` bit-equal to
  JAX's, for "default" and per-transition specs, one of whose heavy tiers
  is too small and drops children (counted in `cslot_overflow`).
- `down_conv2` / `up_conv2` over the child slots: the output and both
  gradients within 1e-5 * max|JAX| of `jax.vjp` of `_down_apply_slots` /
  `_up_apply_slots` (fp32 sums in another order); without drops, within
  1e-5 * max of the plain child-table form too.
- Both overflow monitors (`nbr_slot_overflow` at eval, train/ at train) add
  the child slots' drops.
- The eval slice over a topology with child slots against the JAX slice
  over its own: logits within rtol 1e-3, atol 1e-4, as
  tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_equal, jax_batch, randomize_stats, t2n, to_numpy_tree
from _torch_port import two_threads  # noqa: F401  (fixture)

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops.spconv import _down_apply_slots, _up_apply_slots
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu.train.batch import prepare_device_batch as prepare_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import spconv as S
from mm2d3d_tpu_torch.ops.voxelize import voxelize
from mm2d3d_tpu_torch.train.batch import build_topology, default_capacities

pytestmark = pytest.mark.usefixtures("two_threads")

FS, N = 64, 1536  # per scan; two scans
CAPS = default_capacities(2 * N, 3, batch_size=2)
CSLOT_FIELDS = ("cslot_src", "cslot_tap", "cslot_idx", "cslot_src2", "cslot_tap2",
                "cslot_overflow")
SPECS = {"default": "default", "tight": [(1, 8), (1, 4)], "mixed": [None, (4, 300)]}
REL = 1e-5


def _points(seed=0):
    """Two synthetic scans' points (surfaces, as LiDAR's: a parent has about
    two children, some many more)."""
    b = make_batch(np.random.RandomState(seed), batch_size=2, height=32, width=48,
                   n_points=N, full_scale=FS)
    coords = b.coords.reshape(-1, 3).numpy()
    batch = np.repeat(np.arange(2, dtype=np.int32), N)
    return coords, batch, b.point_mask.reshape(-1).numpy(), FS


def _hierarchies(spec):
    coords, batch, valid, fs = _points()
    grid = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                    torch.from_numpy(valid), fs, capacity=CAPS[0])
    hier = H.build_hierarchy(grid, 3, CAPS, None, num_batches=2, child_slot_caps=spec)
    grid_j = voxelize_jax(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid),
                          fs, capacity=CAPS[0])
    hier_j = HJ.build_hierarchy(grid_j, 3, capacities=CAPS, slot_caps=None,
                                num_batches=2, child_slot_caps=spec)
    return hier, hier_j


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_child_slot_tables_match_jax(spec):
    hier, hier_j = _hierarchies(SPECS[spec])
    for l, (t, tj) in enumerate(zip(hier.transitions, hier_j.transitions)):
        for name in CSLOT_FIELDS + ("parent", "off_id", "child"):
            a, b = getattr(t, name), getattr(tj, name)
            assert (a is None) == (b is None), (l, name)
            if a is not None:
                assert_equal(a, b, f"T{l}.{name}")
    drops = [int(t.cslot_overflow) for t in hier.transitions if t.cslot_overflow is not None]
    if spec == "tight":
        assert min(drops) > 0
    else:
        assert drops and max(drops) == 0


def _conv_case(spec, l, op, seed):
    hier, hier_j = _hierarchies(SPECS[spec])
    t, tj = hier.transitions[l], hier_j.transitions[l]
    vf, vc = hier.levels[l].capacity, hier.levels[l + 1].capacity
    r = np.random.RandomState(seed)
    cin, cout = 12, 20
    rows_in, rows_out = (vf, vc) if op == "down" else (vc, vf)
    x = r.randn(rows_in, cin).astype(np.float32)
    w = (r.randn(8, cin, cout) * 0.1).astype(np.float32)
    cot = r.randn(rows_out, cout).astype(np.float32)
    return t, tj, x, w, cot


def _port(op, trans, x, w, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    fn = S.down_conv2 if op == "down" else S.up_conv2
    out = fn(xt, trans, wt, torch.float32)
    out.backward(torch.from_numpy(cot))
    return t2n(out), t2n(xt.grad), t2n(wt.grad)


@pytest.mark.parametrize("op", ["down", "up"])
@pytest.mark.parametrize("l", [0, 1])
@pytest.mark.parametrize("spec", ["default", "tight"])
def test_slot_strided_convs_match_jax_vjp(spec, l, op):
    t, tj, x, w, cot = _conv_case(spec, l, op, seed=10 * l + (op == "up"))
    assert t.cslot_src is not None
    tables = (tj.cslot_src, tj.cslot_tap, tj.cslot_idx, tj.cslot_src2, tj.cslot_tap2)
    if op == "down":
        fj = lambda a, b: _down_apply_slots(a, b, *tables, tj.parent, tj.off_id)  # noqa: E731
    else:
        fj = lambda a, b: _up_apply_slots(a, b, tj.parent, tj.off_id, *tables)  # noqa: E731
    out_j, vjp = jax.vjp(fj, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(cot))
    ours = _port(op, t, x, w, cot)
    for name, a, b in zip(("out", "d_feats", "d_weight"), ours, (out_j, dx_j, dw_j)):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * float(np.abs(b).max()),
                                   err_msg=name)


@pytest.mark.parametrize("op", ["down", "up"])
def test_slot_strided_convs_equal_the_plain_form(op):
    """Without drops the child slots compute the plain form's function."""
    import dataclasses

    t, _, x, w, cot = _conv_case("default", 0, op, seed=3)
    plain = dataclasses.replace(t, **{f: None for f in CSLOT_FIELDS})
    for a, b in zip(_port(op, t, x, w, cot), _port(op, plain, x, w, cot)):
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * float(np.abs(b).max()))


SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=32, width=48, n_points=256, full_scale=256, wire=True)
TIGHT = [(1, 2), (1, 2)]  # one child per parent in tier 1, two heavy parents


def test_monitors_count_child_slot_drops():
    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.init_params(torch.Generator().manual_seed(0))
    src, trg = (make_batch(np.random.RandomState(s), **BATCH) for s in (0, 1))
    topo = build_topology(src, 256, 3, child_slot_caps=TIGHT)
    cdrop = sum(int(t.cslot_overflow) for t in topo[1].transitions)
    ldrop = sum(int(l.slot_overflow) for l in topo[1].levels)
    assert cdrop > 0
    _, logs = task.eval_step(src, topo=topo)
    assert float(logs["nbr_slot_overflow"]) == cdrop + ldrop
    topo_t = build_topology(trg, 256, 3, child_slot_caps=TIGHT)
    logs = task.train_step(src, trg, torch.Generator().manual_seed(0), topo, topo_t)
    both = cdrop + ldrop + sum(int(t.cslot_overflow) for t in topo_t[1].transitions) \
        + sum(int(l.slot_overflow) for l in topo_t[1].levels)
    assert float(logs["train/nbr_slot_overflow"]) == both
    _, logs = task.eval_step(src, topo=build_topology(src, 256, 3,
                                                      child_slot_caps="default"))
    assert float(logs["nbr_slot_overflow"]) == ldrop == 0


def _jax_forward(task, state, batch, topo):
    batch = prepare_jax(batch)
    p2, _, _, _ = task._fwd2d(state.params2d, state.stats2d, batch, False)
    p3, _, _, _ = task._fwd3d(state.params3d, state.stats3d, batch, *topo, False)
    sm2 = jax.nn.softmax(p2["seg_logit"].reshape(-1, task.num_classes), -1)
    sm3 = jax.nn.softmax(p3["seg_logit"], -1)
    return {"seg_logit_2d": p2["seg_logit"], "seg_logit_3d": p3["seg_logit"],
            "ensemble": (sm2 + sm3) / 2}


def _jax_topology(batch):
    """JAX's build_topology with child slots (its build_topology takes
    none): the same voxelize and build_hierarchy calls."""
    from mm2d3d_tpu.train.batch import default_slot_caps, flatten_points

    coords, _, _, mask, bidx = flatten_points(batch)
    caps = default_capacities(coords.shape[0], 3, batch_size=batch.batch_size)
    grid = voxelize_jax(coords, bidx, mask, 256, capacity=caps[0],
                        presorted=batch.coords_sorted)
    hier = HJ.build_hierarchy(grid, 3, capacities=caps,
                              slot_caps=default_slot_caps(3, caps),
                              num_batches=batch.batch_size, child_slot_caps="default")
    return grid, hier


def test_eval_slice_with_child_slots_matches_jax():
    task_j = flagship_task_jax(compute_dtype=jnp.float32, **SMALL)
    batch_j = jax_batch(make_batch_jax(np.random.RandomState(0), **BATCH))
    state = task_j.init_state(jax.random.PRNGKey(0), batch_j)
    state = state.replace(stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    fwd_j = jax.jit(lambda s, b: _jax_forward(task_j, s, b, _jax_topology(b)))(
        state, batch_j)

    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.load_flax(to_numpy_tree(state.params2d), to_numpy_tree(state.stats2d),
                   to_numpy_tree(state.params3d), to_numpy_tree(state.stats3d))
    batch = make_batch(np.random.RandomState(0), **BATCH)
    topo = build_topology(batch, 256, 3, child_slot_caps="default")
    assert all(t.cslot_src is not None for t in topo[1].transitions)
    fwd = task.forward(batch, topo=topo)
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        np.testing.assert_allclose(t2n(fwd[name]), np.asarray(fwd_j[name]),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
