"""The train slice: mm2d3d_tpu_torch's `MM2D3DTask.train_step` vs the JAX
package's, fp32 on the CPU, three steps from the same weights over the same
two batch pairs, with dropout off on both sides (rate 0 on the port's side;
flax's Dropout patched to the identity while the JAX step is traced).

The weights are the flax init with random running statistics, and with the
2D branch's BatchNorm scales and biases (and its conv biases) drawn as
1 + 0.1 N(0, 1).  At the init's zero biases the 2D branch's fp32 gradient
is ill-conditioned at this size: the port's own fp32 gradient differs from
its fp64 gradient by up to 5% of a leaf's largest element; with biases near
1 they agree within 1e-5.  The optimizers are
SGD with momentum 0.9 on both sides (the task's `optimizer_2d/3d`): AdamW
moves every weight by about lr whatever the size of its gradient, so a
gradient element that rounding alone tips across zero would move by up to
2 lr; AdamW is held against optax in tests/test_torch_train_parts.py.

Held:
- every train/* log at each step within 1e-4 relative, and the same keys;
- step-1 gradients per leaf within 1e-4 * max|leaf| (through `to_flax`);
- weights and running statistics after step 3 within 1e-4 * max|leaf|.

Seven gradients are exempt from the per-leaf rule: those of the
transposed-conv biases of up5..up2 and the conv biases of fuse4..fuse2.
Each bias feeds a train-mode BatchNorm, which subtracts the batch mean, so
its gradient is zero in exact arithmetic and rounding noise in both
programs; both are held below 1e-6 * the branch's largest gradient.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import jax_batch, randomize_stats, to_numpy_tree

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.models.convert import to_flax

SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256,
             wire=True)
PAIRS = ((0, 1), (2, 3), (0, 1))  # (source seed, target seed) per step
OPTIMIZER = {"name": "sgd", "lr": 1e-2, "momentum": 0.9}
REL = 1e-4
BN_SHADOWED = {f"{s}/{m}/bias" for s, m in (
    ("up5", "tconv"), ("up4", "tconv"), ("up3", "tconv"), ("up2", "tconv"),
    ("fuse4", "conv"), ("fuse3", "conv"), ("fuse2", "conv"))}


def _capture(tx):
    """`tx` whose state also keeps the last gradients it was given."""

    def init(params):
        return (jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params))

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _biases_near_one(params, seed):
    """Every 1-D leaf of a flax tree (BatchNorm scales, biases) drawn as
    1 + 0.1 N(0, 1)."""
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (1 + 0.1 * r.randn(*x.shape)).astype(np.float32)
        if x.ndim == 1 else x, to_numpy_tree(params))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def trajectories():
    batches = {s: make_batch_jax(np.random.RandomState(s), **BATCH)
               for s in {s for p in PAIRS for s in p}}
    task_j = flagship_task_jax(compute_dtype=jnp.float32, optimizer_2d=OPTIMIZER,
                               optimizer_3d=OPTIMIZER, **SMALL)
    task_j.tx2d, task_j.tx3d = _capture(task_j.tx2d), _capture(task_j.tx3d)
    state = task_j.init_state(jax.random.PRNGKey(0), jax_batch(batches[0]))
    params2d = _biases_near_one(state.params2d, 3)
    state = state.replace(params2d=params2d, opt2d=task_j.tx2d.init(params2d),
                          stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    init = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                            state.params3d, state.stats3d))
    logs_j, grads_j = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        step = jax.jit(task_j.train_step)
        for i, (s, t) in enumerate(PAIRS):
            state, logs = step(state, jax_batch(batches[s]), jax_batch(batches[t]),
                               jax.random.PRNGKey(7))
            logs_j.append({k: float(v) for k, v in logs.items()})
            if i == 0:
                grads_j = (to_numpy_tree(state.opt2d[0]),
                           to_numpy_tree(state.opt3d[0]))
    final_j = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                               state.params3d, state.stats3d))

    task = flagship_task(compute_dtype=torch.float32, optimizer_2d=OPTIMIZER,
                         optimizer_3d=OPTIMIZER, device="cpu", **SMALL)
    task.load_flax(*init)
    for enc in (task.model2d.rgb_backbone, task.model2d.depth_backbone):
        enc.dropout_rate = 0.0
    gen = torch.Generator().manual_seed(0)
    logs_t, grads_t = [], None
    for i, (s, t) in enumerate(PAIRS):
        logs = task.train_step(make_batch(np.random.RandomState(s), **BATCH),
                               make_batch(np.random.RandomState(t), **BATCH), gen)
        logs_t.append({k: float(v) for k, v in logs.items()})
        if i == 0:
            p2, _, p3, _ = to_flax(
                {n: p.grad for n, p in task.model2d.named_parameters()},
                {n: p.grad for n, p in task.model3d.named_parameters()})
            grads_t = (p2, p3)
    final_t = to_flax(task.model2d.state_dict(), task.model3d.state_dict())
    return dict(logs=(logs_t, logs_j), grads=(grads_t, grads_j),
                final=(final_t, final_j))


def test_train_logs_match_jax(trajectories):
    logs_t, logs_j = trajectories["logs"]
    for step, (lt, lj) in enumerate(zip(logs_t, logs_j)):
        assert set(lt) == set(lj), step
        assert lt["train/nbr_slot_overflow"] == lj["train/nbr_slot_overflow"] == 0
        assert lt["train/voxel_overflow_levels"] == lj["train/voxel_overflow_levels"] == 0
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=REL, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")


@pytest.mark.parametrize("branch", ["2d", "3d"])
def test_step1_gradients_match_jax(trajectories, branch):
    (g2t, g3t), (g2j, g3j) = trajectories["grads"]
    ours, ref = (_flat(g2t), _flat(g2j)) if branch == "2d" else (_flat(g3t), _flat(g3j))
    assert set(ours) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        if k in BN_SHADOWED:
            assert np.abs(ours[k]).max() <= 1e-6 * scale, k
            assert np.abs(ref[k]).max() <= 1e-6 * scale, k
            continue
        np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                   atol=REL * float(np.abs(ref[k]).max()), err_msg=k)


@pytest.mark.parametrize("part", ["params2d", "stats2d", "params3d", "stats3d"])
def test_weights_and_stats_after_three_steps_match_jax(trajectories, part):
    final_t, final_j = trajectories["final"]
    i = ("params2d", "stats2d", "params3d", "stats3d").index(part)
    ours, ref = _flat(final_t[i]), _flat(final_j[i])
    assert set(ours) == set(ref) and ref
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                   atol=REL * float(np.abs(ref[k]).max()), err_msg=k)
