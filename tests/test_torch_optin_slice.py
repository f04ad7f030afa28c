"""The opt-in paths as a whole: the fused 2D head (K5) and the dense 27-tap
submanifold convolutions (K6) on every level, reached as in the JAX
package, by a precomputed topology without slot tables
(`build_topology(..., slot_caps=None)`, handed to `eval_step(topo=...)` and
`train_step(..., topo_src, topo_trg)`) and a fused-head 2D net.  The port
against the JAX task with `model2d.clone(pallas_head=True)`, fp32 on the
CPU, on bridged weights and the same make_batch seeds.

Tolerances are the existing slice tests': the eval slice as
tests/test_torch_slice.py (logits rtol 1e-3, atol 1e-4; losses rel 1e-5;
confusion matrices equal off the near-ties), at a cropped image (height 30,
padded to 32); three SGD train steps with dropout off as
tests/test_torch_train.py, on its batches (height 32): logs 1e-4 relative,
step-1 gradients and the weights after three steps within 1e-4 * max|leaf|,
the seven BN-shadowed biases below 1e-6 of the branch's largest gradient.
At height 30 one leaf (rgb_backbone/layer1_0/cb1/bn/bias) differs by
2.8e-4 of its own maximum with the fused head and with the unfused one
alike: the crop's conditioning, which tests/test_torch_head2d.py holds at
the branch's scale instead.

Also: the entry points run on the CUDA device unless told otherwise, and
raise where there is none.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_batch, near_tie, randomize_stats, t2n, to_numpy_tree
from test_torch_train import BATCH as TRAIN_BATCH
from test_torch_train import (BN_SHADOWED, OPTIMIZER, PAIRS, REL, _biases_near_one,
                              _capture, _flat)

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu.train.batch import build_topology as build_topology_jax
from mm2d3d_tpu.train.step import EvalMetrics as EvalMetricsJax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.models.convert import to_flax
from mm2d3d_tpu_torch.models.net2d import Net2DSeg
from mm2d3d_tpu_torch.train.batch import build_topology
from mm2d3d_tpu_torch.train.metrics import confusion_matrix_update
from mm2d3d_tpu_torch.train.step import EvalMetrics, MM2D3DTask

SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=30, width=48, n_points=128, full_scale=256,
             wire=True)


def _jax_task(**kw):
    task = flagship_task_jax(compute_dtype=jnp.float32, **kw, **SMALL)
    task.model2d = task.model2d.clone(pallas_head=True)
    return task


def _jax_dense_topo(batch_j):
    return jax.jit(lambda b: build_topology_jax(b, 256, 3, slot_caps=None))(batch_j)


def _port_task(**kw):
    return flagship_task(compute_dtype=torch.float32, device="cpu",
                         model2d=Net2DSeg(6, torch.float32, fused_head=True),
                         **kw, **SMALL)


def _dense_topo(batch):
    topo = build_topology(batch, 256, 3, slot_caps=None)
    assert all(lvl.slot_src is None and lvl.slot_overflow is None
               for lvl in topo[1].levels)
    return topo


def test_optin_eval_slice_matches_jax():
    task_j = _jax_task()
    batch_j = jax_batch(make_batch_jax(np.random.RandomState(0), **BATCH))
    state = task_j.init_state(jax.random.PRNGKey(0), batch_j)
    state = state.replace(stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    metrics_j, logs_j = jax.jit(task_j.eval_step)(
        state, batch_j, EvalMetricsJax.create(task_j.num_classes),
        _jax_dense_topo(batch_j))

    task = _port_task()
    task.load_flax(to_numpy_tree(state.params2d), to_numpy_tree(state.stats2d),
                   to_numpy_tree(state.params3d), to_numpy_tree(state.stats3d))
    batch = make_batch(np.random.RandomState(0), **BATCH)
    topo = _dense_topo(batch)
    metrics, logs = task.eval_step(batch, topo=topo)
    fwd = task.forward(batch, topo=topo)
    for name in ("loss_segmentation", "loss_segmentation_3d", "valid_weight"):
        np.testing.assert_allclose(float(logs[name]), float(logs_j[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(logs["nbr_slot_overflow"]) == float(logs_j["nbr_slot_overflow"]) == 0
    assert set(logs) == set(logs_j)

    # logits: the port's forward vs the JAX nets applied the way eval_step
    # applies them, on the JAX dense topology
    from mm2d3d_tpu.train.batch import prepare_device_batch as prepare_jax

    def fwd_j(s, b, topo_j):
        b = prepare_jax(b)
        p2, _, _, _ = task_j._fwd2d(s.params2d, s.stats2d, b, False)
        p3, _, _, _ = task_j._fwd3d(s.params3d, s.stats3d, b, *topo_j, False)
        sm2 = jax.nn.softmax(p2["seg_logit"].reshape(-1, 6), -1)
        sm3 = jax.nn.softmax(p3["seg_logit"], -1)
        return {"seg_logit_2d": p2["seg_logit"], "seg_logit_3d": p3["seg_logit"],
                "ensemble": (sm2 + sm3) / 2}

    out_j = jax.jit(fwd_j)(state, batch_j, _jax_dense_topo(batch_j))
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        assert tuple(fwd[name].shape) == out_j[name].shape, name
        np.testing.assert_allclose(t2n(fwd[name]), np.asarray(out_j[name]),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    flat_j = {
        "cm_2d": (t2n(fwd["seg_logit_2d"]).reshape(-1, 6),
                  np.asarray(out_j["seg_logit_2d"]).reshape(-1, 6)),
        "cm_3d": (t2n(fwd["seg_logit_3d"]), np.asarray(out_j["seg_logit_3d"])),
        "cm_avg": (t2n(fwd["ensemble"]), np.asarray(out_j["ensemble"])),
    }
    labels = batch.seg_label.reshape(-1)
    mask = batch.point_mask.reshape(-1)
    for name, (ours, ref) in flat_j.items():
        tie = near_tie(ours) | near_tie(ref)
        keep = mask & torch.from_numpy(~tie)
        zero = torch.zeros((6, 6), dtype=torch.int32)
        cm_ours = confusion_matrix_update(zero, torch.from_numpy(ours.argmax(-1)),
                                          labels, keep)
        cm_ref = confusion_matrix_update(zero, torch.from_numpy(ref.argmax(-1)),
                                         labels, keep)
        np.testing.assert_array_equal(t2n(cm_ours), t2n(cm_ref), err_msg=name)
        if not tie[t2n(mask)].any():
            np.testing.assert_array_equal(t2n(getattr(metrics, name)),
                                          np.asarray(getattr(metrics_j, name)),
                                          err_msg=name)
    assert int(metrics.cm_avg.sum()) == int(np.asarray(metrics_j.cm_avg).sum())


@pytest.fixture(scope="module")
def trajectories():
    batches = {s: make_batch_jax(np.random.RandomState(s), **TRAIN_BATCH)
               for s in {s for p in PAIRS for s in p}}
    task_j = _jax_task(optimizer_2d=OPTIMIZER, optimizer_3d=OPTIMIZER)
    task_j.tx2d, task_j.tx3d = _capture(task_j.tx2d), _capture(task_j.tx3d)
    state = task_j.init_state(jax.random.PRNGKey(0), jax_batch(batches[0]))
    params2d = _biases_near_one(state.params2d, 3)
    state = state.replace(params2d=params2d, opt2d=task_j.tx2d.init(params2d),
                          stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    init = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                            state.params3d, state.stats3d))
    topos_j = {s: _jax_dense_topo(jax_batch(b)) for s, b in batches.items()}
    logs_j, grads_j = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        step = jax.jit(task_j.train_step)
        for i, (s, t) in enumerate(PAIRS):
            state, logs = step(state, jax_batch(batches[s]), jax_batch(batches[t]),
                               jax.random.PRNGKey(7), topos_j[s], topos_j[t])
            logs_j.append({k: float(v) for k, v in logs.items()})
            if i == 0:
                grads_j = (to_numpy_tree(state.opt2d[0]),
                           to_numpy_tree(state.opt3d[0]))
    final_j = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                               state.params3d, state.stats3d))

    task = _port_task(optimizer_2d=OPTIMIZER, optimizer_3d=OPTIMIZER)
    task.load_flax(*init)
    for enc in (task.model2d.rgb_backbone, task.model2d.depth_backbone):
        enc.dropout_rate = 0.0
    gen = torch.Generator().manual_seed(0)
    logs_t, grads_t = [], None
    for i, (s, t) in enumerate(PAIRS):
        src, trg = (make_batch(np.random.RandomState(x), **TRAIN_BATCH)
                    for x in (s, t))
        with torch.no_grad():
            topo_src, topo_trg = _dense_topo(src), _dense_topo(trg)
        logs = task.train_step(src, trg, gen, topo_src=topo_src, topo_trg=topo_trg)
        logs_t.append({k: float(v) for k, v in logs.items()})
        if i == 0:
            p2, _, p3, _ = to_flax(
                {n: p.grad for n, p in task.model2d.named_parameters()},
                {n: p.grad for n, p in task.model3d.named_parameters()})
            grads_t = (p2, p3)
    final_t = to_flax(task.model2d.state_dict(), task.model3d.state_dict())
    return dict(logs=(logs_t, logs_j), grads=(grads_t, grads_j),
                final=(final_t, final_j))


def test_optin_train_logs_match_jax(trajectories):
    logs_t, logs_j = trajectories["logs"]
    for step, (lt, lj) in enumerate(zip(logs_t, logs_j)):
        assert set(lt) == set(lj), step
        assert lt["train/nbr_slot_overflow"] == lj["train/nbr_slot_overflow"] == 0
        assert lt["train/voxel_overflow_levels"] == lj["train/voxel_overflow_levels"] == 0
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=REL, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")


@pytest.mark.parametrize("branch", ["2d", "3d"])
def test_optin_step1_gradients_match_jax(trajectories, branch):
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
def test_optin_weights_after_three_steps_match_jax(trajectories, part):
    final_t, final_j = trajectories["final"]
    i = ("params2d", "stats2d", "params3d", "stats3d").index(part)
    ours, ref = _flat(final_t[i]), _flat(final_j[i])
    assert set(ours) == set(ref) and ref
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                   atol=REL * float(np.abs(ref[k]).max()), err_msg=k)


ENTRY_POINTS = {
    "MM2D3DTask": lambda **kw: MM2D3DTask(num_classes=6, full_scale=256, num_planes=3,
                                          m=8, **kw).device,
    "flagship_task": lambda **kw: flagship_task(**kw).device,
    "EvalMetrics.create": lambda **kw: EvalMetrics.create(6, **kw).cm_2d.device,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry):
    """Without a device argument an entry point takes the CUDA device, and
    raises where there is none; device="cpu" runs on the CPU."""
    fn = ENTRY_POINTS[entry]
    if torch.cuda.is_available():
        assert fn().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert fn(device="cpu").type == "cpu"
