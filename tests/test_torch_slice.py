"""The whole eval slice: mm2d3d_tpu_torch's flagship task vs the JAX one on
the same bridged weights and the same make_batch seed, fp32 on the CPU.

Logits and ensemble: rtol 1e-3, atol 1e-4 (the 2D conv stack's summation
order).  Losses and valid_weight: rel 1e-5.  nbr_slot_overflow equal.
Confusion matrices identical, except points whose top-2 gap is below 1e-3,
which are left out explicitly on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import jax_batch, near_tie, randomize_stats, t2n, to_numpy_tree

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu.train.batch import build_topology as build_topology_jax
from mm2d3d_tpu.train.batch import prepare_device_batch as prepare_jax
from mm2d3d_tpu.train.step import EvalMetrics as EvalMetricsJax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.train.metrics import confusion_matrix_update

SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256,
             wire=True)


def _jax_forward(task, state, batch):
    """The fused forward of __graft_entry__.entry."""
    batch = prepare_jax(batch)
    topo = build_topology_jax(batch, task.full_scale, task.num_planes)
    p2, _, _, _ = task._fwd2d(state.params2d, state.stats2d, batch, False)
    p3, _, _, _ = task._fwd3d(state.params3d, state.stats3d, batch, *topo, False)
    sm2 = jax.nn.softmax(p2["seg_logit"].reshape(-1, task.num_classes), -1)
    sm3 = jax.nn.softmax(p3["seg_logit"], -1)
    return {"seg_logit_2d": p2["seg_logit"], "seg_logit_3d": p3["seg_logit"],
            "ensemble": (sm2 + sm3) / 2}


def test_eval_slice_matches_jax():
    task_j = flagship_task_jax(compute_dtype=jnp.float32, **SMALL)
    batch_j = jax_batch(make_batch_jax(np.random.RandomState(0), **BATCH))
    state = task_j.init_state(jax.random.PRNGKey(0), batch_j)
    state = state.replace(stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    metrics_j, logs_j = jax.jit(task_j.eval_step)(
        state, batch_j, EvalMetricsJax.create(task_j.num_classes))
    fwd_j = jax.jit(lambda s, b: _jax_forward(task_j, s, b))(state, batch_j)

    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.load_flax(to_numpy_tree(state.params2d), to_numpy_tree(state.stats2d),
                   to_numpy_tree(state.params3d), to_numpy_tree(state.stats3d))
    batch = make_batch(np.random.RandomState(0), **BATCH)
    metrics, logs = task.eval_step(batch)
    fwd = task.forward(batch)

    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        assert tuple(fwd[name].shape) == fwd_j[name].shape, name
        np.testing.assert_allclose(t2n(fwd[name]), np.asarray(fwd_j[name]),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    for name in ("loss_segmentation", "loss_segmentation_3d", "valid_weight"):
        np.testing.assert_allclose(float(logs[name]), float(logs_j[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(logs["nbr_slot_overflow"]) == float(logs_j["nbr_slot_overflow"]) == 0
    assert set(logs) == set(logs_j)

    # confusion matrices: equal on every point that is not a near-tie
    labels = batch.seg_label.reshape(-1)
    mask = batch.point_mask.reshape(-1)
    flat = {
        "cm_2d": (t2n(fwd["seg_logit_2d"]).reshape(-1, 6),
                  np.asarray(fwd_j["seg_logit_2d"]).reshape(-1, 6)),
        "cm_3d": (t2n(fwd["seg_logit_3d"]), np.asarray(fwd_j["seg_logit_3d"])),
        "cm_avg": (t2n(fwd["ensemble"]), np.asarray(fwd_j["ensemble"])),
    }
    for name, (ours, ref) in flat.items():
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


def test_iou_matches_jax():
    """Per-class IoU of a confusion matrix with an absent class (which
    scores absent_score) equals the JAX package's; so does the mIoU."""
    from mm2d3d_tpu.train.metrics import iou_per_class as iou_jax
    from mm2d3d_tpu.train.metrics import mean_iou as mean_iou_jax
    from mm2d3d_tpu_torch.train.metrics import iou_per_class, mean_iou

    cm = np.random.RandomState(0).randint(0, 50, (6, 6)).astype(np.int32)
    cm[4, :] = cm[:, 4] = 0
    for score in (0.0, 1.0):
        np.testing.assert_array_equal(
            t2n(iou_per_class(torch.from_numpy(cm), score)),
            np.asarray(iou_jax(jnp.asarray(cm), score)))
    # the fp32 mean of six values may round differently in the last bit
    np.testing.assert_allclose(float(mean_iou(torch.from_numpy(cm))),
                               float(mean_iou_jax(jnp.asarray(cm))), rtol=1e-6)
