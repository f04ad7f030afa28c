"""The training options of mm2d3d_tpu_torch against the JAX package's, fp32
on the CPU: `accumulate_steps` (optax.MultiSteps), `frozen_batch_norm`
(the RGB stem and encoder) and `residual_blocks` (the sparse U-Net).

One JAX task with all three (SGD with momentum 0.9, accumulate_steps=2 on
both branches) and the port's from the same flax weights (`from_flax`:
random running and frozen statistics, the 2D branch's 1-D leaves near 1 as
in tests/test_torch_train.py), dropout off on both sides, four train steps
(two updates) over two batch pairs.  Held:
- every train log at each step within 1e-4 relative;
- the gradients of step 1 (the accumulators after it) per leaf within
  1e-4 * max|leaf|, the BatchNorm-shadowed biases below 1e-6 of the
  branch's largest (see tests/test_torch_train.py);
- the parameters after the two updates within 1e-5 * max|leaf|, the
  running statistics within 1e-4 * max|leaf|;
- on the port's side: the parameters untouched by the odd steps, and the
  eval forward of the same weights within rtol 1e-3, atol 1e-4 of JAX's.
Port only: the new leaves' `to_flax` / `from_flax` round trip, the CLI's
acceptance of all three options, and a run resumed between two micro-steps
bit-identical to the uninterrupted one.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_batch, randomize_stats, t2n, to_numpy_tree
from _torch_port import two_threads  # noqa: F401  (fixture)
from test_torch_slice import _jax_forward
from test_torch_train import BN_SHADOWED, _biases_near_one, _flat
from test_torch_trainer import Recorder, _differing, loaders
from test_torch_trainer import nusc, tmp_path, workspace  # noqa: F401  (fixtures)

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.models.convert import from_flax, to_flax
from mm2d3d_tpu_torch.train.optim import MultiSteps
from mm2d3d_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.usefixtures("two_threads")

SMALL = dict(full_scale=256, num_planes=3, m=8)
OPTIONS = dict(frozen_batch_norm=True, residual_blocks=True)
BATCH = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256,
             wire=True)
PAIRS = ((0, 1), (2, 3), (0, 1), (2, 3))  # (source seed, target seed) per step
OPTIMIZER = {"name": "sgd", "lr": 1e-2, "momentum": 0.9, "accumulate_steps": 2}
REL = 1e-4


@pytest.fixture(scope="module")
def runs():
    batches = {s: make_batch_jax(np.random.RandomState(s), **BATCH)
               for s in {s for p in PAIRS for s in p}}
    task_j = flagship_task_jax(compute_dtype=jnp.float32, optimizer_2d=OPTIMIZER,
                               optimizer_3d=OPTIMIZER, **OPTIONS, **SMALL)
    state = task_j.init_state(jax.random.PRNGKey(0), jax_batch(batches[0]))
    params2d = _biases_near_one(state.params2d, 3)
    state = state.replace(params2d=params2d, opt2d=task_j.tx2d.init(params2d),
                          stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    init = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                            state.params3d, state.stats3d))
    fwd_j = jax.jit(lambda s, b: _jax_forward(task_j, s, b))(
        state, jax_batch(batches[0]))
    fwd_j = {k: np.asarray(v) for k, v in fwd_j.items()}
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
                grads_j = (to_numpy_tree(state.opt2d.acc_grads),
                           to_numpy_tree(state.opt3d.acc_grads))
    final_j = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                               state.params3d, state.stats3d))

    task = flagship_task(compute_dtype=torch.float32, optimizer_2d=OPTIMIZER,
                         optimizer_3d=OPTIMIZER, device="cpu", **OPTIONS, **SMALL)
    task.load_flax(*init)
    fwd = {k: t2n(v) for k, v in task.forward(make_batch(np.random.RandomState(0),
                                                         **BATCH)).items()}
    for enc in (task.model2d.rgb_backbone, task.model2d.depth_backbone):
        enc.dropout_rate = 0.0
    gen = torch.Generator().manual_seed(0)
    logs_t, grads_t, moved = [], None, []
    for i, (s, t) in enumerate(PAIRS):
        before = [p.detach().clone() for net in (task.model2d, task.model3d)
                  for p in net.parameters()]
        logs = task.train_step(make_batch(np.random.RandomState(s), **BATCH),
                               make_batch(np.random.RandomState(t), **BATCH), gen)
        after = [p for net in (task.model2d, task.model3d) for p in net.parameters()]
        moved.append(sum(not torch.equal(a, b) for a, b in zip(before, after)))
        logs_t.append({k: float(v) for k, v in logs.items()})
        if i == 0:
            # copies: `to_flax` shares the CPU tensors' memory, and the next
            # step clears the accumulators in place
            p2, _, p3, _ = to_flax(*(
                {n: a.clone() for (n, _), a in zip(net.named_parameters(), opt.acc)}
                for net, opt in ((task.model2d, task.opt2d), (task.model3d, task.opt3d))))
            grads_t = (p2, p3)
    final_t = to_flax(task.model2d.state_dict(), task.model3d.state_dict())
    return dict(logs=(logs_t, logs_j), grads=(grads_t, grads_j),
                final=(final_t, final_j), forward=(fwd, fwd_j), moved=moved,
                task=task)


def test_option_train_logs_match_jax(runs):
    logs_t, logs_j = runs["logs"]
    assert len(logs_t) == len(PAIRS)
    for step, (lt, lj) in enumerate(zip(logs_t, logs_j)):
        assert set(lt) == set(lj), step
        assert lt["train/nbr_slot_overflow"] == lj["train/nbr_slot_overflow"] == 0
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=REL, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")


@pytest.mark.parametrize("branch", ["2d", "3d"])
def test_option_step1_gradients_match_jax(runs, branch):
    (g2t, g3t), (g2j, g3j) = runs["grads"]
    ours, ref = (_flat(g2t), _flat(g2j)) if branch == "2d" else (_flat(g3t), _flat(g3j))
    assert set(ours) == set(ref)
    assert any("bn_scale" in k for k in ref) if branch == "2d" else any(
        "nin_kernel" in k for k in ref)
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
def test_option_state_after_two_updates_matches_jax(runs, part):
    final_t, final_j = runs["final"]
    i = ("params2d", "stats2d", "params3d", "stats3d").index(part)
    ours, ref = _flat(final_t[i]), _flat(final_j[i])
    assert set(ours) == set(ref) and ref
    rel = 1e-5 if part.startswith("params") else REL
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                   atol=rel * float(np.abs(ref[k]).max()), err_msg=k)


def test_parameters_move_once_per_two_steps(runs):
    task = runs["task"]
    assert isinstance(task.opt2d, MultiSteps) and isinstance(task.opt3d, MultiSteps)
    assert task.opt2d.mini_step == task.opt3d.mini_step == 0 and task.step == 4
    moved = runs["moved"]
    assert moved[0] == moved[2] == 0 and min(moved[1], moved[3]) > 100, moved


def test_option_eval_forward_matches_jax(runs):
    ours, ref = runs["forward"]
    for name in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_new_leaves_round_trip_through_flax():
    task = flagship_task(compute_dtype=torch.float32, device="cpu", **OPTIONS, **SMALL)
    task.init_params(torch.Generator().manual_seed(2))
    sd2, sd3 = task.model2d.state_dict(), task.model3d.state_dict()
    p2, s2, p3, s3 = to_flax(sd2, sd3)
    assert "bn_scale" in p2["stem_rgb"] and "bn_mean" in s2["stem_rgb"]
    assert set(p2["rgb_backbone"]["layer1_0"]["cb1"]) == {"conv", "bn_scale", "bn_bias"}
    assert "bn" in p2["stem_depth"]  # the depth branch keeps trained BatchNorms
    dec = p3["net_3d"]["unet"]["dec_0_0"]
    assert {"nin_kernel", "bn1", "conv1", "bn2", "conv2"} <= set(dec)
    back2, back3 = from_flax(p2, s2, p3, s3)
    for sd, back in ((sd2, back2), (sd3, back3)):
        assert set(sd) == set(back)
        for k in sd:
            assert torch.equal(sd[k], back[k]), k


def test_cli_accepts_the_training_options(workspace):  # noqa: F811
    from mm2d3d_tpu_torch.models.resnet2d import ConvBN
    from mm2d3d_tpu_torch.models.sparse_unet import ResidualBlock
    from mm2d3d_tpu_torch.run import main

    trainer, results = main([
        "--config", str(workspace / "configs" / "config.yaml"), "--device", "cpu",
        "models.net2d.frozen_batch_norm=true",
        "models.net3d.backbone_3d.residual_blocks=true",
        "models.net2d.optimizer.accumulate_steps=2",
        "models.net3d.optimizer.accumulate_steps=2"])
    task = trainer.task
    assert trainer.global_step == 2 and task.step == 2
    assert all(m.frozen for m in task.model2d.rgb_backbone.modules()
               if isinstance(m, ConvBN))
    assert any(isinstance(m, ResidualBlock) for m in task.model3d.modules())
    for opt in (task.opt2d, task.opt3d):
        assert isinstance(opt, MultiSteps) and opt.k == 2 and opt.mini_step == 0
    assert np.isfinite(list(results.values())).all()


ACCUM = {"name": "adamw", "lr": 1e-3, "accumulate_steps": 2, "lr_scheduler": {
    "name": "one_cycle", "max_lr": 5e-3, "total_steps": 3}}


def _accum_trainer(nusc, ckpt_dir, max_epochs, logger):  # noqa: F811
    """Without eval loaders: each epoch ends by saving `last` only."""
    task = flagship_task(compute_dtype=torch.float32, optimizer_2d=ACCUM,
                         optimizer_3d=ACCUM, device="cpu", **OPTIONS, **SMALL)
    lo = loaders(nusc)
    return Trainer(task, lo[0], lo[1], ckpt_dir=str(ckpt_dir),
                   max_epochs=max_epochs, logger=logger, seed=5)


def test_resume_between_micro_steps_is_bit_identical(nusc, tmp_path):  # noqa: F811
    """Epoch 0 ends after 3 steps, between two micro-steps (its `last`
    holds one step's gradients); a trainer resumed from it runs steps 4-6
    as one trainer that ran both epochs does, bit for bit."""
    whole_log = Recorder()
    whole = _accum_trainer(nusc, tmp_path / "whole", 2, whole_log)
    whole.fit()
    first = _accum_trainer(nusc, tmp_path / "split", 1, Recorder())
    first.fit()
    assert first.global_step == 3 and first.task.opt2d.mini_step == 1
    resumed_log = Recorder()
    resumed = _accum_trainer(nusc, tmp_path / "split", 2, resumed_log)
    resumed.init_or_resume(resume=True)
    assert resumed.task.opt2d.mini_step == resumed.task.opt3d.mini_step == 1
    assert any(bool(a.any()) for a in resumed.task.opt3d.acc)
    resumed.fit(resume=True)
    assert [s for s, _ in resumed_log.train_logs()] == [4, 5, 6]
    assert resumed_log.train_logs() == whole_log.train_logs()[3:]
    assert not _differing(resumed, whole)
