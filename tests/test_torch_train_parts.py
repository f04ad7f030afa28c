"""The parts of the train step of mm2d3d_tpu_torch vs the JAX package, fp32
on the CPU, inputs from numpy seeds:

- the stem max pool's gradient vs `jax.vjp(_ref_pool)` on an input with
  ties: the same nonzero positions, values within 1e-6 * max;
- train-mode MaskedBatchNorm and BatchNorm2d vs flax: output, running
  statistics after one update, input and parameter gradients within
  1e-5 * max (fp32 sums in another order);
- dropout (flax's form, drawn from a torch.Generator);
- colour jitter (all six op orders) and the uint8 path of
  prepare_device_batch, exact to 1e-6;
- kl_consistency, LossComposer, l1/l2: values and gradients within 1e-6
  relative;
- make_schedule at every step of a 40-step horizon (within 1e-6 of the
  schedule's peak: JAX evaluates it in float32, the port in float64), two
  steps of each optimizer vs optax on a toy tree (rel 1e-6);
- eval -> train -> eval in one process: the eval after training equals the
  eval of a fresh task loaded with the trained weights.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import jax_batch, t2n

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.models.sparse_unet import MaskedBatchNorm as MaskedBatchNormJax
from mm2d3d_tpu.ops.image import apply_color_jitter as jitter_jax
from mm2d3d_tpu.ops.pallas.maxpool import _ref_pool
from mm2d3d_tpu.train import losses as LJ
from mm2d3d_tpu.train import optim as OJ
from mm2d3d_tpu.train.batch import prepare_device_batch as prepare_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.models.resnet2d import BatchNorm2d, dropout
from mm2d3d_tpu_torch.models.sparse_unet import MaskedBatchNorm
from mm2d3d_tpu_torch.ops.image import apply_color_jitter
from mm2d3d_tpu_torch.ops.kernels.maxpool import MaxPool3x3s2
from mm2d3d_tpu_torch.train import losses as L
from mm2d3d_tpu_torch.train import optim as O
from mm2d3d_tpu_torch.train.batch import prepare_device_batch


def _close(ours, ref, rel, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(t2n(ours) if isinstance(ours, torch.Tensor) else ours,
                               ref, rtol=0, atol=rel * float(np.abs(ref).max()),
                               err_msg=name)


def test_maxpool_backward_matches_select_and_scatter(rng):
    # integer-valued and ReLU'd: many ties, including all-zero windows
    x = np.maximum(rng.randint(-3, 4, size=(2, 17, 23, 16)), 0).astype(np.float32)
    g = rng.randn(2, 9, 12, 16).astype(np.float32)
    _, vjp = jax.vjp(_ref_pool, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = MaxPool3x3s2.apply(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(t2n(dx) != 0, ref != 0)
    _close(dx, ref, 1e-6)


def test_masked_batch_norm_train_matches_flax(rng):
    v, c = 300, 12
    x = (rng.randn(v, c) * 2 + 0.5).astype(np.float32)
    valid = rng.rand(v) < 0.8
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
             "var": (0.5 + rng.rand(c)).astype(np.float32)}
    cot = rng.randn(v, c).astype(np.float32)
    m = MaskedBatchNormJax()

    def f(x, p):
        return m.apply({"params": p, "batch_stats": stats}, x, jnp.asarray(valid),
                       True, mutable=["batch_stats"])

    p0 = {"scale": scale, "bias": bias}
    y_j, vjp = jax.vjp(lambda x, p: f(x, p)[0], jnp.asarray(x), p0)
    new_j = f(jnp.asarray(x), p0)[1]["batch_stats"]
    dx_j, dp_j = vjp(jnp.asarray(cot))

    bn = MaskedBatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, torch.from_numpy(valid))
    y.backward(torch.from_numpy(cot))
    _close(y, y_j, 1e-5, "y")
    _close(bn.running_mean, new_j["mean"], 1e-5, "mean")
    _close(bn.running_var, new_j["var"], 1e-5, "var")
    _close(xt.grad, dx_j, 1e-5, "dx")
    _close(bn.weight.grad, dp_j["scale"], 1e-5, "dscale")
    _close(bn.bias.grad, dp_j["bias"], 1e-5, "dbias")


def test_batch_norm_2d_train_matches_flax(rng):
    b, h, w, c = 2, 5, 7, 8
    x = (rng.randn(b, h, w, c) * 3 + 1.0).astype(np.float32)  # NHWC
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(c)).astype(np.float32),
             "var": (0.5 + rng.rand(c)).astype(np.float32)}
    cot = rng.randn(b, h, w, c).astype(np.float32)
    m = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)

    def f(x, p):
        return m.apply({"params": p, "batch_stats": stats}, x,
                       mutable=["batch_stats"])

    p0 = {"scale": scale, "bias": bias}
    y_j, vjp = jax.vjp(lambda x, p: f(x, p)[0], jnp.asarray(x), p0)
    new_j = f(jnp.asarray(x), p0)[1]["batch_stats"]
    dx_j, dp_j = vjp(jnp.asarray(cot))

    bn = BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt).permute(0, 2, 3, 1)
    y.backward(torch.from_numpy(cot))
    _close(y, y_j, 1e-5, "y")
    _close(bn.running_mean, new_j["mean"], 1e-5, "mean")
    _close(bn.running_var, new_j["var"], 1e-5, "var")
    _close(xt.grad.permute(0, 2, 3, 1), dx_j, 1e-5, "dx")
    _close(bn.weight.grad, dp_j["scale"], 1e-5, "dscale")
    _close(bn.bias.grad, dp_j["bias"], 1e-5, "dbias")


def test_dropout_keeps_share_scales_and_repeats():
    x = torch.ones(100_000)
    a = dropout(x, 0.4, torch.Generator().manual_seed(3))
    b = dropout(x, 0.4, torch.Generator().manual_seed(3))
    keep = a != 0
    assert abs(float(keep.float().mean()) - 0.6) < 0.01
    assert torch.allclose(a[keep], torch.full_like(a[keep], 1 / 0.6))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.4, torch.Generator().manual_seed(4)))
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.4, None)


def _jitter_params(rng, b):
    f = rng.uniform(0.6, 1.4, size=(b, 3))
    order = np.arange(b) % 6  # every op order
    return np.concatenate([f, order[:, None]], 1).astype(np.float32)


def test_color_jitter_matches_jax_for_every_order(rng):
    img = rng.rand(6, 9, 11, 3).astype(np.float32)
    params = _jitter_params(rng, 6)
    ref = np.asarray(jitter_jax(jnp.asarray(img), jnp.asarray(params)))
    out = apply_color_jitter(torch.from_numpy(img), torch.from_numpy(params))
    np.testing.assert_allclose(t2n(out), ref, rtol=0, atol=1e-6)
    assert ref.min() == 0.0 and ref.max() == 1.0  # the clip is exercised


def test_prepare_device_batch_jitters_the_uint8_path_only(rng):
    kw = dict(batch_size=6, height=16, width=24, n_points=64, full_scale=256)
    params = _jitter_params(rng, 6)
    wire = dataclasses.replace(make_batch(np.random.RandomState(0), wire=True, **kw),
                               jitter_params=torch.from_numpy(params))
    wire_j = jax_batch(make_batch_jax(np.random.RandomState(0), wire=True, **kw)
                       ).replace(jitter_params=jnp.asarray(params))
    out, ref = prepare_device_batch(wire), prepare_jax(wire_j)
    assert out.jitter_params is None and ref.jitter_params is None
    np.testing.assert_allclose(t2n(out.img), np.asarray(ref.img), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t2n(out.feats), np.asarray(ref.feats), rtol=0, atol=1e-6)

    flt = dataclasses.replace(make_batch(np.random.RandomState(0), **kw),
                              jitter_params=torch.from_numpy(params))
    same = prepare_device_batch(flt)
    assert same.img is flt.img and same.jitter_params is flt.jitter_params


def test_losses_match_jax(rng):
    m, c = 200, 6
    s = rng.randn(m, c).astype(np.float32)
    t = (2 * rng.randn(m, c)).astype(np.float32)
    valid = rng.rand(m) < 0.7
    labels = np.where(rng.rand(m) < 0.1, -100, rng.randint(0, c, m)).astype(np.int32)
    weights = [1.5, 1.0, 2.0, 0.5, 1.2, 0.8]

    st, tt = (torch.from_numpy(a).requires_grad_(True) for a in (s, t))
    kl = L.kl_consistency(st, tt, torch.from_numpy(valid))
    kl.backward()
    kl_j, (ds_j, dt_j) = jax.value_and_grad(LJ.kl_consistency, argnums=(0, 1))(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(valid))
    np.testing.assert_allclose(float(kl.detach()), float(kl_j), rtol=1e-6)
    _close(st.grad, ds_j, 1e-6, "d student")
    assert tt.grad is None and not np.asarray(dt_j).any()  # teacher detached

    cfg = [{"name": "cross_entropy", "weight": 0.7, "args": {"weight": weights}},
           {"name": "cross_entropy"}, {"name": "l1", "weight": 2.0}, "l2"]
    comp, comp_j = L.LossComposer(cfg), LJ.LossComposer(cfg)
    assert comp.targets() == comp_j.targets() == {"segmentation", "depth"}
    assert comp.class_weights() == comp_j.class_weights() == weights
    assert repr(comp) == repr(comp_j)
    st.grad = None
    seg = comp("segmentation", st, torch.from_numpy(labels), torch.from_numpy(valid))
    seg.backward()
    seg_j, ds_j = jax.value_and_grad(
        lambda x: comp_j("segmentation", x, jnp.asarray(labels), jnp.asarray(valid)))(
        jnp.asarray(s))
    np.testing.assert_allclose(float(seg.detach()), float(seg_j), rtol=1e-6)
    _close(st.grad, ds_j, 1e-6, "d segmentation")
    depth = np.where(rng.rand(m) < 0.5, 0, rng.rand(m)).astype(np.float32)
    pred = rng.rand(m).astype(np.float32)
    np.testing.assert_allclose(
        float(comp("depth", torch.from_numpy(pred), torch.from_numpy(depth))),
        float(comp_j("depth", jnp.asarray(pred), jnp.asarray(depth))), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        L.LossComposer(["focal"])


SCHEDULES = {
    "one_cycle": {"name": "one_cycle", "total_steps": 40, "max_lr": 5e-3},
    "step": {"name": "step", "step_size": 7, "gamma": 0.5},
    "multi_step_lr": {"name": "multi_step_lr", "milestones": [5, 12, 30], "gamma": 0.3},
    "cosine_annealing": {"name": "cosine_annealing", "T_max": 25, "eta_min": 1e-5},
    "cyclic": {"name": "cyclic", "max_lr": 4e-3, "step_size_up": 9},
    "constant": {"name": "constant"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax_at_every_step(name):
    ours = O.make_schedule(SCHEDULES[name], 1e-3)
    ref = OJ.make_schedule(SCHEDULES[name], 1e-3)
    opt, sched = O.make_optimizer([torch.nn.Parameter(torch.zeros(1))], "sgd",
                                  lr=1e-3, lr_scheduler=SCHEDULES[name])
    want = [float(ref(s)) if callable(ref) else float(ref) for s in range(40)]
    tol = 1e-6 * max(want)
    for step in range(40):
        got = ours(step) if callable(ours) else ours
        np.testing.assert_allclose(got, want[step], rtol=0, atol=tol,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(opt.param_groups[0]["lr"], want[step], rtol=0,
                                   atol=tol, err_msg=f"LambdaLR step {step}")
        opt.step()
        sched.step()


OPTIMIZERS = {
    "adamw": {"name": "adamw", "lr": 1e-2},
    "adam": {"name": "adam", "lr": 1e-2},
    "sgd": {"name": "sgd", "lr": 1e-1, "momentum": 0.9, "nesterov": True},
    "rmsprop": {"name": "rmsprop", "lr": 1e-2, "momentum": 0.5},
    "rmsprop_plain": {"name": "rmsprop", "lr": 1e-2},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(rng, name):
    """Two steps on a toy tree, gradients of magnitude 0.5 to 1.5; rmsprop's
    also times 1e-3 and 1e-5: at 1e-5, g^2 is 1e-10, below its eps of 1e-8,
    where eps inside or outside the square root changes the step 99-fold."""
    for scale in (1.0, 1e-3, 1e-5) if name.startswith("rmsprop") else (1.0,):
        tree = {"w": rng.randn(4, 3).astype(np.float32),
                "b": rng.randn(3).astype(np.float32)}
        grads = [{k: (np.sign(rng.randn(*v.shape)) * scale * (0.5 + rng.rand(*v.shape))
                      ).astype(np.float32) for k, v in tree.items()}
                 for _ in range(2)]
        tx = OJ.make_optimizer(**OPTIMIZERS[name])
        params = {k: jnp.asarray(v) for k, v in tree.items()}
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
            params = optax.apply_updates(params, upd)

        ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree.items()}
        opt, sched = O.make_optimizer(list(ps.values()), **OPTIMIZERS[name])
        for g in grads:
            for k, p in ps.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
            sched.step()
        for k in tree:
            np.testing.assert_allclose(t2n(ps[k]), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} at scale {scale}")


def test_gradient_accumulation_is_refused():
    """Accumulation itself is ported (tests/test_torch_train_options.py); a
    count that is not an integer >= 1 is refused."""
    for k in (0, 1.5):
        with pytest.raises(ValueError):
            O.make_optimizer([torch.nn.Parameter(torch.zeros(1))], accumulate_steps=k)


def test_eval_train_eval_in_one_process():
    small = dict(compute_dtype=torch.float32, full_scale=256, num_planes=3, m=8,
                 device="cpu")
    kw = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256,
              wire=True)
    src, trg = (make_batch(np.random.RandomState(s), **kw) for s in (0, 1))
    task = flagship_task(**small)
    task.init_params(torch.Generator().manual_seed(0))
    before = task.forward(src)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        logs = task.train_step(src, trg, gen)
        assert all(bool(torch.isfinite(v)) for v in logs.values())
    assert task.step == 2
    after = task.forward(src)
    _, eval_logs = task.eval_step(src)
    assert not torch.equal(after["seg_logit_3d"], before["seg_logit_3d"])

    fresh = flagship_task(**small)
    fresh.model2d.load_state_dict(task.model2d.state_dict())
    fresh.model3d.load_state_dict(task.model3d.state_dict())
    again = fresh.forward(src)
    _, again_logs = fresh.eval_step(src)
    for k in ("seg_logit_2d", "seg_logit_3d", "ensemble"):
        assert torch.equal(after[k], again[k]), k
    for k in eval_logs:
        assert torch.equal(eval_logs[k], again_logs[k]), k
