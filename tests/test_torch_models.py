"""Models of mm2d3d_tpu_torch vs the flax models of the JAX package, eval
forward in fp32 with bridged weights and random running statistics.

3D: rtol 1e-4, atol 1e-5 (sums in another order through ~10 sparse convs).
2D: rtol 1e-3, atol 1e-4, as tests/test_models2d.py holds the flax net
against torch: a deep conv stack, oneDNN vs XLA:CPU summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_batch, randomize_stats, t2n, to_numpy_tree

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.models.net2d import Net2DSeg as Net2DSegJax
from mm2d3d_tpu.models.sparse_unet import Net3DSeg as Net3DSegJax
from mm2d3d_tpu.ops.pallas.maxpool import _ref_pool
from mm2d3d_tpu.train.batch import build_topology as build_topology_jax
from mm2d3d_tpu.train.batch import flatten_points as flatten_points_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.models.convert import from_flax, to_flax
from mm2d3d_tpu_torch.models.net2d import Net2DSeg
from mm2d3d_tpu_torch.models.sparse_unet import Net3DSeg
from mm2d3d_tpu_torch.ops.kernels.maxpool import maxpool3x3s2, maxpool3x3s2_ref
from mm2d3d_tpu_torch.train.batch import build_topology, flatten_points

NC = 6


@pytest.mark.parametrize("shape", [(2, 16, 20, 64), (1, 9, 13, 8), (2, 7, 5, 3)])
def test_maxpool_plain_version_matches_ref_pool(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(_ref_pool(jnp.asarray(x)))
    for fn in (maxpool3x3s2_ref, maxpool3x3s2):
        out = fn(torch.from_numpy(x))
        assert out.shape == ref.shape and out.is_contiguous()
        np.testing.assert_array_equal(t2n(out), ref)


DRYRUN = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256)


@pytest.fixture(scope="module")
def net3d():
    model = Net3DSegJax(num_classes=NC, m=8, full_scale=256, num_planes=3,
                        compute_dtype=jnp.float32)
    batch = jax_batch(make_batch_jax(np.random.RandomState(0), **DRYRUN))
    grid, hier = jax.jit(lambda b: build_topology_jax(b, 256, 3))(batch)
    _, feats, _, _, _ = flatten_points_jax(batch)
    variables = jax.jit(lambda f, g, h: model.init(
        jax.random.PRNGKey(0), f, g, h, False))(feats, grid, hier)
    params = to_numpy_tree(variables["params"])
    stats = randomize_stats(variables["batch_stats"], 1)
    ref = jax.jit(lambda f, g, h: model.apply(
        {"params": params, "batch_stats": stats}, f, g, h, False))(feats, grid, hier)
    return params, stats, ref


@pytest.fixture(scope="module")
def net2d():
    r = np.random.RandomState(2)
    b, h, w, n = 2, 33, 48, 25  # odd H exercises the pad-to-16 crop
    img = r.rand(b, h, w, 3).astype(np.float32)
    depth = r.rand(b, h, w, 1).astype(np.float32)
    idx = np.stack([r.randint(-2, h + 2, (b, n)), r.randint(-2, w + 2, (b, n))],
                   -1).astype(np.int32)  # out-of-image indices are clamped
    mask = r.rand(b, n) < 0.8
    model = Net2DSegJax(num_classes=NC, compute_dtype=jnp.float32)
    args = tuple(jnp.asarray(a) for a in (img, depth, idx, mask))
    variables = jax.jit(lambda *a: model.init(jax.random.PRNGKey(0), *a, False)
                        )(*args)
    params = to_numpy_tree(variables["params"])
    stats = randomize_stats(variables["batch_stats"], 2)
    ref = jax.jit(lambda *a: model.apply(
        {"params": params, "batch_stats": stats}, *a, False,
        with_features=False))(*args)
    return (img, depth, idx, mask), params, stats, ref


def test_net3dseg_eval_matches_flax(net3d):
    params, stats, (preds, point_out, aux) = net3d
    model = Net3DSeg(NC, m=8, num_planes=3, compute_dtype=torch.float32).eval()
    model.load_state_dict(from_flax({}, {}, params, stats)[1], strict=True)
    batch = make_batch(np.random.RandomState(0), **DRYRUN)
    grid, hier = build_topology(batch, 256, 3)
    _, feats, _, _, _ = flatten_points(batch)
    with torch.inference_mode():
        p, po, a = model(feats, grid, hier)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t2n(p["seg_logit"]), np.asarray(preds["seg_logit"]), **tol)
    np.testing.assert_allclose(t2n(p["confidence"]), np.asarray(preds["confidence"]), **tol)
    np.testing.assert_allclose(t2n(po), np.asarray(point_out), **tol)
    np.testing.assert_allclose(t2n(a["seg_logit_point"]),
                               np.asarray(aux["seg_logit_point"]), **tol)


def test_net2dseg_eval_matches_flax(net2d):
    (img, depth, idx, mask), params, stats, (preds, _, aux) = net2d
    model = Net2DSeg(NC, compute_dtype=torch.float32).eval()
    model.load_state_dict(from_flax(params, stats, {}, {})[0], strict=True)
    with torch.inference_mode():
        p, segm_last, a = model(*(torch.from_numpy(x) for x in (img, depth, idx, mask)))
    assert segm_last is None
    tol = dict(rtol=1e-3, atol=1e-4)
    for name, ours, ref in (
        ("seg_logit_2d", p["seg_logit_2d"], preds["seg_logit_2d"]),
        ("seg_logit", p["seg_logit"], preds["seg_logit"]),
        ("seg_logit_avg_2d", a["seg_logit_avg_2d"], aux["seg_logit_avg_2d"]),
        ("seg_logit_avg", a["seg_logit_avg"], aux["seg_logit_avg"]),
    ):
        assert tuple(ours.shape) == ref.shape, name
        np.testing.assert_allclose(t2n(ours), np.asarray(ref), err_msg=name, **tol)


def test_bridge_uses_every_leaf_once_and_fills_every_tensor(net2d, net3d):
    _, p2, s2, _ = net2d
    p3, s3, _ = net3d
    sd2, sd3 = from_flax(p2, s2, p3, s3)
    n_leaves = lambda t: len(jax.tree_util.tree_leaves(t))  # noqa: E731
    assert len(sd2) == n_leaves(p2) + n_leaves(s2)
    assert len(sd3) == n_leaves(p3) + n_leaves(s3)
    m2 = Net2DSeg(NC, compute_dtype=torch.float32)
    m3 = Net3DSeg(NC, m=8, num_planes=3, compute_dtype=torch.float32)
    assert set(sd2) == set(m2.state_dict())
    assert set(sd3) == set(m3.state_dict())
    for sd, m in ((sd2, m2), (sd3, m3)):
        for k, v in m.state_dict().items():
            assert tuple(sd[k].shape) == tuple(v.shape), k


def test_to_flax_inverts_from_flax(net2d, net3d):
    """to_flax(from_flax(t)) == t, leaf by leaf, for both branches."""
    _, p2, s2, _ = net2d
    p3, s3, _ = net3d
    back = to_flax(*from_flax(p2, s2, p3, s3))
    for ours, ref in zip(back, (p2, s2, p3, s3)):
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_net2dseg_train_gradients_match_flax(net2d, monkeypatch):
    """Train mode (batch statistics; dropout off: rate 0 in the port, flax's
    Dropout patched to the identity) at H = 33, which the head crops after
    padding to 48.  Every parameter gradient of sum(lifted logits * cot) vs
    jax.grad, within 1e-3 of the branch's largest gradient, as the eval
    forward is held (oneDNN vs XLA:CPU through a deep conv stack); a deep
    leaf's own maximum is no scale, see chip_smoke.py's phase 7.  The 1-D
    leaves (BN scales and biases, conv biases) are drawn as 1 + 0.1 N(0, 1),
    as in tests/test_torch_train.py: with the init's zero biases, noise of
    1e-6 on the input images alone moves the port's gradient by 1.4e-3 of
    the branch's largest, with them the two packages agree to 1.2e-4."""
    import flax.linen

    (img, depth, idx, mask), params, stats, _ = net2d
    r = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: (1 + 0.1 * r.randn(*x.shape)).astype(np.float32) if x.ndim == 1 else x,
        params)
    cots = [r.randn(2, 25, NC).astype(np.float32) for _ in range(2)]
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    model_j = Net2DSegJax(num_classes=NC, compute_dtype=jnp.float32)
    args = tuple(jnp.asarray(a) for a in (img, depth, idx, mask))

    def loss_j(p):
        (preds, _, aux), _ = model_j.apply(
            {"params": p, "batch_stats": stats}, *args, True, with_features=False,
            mutable=["batch_stats"])
        return (jnp.sum(preds["seg_logit"] * cots[0])
                + jnp.sum(aux["seg_logit_avg"] * cots[1]))

    ref = jax.tree_util.tree_leaves_with_path(jax.jit(jax.grad(loss_j))(params))

    model = Net2DSeg(NC, compute_dtype=torch.float32).train()
    model.load_state_dict(from_flax(params, stats, {}, {})[0], strict=True)
    for enc in (model.rgb_backbone, model.depth_backbone):
        enc.dropout_rate = 0.0
    p, _, a = model(*(torch.from_numpy(x) for x in (img, depth, idx, mask)))
    ((p["seg_logit"] * torch.from_numpy(cots[0])).sum()
     + (a["seg_logit_avg"] * torch.from_numpy(cots[1])).sum()).backward()
    ours = dict(jax.tree_util.tree_leaves_with_path(to_flax(
        {n: q.grad for n, q in model.named_parameters()}, {})[0]))
    assert len(ours) == len(ref)
    scale = max(float(np.abs(g).max()) for _, g in ref)
    for path, g in ref:
        np.testing.assert_allclose(ours[path], np.asarray(g), rtol=0, atol=1e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))
