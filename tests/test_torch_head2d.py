"""The fused 2D head of mm2d3d_tpu_torch vs the JAX package: K5's plain
version (the wrapper's CPU route) against the Pallas `head2d` kernel in
interpret mode and against `_head_pool_ref` over the boundary shapes of
tests/test_pallas.py; `HeadPool`'s gradients against `jax.vjp` of
`_head_pool_ref`; `supports`; and `Net2DSeg(fused_head=True)` against flax's
`Net2DSeg(pallas_head=True)` at a cropped image size (height 30, padded to
32: the conv's last real row reads a padded row, not a zero).

fp32 throughout.  Against the interpret-mode kernel rtol/atol 2e-4, as
tests/test_pallas.py holds that kernel to `_head_pool_ref`; against
`_head_pool_ref` itself 1e-5 * max|ref| (the conv's fp32 sums in another
order); the gradients 1e-5 * max|ref|.  The net: the eval forward rtol
1e-3, atol 1e-4 and the train-mode gradients 1e-3 of the branch's largest
gradient, as tests/test_torch_models.py holds the unfused head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import randomize_stats, t2n, to_numpy_tree

from mm2d3d_tpu.models.net2d import Net2DSeg as Net2DSegJax
from mm2d3d_tpu.ops.pallas import head2d as HJ
from mm2d3d_tpu_torch.models.convert import from_flax, to_flax
from mm2d3d_tpu_torch.models.net2d import Net2DSeg
from mm2d3d_tpu_torch.ops.kernels import head2d as H

NC = 6

BOUNDARY = {
    # (b, hp, wp, h_real, w_real, cins, c2), tests/test_pallas.py:135-139
    "odd_crop_both_dims": (1, 48, 32, 37, 25, (8, 16, 8), 8),
    "single_strip_no_crop": (2, 16, 16, 16, 16, (8,), 8),
    "just_past_one_strip": (1, 32, 24, 17, 24, (16, 8), 16),
}


def _head_case(seed, b, hp, wp, cins, c2):
    r = np.random.RandomState(seed)
    xs = [(r.randn(b, hp, wp, c) * 0.5).astype(np.float32) for c in cins]
    w12 = (r.randn(3, 3, sum(cins), c2) * 0.2).astype(np.float32)
    b12 = r.randn(c2).astype(np.float32)
    return xs, w12, b12


@pytest.mark.parametrize("case", sorted(BOUNDARY))
def test_head_pool_plain_version_matches_pallas_interpret(case):
    b, hp, wp, h_real, w_real, cins, c2 = BOUNDARY[case]
    xs, w12, b12 = _head_case(sorted(BOUNDARY).index(case), b, hp, wp, cins, c2)
    j = [jnp.asarray(x) for x in xs]
    ref = np.asarray(HJ._head_pool_ref(j, jnp.asarray(w12), jnp.asarray(b12),
                                       h_real, w_real, jnp.float32))
    w9 = jnp.concatenate([jnp.asarray(w12)[i, k] for i in range(3) for k in range(3)],
                         axis=-1)
    kernel = np.asarray(HJ._head_pool_pallas(j, w9, jnp.asarray(b12), hp, wp,
                                             h_real, w_real, c2, interpret=True))
    t = [torch.from_numpy(x) for x in xs]
    for fn in (H.head_pool_ref, H.head_pool):
        out = fn(t, torch.from_numpy(w12), torch.from_numpy(b12), h_real, w_real)
        assert out.dtype == torch.float32 and out.shape == (b, h_real, w_real, c2)
        np.testing.assert_allclose(t2n(out), kernel, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(t2n(out), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_head_pool_gradients_match_jax_vjp():
    """HeadPool's backward vs jax.vjp(_head_pool_ref) at the shape of
    tests/test_pallas.py's gradient test (crop in both dimensions)."""
    b, hp, wp, h_real, w_real, cins, c2 = 1, 32, 16, 21, 13, (8, 8), 8
    xs, w12, b12 = _head_case(5, b, hp, wp, cins, c2)
    cot = np.random.RandomState(6).randn(b, h_real, w_real, c2).astype(np.float32)
    _, vjp = jax.vjp(
        lambda x, w, bb: HJ._head_pool_ref(list(x), w, bb, h_real, w_real, jnp.float32),
        tuple(jnp.asarray(x) for x in xs), jnp.asarray(w12), jnp.asarray(b12))
    gx, gw, gb = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (w12, b12, *xs)]
    out = H.HeadPool.apply(h_real, w_real, torch.float32, *leaves)
    out.backward(torch.from_numpy(cot))
    for name, ours, ref in zip(("w12", "b12", "x0", "x1"), leaves, (gw, gb, *gx)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t2n(ours.grad), ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=name)


def test_head_pool_rounds_to_the_compute_dtype():
    """fp32 pieces with compute_dtype bf16 give the products of the pieces
    rounded to bf16, summed in fp32: the same as bf16 pieces."""
    xs, w12, b12 = _head_case(7, 2, 16, 24, (8, 8), 8)
    t = [torch.from_numpy(x) for x in xs]
    w, bb = torch.from_numpy(w12), torch.from_numpy(b12)
    rounded = H.head_pool(t, w, bb, 15, 20, torch.bfloat16)
    cast = H.head_pool([x.bfloat16() for x in t], w, bb, 15, 20)
    assert torch.equal(rounded, cast)
    assert not torch.equal(rounded, H.head_pool(t, w, bb, 15, 20))


PACKED = dict(BOUNDARY, c2_20_two_oc_blocks=(1, 32, 40, 30, 33, (24, 8, 16), 20),
              flagship_pieces=(1, 32, 48, 30, 45, (64, 64, 64), 12))


@pytest.mark.parametrize("case", sorted(PACKED))
def test_packed_weights_emulate_the_tensor_core_pass(case):
    """The tensor-core pass's operands, emulated in fp32 on the CPU: each
    piece zero-padded to whole 16-channel chunks and rounded to bf16, the
    packed weights (`pack_weights`, (NB, 9, Kp, 16) bf16) unpacked to HWIO,
    the conv's 16 * NB output channels cut to C2, then bias, crop and pool
    give `head_pool_ref` in bf16 within 1e-5 * max|ref| (fp32 sums in
    another order)."""
    import torch.nn.functional as F

    b, hp, wp, h_real, w_real, cins, c2 = PACKED[case]
    xs, w12, b12 = _head_case(11, b, hp, wp, cins, c2)
    t = [torch.from_numpy(x) for x in xs]
    w, bb = torch.from_numpy(w12), torch.from_numpy(b12)
    wpk = H.pack_weights(w, cins)
    nb = -(-c2 // 16)
    kp = sum(-(-c // 16) * 16 for c in cins)
    assert wpk.shape == (nb, 9, kp, 16) and wpk.dtype == torch.bfloat16
    hwio = wpk.float().permute(1, 2, 0, 3).reshape(3, 3, kp, nb * 16)
    x = torch.cat([F.pad(p, (0, (-p.shape[-1]) % 16)) for p in t], -1)
    x = x.bfloat16().float().permute(0, 3, 1, 2)
    y = F.conv2d(x, hwio.permute(3, 2, 0, 1), padding=1)[:, :c2]
    y = y[:, :, :h_real, :w_real].permute(0, 2, 3, 1) + bb
    out = H._shift_sum5(H._shift_sum5(y, 1), 2) * (1.0 / 25.0)
    ref = H.head_pool_ref(t, w, bb, h_real, w_real, torch.bfloat16)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


SUPPORTS = [  # tests/test_pallas.py:186-190
    (32, 16, 32, 16, 8), (32, 16, 33, 16, 8), (32, 16, 32, 17, 8),
    (24, 16, 24, 16, 8), (32, 16, 0, 16, 8),
]


@pytest.mark.parametrize("args", SUPPORTS)
def test_supports_matches_jax(args):
    assert H.supports(*args) == HJ.supports(*args)


@pytest.fixture(scope="module")
def net2d():
    """Flax Net2DSeg(pallas_head=True) at height 30 (padded to 32), fp32."""
    r = np.random.RandomState(2)
    b, h, w, n = 2, 30, 48, 25
    img = r.rand(b, h, w, 3).astype(np.float32)
    depth = r.rand(b, h, w, 1).astype(np.float32)
    idx = np.stack([r.randint(0, h, (b, n)), r.randint(0, w, (b, n))],
                   -1).astype(np.int32)
    idx[:, 0] = (h - 1, 5)  # a point on the last real row
    mask = r.rand(b, n) < 0.8
    model = Net2DSegJax(num_classes=NC, compute_dtype=jnp.float32, pallas_head=True)
    assert HJ.supports(32, 48, h, w, 2 * NC)
    args = tuple(jnp.asarray(a) for a in (img, depth, idx, mask))
    variables = jax.jit(lambda *a: model.init(jax.random.PRNGKey(0), *a, False))(*args)
    params = to_numpy_tree(variables["params"])
    # 1-D leaves near 1, as tests/test_torch_models.py explains
    params = jax.tree_util.tree_map(
        lambda x: (1 + 0.1 * r.randn(*x.shape)).astype(np.float32) if x.ndim == 1 else x,
        params)
    stats = randomize_stats(variables["batch_stats"], 2)
    return model, (img, depth, idx, mask), params, stats


def test_fused_head_bridge_round_trips(net2d):
    _, _, params, stats = net2d
    model = Net2DSeg(NC, compute_dtype=torch.float32, fused_head=True)
    sd = from_flax(params, stats, {}, {})[0]
    model.load_state_dict(sd, strict=True)
    back = to_flax(model.state_dict(), {})
    for ours, ref in zip(back[:2], (params, stats)):
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)


def test_net2dseg_fused_head_eval_matches_flax(net2d):
    model_j, inputs, params, stats = net2d
    preds_j, _, aux_j = jax.jit(lambda *a: model_j.apply(
        {"params": params, "batch_stats": stats}, *a, False, with_features=False)
    )(*(jnp.asarray(a) for a in inputs))
    model = Net2DSeg(NC, compute_dtype=torch.float32, fused_head=True).eval()
    model.load_state_dict(from_flax(params, stats, {}, {})[0], strict=True)
    with torch.inference_mode():
        p, _, a = model(*(torch.from_numpy(x) for x in inputs))
    for name, ours, ref in (
        ("seg_logit_2d", p["seg_logit_2d"], preds_j["seg_logit_2d"]),
        ("seg_logit", p["seg_logit"], preds_j["seg_logit"]),
        ("seg_logit_avg_2d", a["seg_logit_avg_2d"], aux_j["seg_logit_avg_2d"]),
        ("seg_logit_avg", a["seg_logit_avg"], aux_j["seg_logit_avg"]),
    ):
        assert tuple(ours.shape) == ref.shape, name
        np.testing.assert_allclose(t2n(ours), np.asarray(ref), rtol=1e-3, atol=1e-4,
                                   err_msg=name)


def test_net2dseg_fused_head_train_gradients_match_flax(net2d, monkeypatch):
    """Train mode, dropout off on both sides (rate 0 in the port, flax's
    Dropout patched to the identity); every parameter gradient of
    sum(lifted logits * cot) within 1e-3 of the branch's largest."""
    import flax.linen

    model_j, inputs, params, stats = net2d
    r = np.random.RandomState(3)
    cots = [r.randn(2, 25, NC).astype(np.float32) for _ in range(2)]
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    args = tuple(jnp.asarray(a) for a in inputs)

    def loss_j(p):
        (preds, _, aux), _ = model_j.apply(
            {"params": p, "batch_stats": stats}, *args, True, with_features=False,
            mutable=["batch_stats"])
        return (jnp.sum(preds["seg_logit"] * cots[0])
                + jnp.sum(aux["seg_logit_avg"] * cots[1]))

    ref = jax.tree_util.tree_leaves_with_path(jax.jit(jax.grad(loss_j))(params))

    model = Net2DSeg(NC, compute_dtype=torch.float32, fused_head=True).train()
    model.load_state_dict(from_flax(params, stats, {}, {})[0], strict=True)
    for enc in (model.rgb_backbone, model.depth_backbone):
        enc.dropout_rate = 0.0
    p, _, a = model(*(torch.from_numpy(x) for x in inputs))
    ((p["seg_logit"] * torch.from_numpy(cots[0])).sum()
     + (a["seg_logit_avg"] * torch.from_numpy(cots[1])).sum()).backward()
    ours = dict(jax.tree_util.tree_leaves_with_path(to_flax(
        {n: q.grad for n, q in model.named_parameters()}, {})[0]))
    assert len(ours) == len(ref)
    scale = max(float(np.abs(g).max()) for _, g in ref)
    for path, g in ref:
        np.testing.assert_allclose(ours[path], np.asarray(g), rtol=0, atol=1e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))
