"""Smaller public functions of mm2d3d_tpu_torch vs the JAX package's, on
the CPU: the reference Net2DSeg checkpoint import, `Loader.iterate`,
`LossComposer.update_loss_params`, `available_models` and `compute_stats`.
"""

import os.path as osp

import jax
import numpy as np
import pytest
import torch
from test_models2d import _TorchRefNet2DSeg
from test_torch_data import _datasets, _loaders, assert_batches_equal
from test_torch_data import jax_numpy_image_ops, nusc  # noqa: F401  (fixtures)

import mm2d3d_tpu.models.registry as registry_jax
from mm2d3d_tpu.data.base import compute_stats as compute_stats_jax
from mm2d3d_tpu.models.net2d import Net2DSeg as Net2DSegJ
from mm2d3d_tpu.models.torch_import import net2dseg_state_dict_to_flax
from mm2d3d_tpu.train.losses import LossComposer as LossComposerJ
from mm2d3d_tpu_torch.data.base import compute_stats
from mm2d3d_tpu_torch.models import registry
from mm2d3d_tpu_torch.models.convert import from_flax
from mm2d3d_tpu_torch.models.net2d import Net2DSeg
from mm2d3d_tpu_torch.models.torch_import import net2dseg_to_port
from mm2d3d_tpu_torch.train.losses import LossComposer

NC = 6
TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_models2d.py:293-303


@pytest.fixture(scope="module")
def reference_net():
    """The reference Net2DSeg's torch twin with random running statistics,
    as tests/test_models2d.py builds it."""
    torch.manual_seed(0)
    twin = _TorchRefNet2DSeg(NC)
    g = torch.Generator().manual_seed(3)
    for m in twin.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return twin.eval()


def test_net2dseg_import_equals_jax_import(reference_net):
    sd = reference_net.state_dict()
    ours = net2dseg_to_port(sd)
    params, stats = net2dseg_state_dict_to_flax(
        {k: v.numpy() for k, v in sd.items()})
    ref = from_flax(params, stats, {}, {})[0]
    assert ours.keys() == ref.keys() == Net2DSeg(NC, torch.float32).state_dict().keys()
    for k, v in ours.items():
        assert v.dtype == torch.float32 and torch.equal(v, ref[k]), k
    # numpy values import the same
    np_ours = net2dseg_to_port({k: v.numpy() for k, v in sd.items()})
    assert all(torch.equal(v, ours[k]) for k, v in np_ours.items())


def test_net2dseg_import_refuses_an_unplaced_key(reference_net):
    sd = dict(reference_net.state_dict())
    sd["dec_conv_stage9.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="dec_conv_stage9.weight"):
        net2dseg_to_port(sd)


def test_net2dseg_import_reads_encoder_prefix(reference_net):
    """The reference Backbone may hold torchvision's net as `.encoder`."""
    sd = {k.replace("rgb_backbone.", "rgb_backbone.encoder.", 1): v
          for k, v in reference_net.state_dict().items()}
    ours, plain = net2dseg_to_port(sd), net2dseg_to_port(reference_net.state_dict())
    assert all(torch.equal(v, plain[k]) for k, v in ours.items())


def test_net2dseg_import_forward_matches_jax_and_reference(reference_net):
    """The imported weights' fp32 forward equals the JAX model's on the JAX
    import and the reference's own graph (tolerance of
    tests/test_models2d.py's full-branch parity test)."""
    rng = np.random.RandomState(0)
    b, h, w, n = 2, 33, 48, 25  # odd H exercises the pad-to-16 crop path
    img = rng.rand(b, h, w, 3).astype(np.float32)
    depth = rng.rand(b, h, w, 1).astype(np.float32)
    idx = np.stack([rng.randint(0, h, (b, n)), rng.randint(0, w, (b, n))],
                   -1).astype(np.int32)
    mask = np.ones((b, n), bool)

    sd = reference_net.state_dict()
    model = Net2DSeg(NC, compute_dtype=torch.float32).eval()
    model.load_state_dict(net2dseg_to_port(sd), strict=True)
    with torch.inference_mode():
        p, _, a = model(*(torch.from_numpy(x) for x in (img, depth, idx, mask)))

    params, stats = net2dseg_state_dict_to_flax({k: v.numpy() for k, v in sd.items()})
    preds, _, aux = Net2DSegJ(num_classes=NC, compute_dtype=jax.numpy.float32).apply(
        {"params": params, "batch_stats": stats}, img, depth, idx, mask, False)
    for name, ours, ref in (
        ("seg_logit_2d", p["seg_logit_2d"], preds["seg_logit_2d"]),
        ("seg_logit", p["seg_logit"], preds["seg_logit"]),
        ("seg_logit_avg", a["seg_logit_avg"], aux["seg_logit_avg"]),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=name, **TOL)

    with torch.no_grad():
        seg2d_t, lift_t, _, auxl_t, _ = reference_net(
            torch.from_numpy(img).permute(0, 3, 1, 2),
            torch.from_numpy(depth).permute(0, 3, 1, 2), torch.from_numpy(idx).long())
    np.testing.assert_allclose(p["seg_logit_2d"].numpy(),
                               seg2d_t.permute(0, 2, 3, 1).numpy(), **TOL)
    np.testing.assert_allclose(p["seg_logit"].reshape(b * n, NC).numpy(),
                               lift_t.numpy(), **TOL)
    np.testing.assert_allclose(a["seg_logit_avg"].reshape(b * n, NC).numpy(),
                               auxl_t.numpy(), **TOL)


@pytest.mark.parametrize("n", [2, 7])
def test_loader_iterate_equals_jax(nusc, n):
    """`iterate(n)` yields the JAX loader's batches; 7 crosses two epoch
    boundaries (5 scans, batch 2, the tail padded: 3 batches per epoch)."""
    loader, loader_j = _loaders(*_datasets(nusc, noisy_rot=0.1, flip_x=0.5,
                                           rot=6.2831, transl=True, fliplr=0.5))
    ours, ref = list(loader.iterate(n)), list(loader_j.iterate(n))
    assert len(ours) == len(ref) == n
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert_batches_equal(a, b, f"batch {i}")
    assert loader.epoch == loader_j.epoch == (n - 1) // 3
    if n > 3:  # a new epoch reshuffles
        assert not torch.equal(ours[0].coords, ours[3].coords)


def test_update_loss_params_equals_jax():
    cfg = [{"name": "cross_entropy", "args": {"weight": [1.0, 2.0, 0.5]}},
           {"name": "l1", "weight": 0.5}]
    ours, ref = LossComposer(cfg), LossComposerJ(cfg)
    for c in (ours, ref):
        c.update_loss_params("cross_entropy", "segmentation", weight=[3.0, 1.0, 2.0])
        c.update_loss_params("cross_entropy", "depth", weight=[9.0, 9.0, 9.0])  # no entry
        c.update_loss_params("l1", "depth", reduction="mean")
    assert ours.class_weights() == ref.class_weights() == [3.0, 1.0, 2.0]
    assert ours._entries == ref._entries
    r = np.random.RandomState(1)
    logits = r.randn(20, 3).astype(np.float32)
    labels = r.randint(0, 3, 20)
    valid = r.rand(20) > 0.2
    got = ours("segmentation", *(torch.from_numpy(x) for x in (logits, labels, valid)))
    want = ref("segmentation", logits, labels, valid)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_available_models():
    ours = registry.available_models()
    assert {"net2d", "net3d"} <= set(ours) and ours == sorted(ours)
    assert {"net2d", "net3d"} <= set(registry_jax.available_models())
    registry.register_model("zz_probe")(object)
    try:
        assert registry.available_models()[-1] == "zz_probe"
    finally:
        del registry._REGISTRY["zz_probe"]


def test_compute_stats_equals_jax(nusc, tmp_path):
    ds, ds_j = _datasets(nusc)
    counts = compute_stats(ds)
    np.testing.assert_array_equal(counts, compute_stats_jax(ds_j))
    assert counts.dtype == np.int64 and counts.shape == (ds.num_classes,)
    assert counts.sum() > 0
    np.testing.assert_array_equal(compute_stats(ds, out_dir=str(tmp_path)), counts)
    assert osp.getsize(tmp_path / "train_usa_stats.png") > 0
