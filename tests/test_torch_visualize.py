"""The port's qualitative figures (`utils/visualize.py`, `viz_forward`, the
trainer's `_log_images`, `log_image`) on the CPU.

- `MM2D3DTask.viz_forward` against the JAX `task.viz_forward` on the same
  bridged weights (m=8, 3 planes, full_scale 256, fp32): the argmaxes equal
  except at pixels and real points whose top-two logits lie within 1e-3,
  the confidence within 1e-5.
- The numpy helpers (palettes, `turbo_colormap`, `colorize_labels`,
  `save_point_cloud_ply`) equal to the JAX package's.
- The Pillow figure: five panels under their titles, each point pixel in
  its palette (or turbo) colour, the dense panel the prediction's colours.
- A `Trainer` fit and the CLI write the figures under their names, log
  them (stdout and ``{"step", "image"}`` JSONL lines), draw over the image
  the network consumed (the jittered one), and the CLI prints no note.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_batch, near_tie, randomize_stats, to_numpy_tree
from _torch_port import two_threads  # noqa: F401  (fixture)
from test_torch_trainer import loaders, nusc, tmp_path, workspace  # noqa: F401

from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.train.batch import prepare_device_batch
from mm2d3d_tpu_torch.utils import visualize as V
from mm2d3d_tpu_torch.utils.logging import JsonlLogger, LoggerCollection, StdoutLogger

pytestmark = pytest.mark.usefixtures("two_threads")

SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=32, width=48, n_points=128, full_scale=256,
             wire=True)
H, W = 22, 40  # the loaders' resize


def test_viz_forward_matches_jax():
    from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
    from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax

    task_j = flagship_task_jax(compute_dtype=jnp.float32, **SMALL)
    batch_j = jax_batch(make_batch_jax(np.random.RandomState(0), **BATCH))
    state = task_j.init_state(jax.random.PRNGKey(0), batch_j)
    state = state.replace(stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    ref = jax.jit(task_j.viz_forward)(state, batch_j)

    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.load_flax(*(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                                 state.params3d, state.stats3d)))
    batch = make_batch(np.random.RandomState(0), **BATCH)
    out = task.viz_forward(batch)
    assert set(out) == set(ref)
    with torch.inference_mode():
        _, p2, _, flat2, flat3, _, _, _ = task._forward(batch)
    b, n = batch.point_mask.shape
    logits = {"pred_2d_dense": p2["seg_logit_2d"].numpy(),
              "pred_2d_points": flat2.reshape(b, n, -1).numpy(),
              "pred_3d_points": flat3.reshape(b, n, -1).numpy()}
    for name, lg in logits.items():
        ours, want = out[name].numpy(), np.asarray(ref[name])
        assert ours.shape == want.shape and ours.dtype == np.int64, name
        real = np.ones(ours.shape, bool) if name == "pred_2d_dense" else \
            batch.point_mask.numpy()
        clear = ~near_tie(lg) & real  # padding points tie at the pad pixel
        assert clear.sum() > 0.9 * real.sum(), name
        np.testing.assert_array_equal(ours[clear], want[clear], err_msg=name)
    assert out["confidence"].shape == ref["confidence"].shape
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(ref["confidence"]),
                               rtol=0, atol=1e-5)


def test_numpy_helpers_equal_jax(tmp_path):  # noqa: F811
    from mm2d3d_tpu.utils import visualize as VJ

    assert V.PALETTES.keys() == VJ.PALETTES.keys()
    for name in V.PALETTES:
        np.testing.assert_array_equal(V.PALETTES[name], VJ.PALETTES[name])
    r = np.random.RandomState(0)
    values = np.concatenate([r.randn(5000) * 3, [np.nan, 0.0, 1.0, -np.inf]])
    for args in [(), (0, 1), (-2, 2), (1, 1)]:
        ours, ref = V.turbo_colormap(values, *args), VJ.turbo_colormap(values, *args)
        assert ours.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(V.turbo_colormap(np.linspace(0, 1, 1025)),
                                  VJ.turbo_colormap(np.linspace(0, 1, 1025)))
    labels = r.randint(-1, 12, (30, 7))
    labels[labels == -1] = -100
    for pal in V.PALETTES.values():
        np.testing.assert_array_equal(V.colorize_labels(labels, pal),
                                      VJ.colorize_labels(labels, pal))
    pts, cols = r.rand(10, 3) * 50, (r.rand(10, 3) * 255).astype(np.uint8)
    for colors in (cols, None):
        V.save_point_cloud_ply(str(tmp_path / "a.ply"), pts, colors)
        VJ.save_point_cloud_ply(str(tmp_path / "b.ply"), pts, colors)
        assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()


def _spread_points(r, h, w, n):
    """n points on a grid 4 pixels apart: no two markers overlap."""
    cells = [(i, j) for i in range(1, h - 1, 4) for j in range(1, w - 1, 4)]
    pick = r.choice(len(cells), n, replace=False)
    return np.array([cells[k] for k in pick], np.int64)


def test_figure_panels_hold_the_palette_colours(tmp_path):  # noqa: F811
    r = np.random.RandomState(3)
    h, w, n = 40, 60, 60
    img = r.rand(h, w, 3).astype(np.float32)
    idx = _spread_points(r, h, w, n)
    dense = r.randint(0, 6, (h, w))
    p2, p3 = r.randint(0, 6, n), r.randint(0, 6, n)
    gt = r.randint(0, 6, n)
    gt[:5] = -100
    conf = r.rand(n)
    pal = V.NUSCENES_PALETTE
    path = tmp_path / "figs" / "fig.png"
    fig = V.draw_points_image_labels_with_confidence(img, dense, p2, p3, conf, gt, idx,
                                                     pal, out_path=str(path))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), fig)
    assert fig.shape == (5 * (h + V.TITLE_HEIGHT), w, 3) and fig.dtype == np.uint8
    origins = V.panel_origins(h, 5)
    (r0, c0) = origins[0]
    np.testing.assert_array_equal(fig[r0:r0 + h, c0:c0 + w], pal[dense])
    expected = [V.colorize_labels(gt, pal), pal[p2], pal[p3],
                V.turbo_colormap(conf, 0, 1)]
    backdrop = (img * 255).astype(np.uint8)
    far = np.ones((h, w), bool)
    for dr in range(-1, 3):
        for dc in range(-1, 3):
            far[np.clip(idx[:, 0] + dr, 0, h - 1), np.clip(idx[:, 1] + dc, 0, w - 1)] = False
    for (r0, c0), colors in zip(origins[1:], expected):
        panel = fig[r0:r0 + h, c0:c0 + w]
        # each point: a 2x2 marker in its colour
        for dr in (0, 1):
            for dc in (0, 1):
                np.testing.assert_array_equal(panel[idx[:, 0] + dr, idx[:, 1] + dc], colors)
        np.testing.assert_array_equal(panel[far], backdrop[far])
    # the title bands are white with dark text
    band = fig[:V.TITLE_HEIGHT]
    assert (band == 255).mean() > 0.5 and (band < 128).any()


def test_other_figures(tmp_path):  # noqa: F811
    r = np.random.RandomState(4)
    img = (r.rand(30, 50, 3) * 255).astype(np.uint8)
    idx = _spread_points(r, 30, 50, 20)
    labels = r.randint(0, 10, 20)
    fig = V.draw_points_image_labels(img, idx, labels, V.A2D2_PALETTE,
                                     out_path=str(tmp_path / "a.png"))
    np.testing.assert_array_equal(fig[idx[:, 0], idx[:, 1]], V.A2D2_PALETTE[labels])
    depth = r.rand(20) * 40
    fig = V.draw_points_image_depth(img, idx, depth, point_size=1)
    np.testing.assert_array_equal(fig[idx[:, 0], idx[:, 1]], V.turbo_colormap(depth))
    assert (fig.sum(-1) != 0).any()
    bev = V.draw_bird_eye_view(np.array([[0, 0, 5], [4095, 4095, 0]]),
                               out_path=str(tmp_path / "bev.png"))
    assert bev.shape == (600, 600, 3) and (tmp_path / "bev.png").exists()
    assert tuple(bev[599, 0]) != (255, 255, 255) and tuple(bev[0, 599]) != (255, 255, 255)


def test_trainer_writes_and_logs_figures(nusc, tmp_path, monkeypatch):  # noqa: F811
    from mm2d3d_tpu_torch.train.trainer import Trainer

    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    log_path = tmp_path / "metrics.jsonl"
    logger = LoggerCollection([JsonlLogger(str(log_path))])
    trainer = Trainer(task, *loaders(nusc), ckpt_dir=str(tmp_path / "ckpts"),
                      limit_train_batches=2, limit_val_batches=1, logger=logger,
                      train_log_images_step=1, val_log_images_step=1,
                      class_palette="nuscenes", viz_dir=str(tmp_path / "figures"))
    drawn = []
    log_images = Trainer._log_images

    def kept(self, batch, stage):
        drawn.append((stage, self.global_step, batch))
        return log_images(self, batch, stage)

    monkeypatch.setattr(Trainer, "_log_images", kept)
    trainer.fit()
    names = ["train_source_step0", "train_target_step0", "train_source_step1",
             "train_target_step1", "val_target_step2", "test_target_step2"]
    assert [f"{s}_step{g}" for s, g, _ in drawn] == names
    assert sorted(p.name for p in (tmp_path / "figures").iterdir()) == sorted(
        n + ".png" for n in names)
    images = [json.loads(ln) for ln in open(log_path) if '"image"' in ln]
    assert images == [{"step": int(n.rsplit("step", 1)[1]), "image": {
        f"{n.rsplit('_step', 1)[0]}/figure": str(tmp_path / "figures" / (n + ".png"))}}
        for n in names]
    # the backdrop is the image the network consumed: the loader's wire
    # batch, jittered on the device
    from PIL import Image

    stage, step, batch = drawn[0]
    assert batch.img.dtype == torch.uint8 and batch.jitter_params is not None
    fig = np.asarray(Image.open(tmp_path / "figures" / f"{stage}_step{step}.png"))
    consumed = (prepare_device_batch(batch).img[0].numpy().clip(0, 1) * 255).astype(np.uint8)
    raw = batch.img[0].numpy()
    r0, _ = V.panel_origins(H, 5)[1]
    mask = batch.point_mask[0].numpy()
    far = np.ones((H, W), bool)
    idx = batch.img_indices[0].numpy()[mask]
    for dr in (-1, 0, 1, 2):
        for dc in (-1, 0, 1, 2):
            far[np.clip(idx[:, 0] + dr, 0, H - 1), np.clip(idx[:, 1] + dc, 0, W - 1)] = False
    panel = fig[r0:r0 + H, :W]
    np.testing.assert_array_equal(panel[far], consumed[far])
    assert not np.array_equal(panel[far], raw[far])
    assert fig.shape == (5 * (H + V.TITLE_HEIGHT), W, 3)


def test_trainer_without_palette_or_directory_draws_nothing(nusc, tmp_path):  # noqa: F811
    from mm2d3d_tpu_torch.train.trainer import Trainer

    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    calls = []
    task.viz_forward = lambda *a, **kw: calls.append(1)
    for kw in (dict(class_palette="nuscenes"), dict(viz_dir=str(tmp_path / "f"))):
        trainer = Trainer(task, *loaders(nusc), ckpt_dir=str(tmp_path / "ckpts"),
                          limit_train_batches=1, limit_val_batches=1,
                          train_log_images_step=1, val_log_images_step=1, **kw)
        trainer.fit()
    assert not calls and not (tmp_path / "f").exists()


def test_cli_writes_figures_and_image_lines(workspace, capsys):  # noqa: F811
    from mm2d3d_tpu_torch.run import main

    main(["--config", str(workspace / "configs" / "config.yaml"), "--device", "cpu",
          "train.params.train_log_images_step=1", "train.params.class_palette=nuscenes"])
    out = workspace / "runs" / "t"
    printed = capsys.readouterr().out
    assert "is ignored" not in printed
    assert f"figure train_source/figure @ step 0: {out / 'figures'}" in printed
    lines = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    images = [ln for ln in lines if "image" in ln]
    # 2 steps x 2 domains, every val and test batch (2 + 2 + 2), the last
    # figure of one stage and step overwriting the earlier
    assert [(ln["step"], *ln["image"]) for ln in images] == [
        (0, "train_source/figure"), (0, "train_target/figure"),
        (1, "train_source/figure"), (1, "train_target/figure"),
        (2, "val_target/figure"), (2, "val_target/figure"),
        (2, "test_target/figure"), (2, "test_target/figure"),
        (2, "test_target/figure"), (2, "test_target/figure")]
    assert sorted(p.name for p in (out / "figures").iterdir()) == [
        "test_target_step2.png", "train_source_step0.png", "train_source_step1.png",
        "train_target_step0.png", "train_target_step1.png", "val_target_step2.png"]


def test_cli_palette_per_dataset():
    from mm2d3d_tpu_torch.run import class_palette

    def cfg(name, palette=None):
        return {"dataset": {"name": name},
                "train": {"params": {} if palette is None else {"class_palette": palette}}}

    assert class_palette(cfg("nuscenes")) == "nuscenes"
    assert class_palette(cfg("a2d2_semantic_kitti")) == "a2d2"
    assert class_palette(cfg("vkitti_semantic_kitti")) == "virtual_kitti"
    assert class_palette(cfg("nuscenes", [[1, 2, 3]])) == [[1, 2, 3]]
    assert class_palette(cfg("plugin_dataset")) is None


def test_stdout_logger_prints_one_line_per_figure(capsys):
    StdoutLogger().log_image("val/figure", "/x/fig.png", 7)
    assert capsys.readouterr().out == "figure val/figure @ step 7: /x/fig.png\n"
