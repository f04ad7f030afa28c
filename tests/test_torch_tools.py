"""The port's data and profiling tools against the JAX package's, on the CPU.

- `tools/doctor.py`: the same report, line for line (the package name in
  the suggested fixes aside), and the same exit code as the JAX doctor on
  good and broken trees: per-split schema checks, images, the image cache,
  the point budgets from a config, and pseudo-label files.
- `tools/cache_images.py`: the cache it writes equals the JAX tool's, file
  for file (the numpy image ops on both sides), and the JAX `ImageCache`
  reads it.
- `utils/depth.py::filter_depth` equal to JAX's.
- `utils/profiling.py`: the spans' records and `trace`'s Chrome trace.
"""

import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

from mm2d3d_tpu_torch.tools import cache_images, doctor
from mm2d3d_tpu_torch.utils.depth import filter_depth
from mm2d3d_tpu_torch.utils.profiling import call, records, span, trace

PSELAB_KEYS = ("probs_2d", "pseudo_label_2d", "probs_3d", "pseudo_label_3d",
               "probs_ensemble", "pseudo_label_ensemble")


def _rec(rng, n, camera="samples/f0.jpg"):
    return {
        "points": rng.randn(n, 3).astype(np.float32),
        "pts_cam_coord": np.abs(rng.randn(n, 3).astype(np.float32)) + 1,
        "seg_labels": rng.randint(0, 17, n).astype(np.uint8),
        "points_img": np.stack([rng.uniform(0, 44, n), rng.uniform(0, 79, n)],
                               1).astype(np.float32),
        "camera_path": camera,
        "calib": {"cam_intrinsic": np.eye(3).tolist()},
    }


def _dump(root, split, records):
    with open(osp.join(root, split + ".pkl"), "wb") as f:
        pickle.dump(records, f)


def _pselab(path, lengths, rng, drop=()):
    recs = [{k: (rng.rand(n).astype(np.float32) if k.startswith("probs")
                 else rng.randint(0, 6, n)) for k in PSELAB_KEYS if k not in drop}
            for n in lengths]
    np.save(path, np.asarray(recs, dtype=object), allow_pickle=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A preprocessed nuScenes-like tree: good splits, broken ones, an image
    cache of the port's tool, pseudo-label files."""
    from PIL import Image

    rng = np.random.RandomState(0)
    root = str(tmp_path_factory.mktemp("doctor"))
    os.makedirs(osp.join(root, "samples"))
    for i in range(2):
        Image.fromarray((rng.rand(45, 80, 3) * 255).astype(np.uint8)).save(
            osp.join(root, "samples", f"f{i}.jpg"))
    sizes = {"train_usa": [100, 120], "train_singapore": [110, 130],
             "val_singapore": [90, 300], "test_singapore": [80, 100]}
    for split, ns in sizes.items():
        _dump(root, split, [_rec(rng, n, f"samples/f{i % 2}.jpg")
                            for i, n in enumerate(ns)])
    good = _rec(rng, 40)
    bad = dict(good)
    del bad["pts_cam_coord"]
    misaligned = dict(good, seg_labels=good["seg_labels"][:-3])
    no_image = dict(good, camera_path="samples/missing.jpg")
    negative = dict(good, points_img=good["points_img"] - 50)
    _dump(root, "broken", [bad, misaligned, no_image, negative])
    _dump(root, "not_a_list", {"points": 1})
    _pselab(osp.join(root, "pselab_good.npy"), sizes["train_singapore"], rng)
    _pselab(osp.join(root, "pselab_count.npy"), [110], rng)
    _pselab(osp.join(root, "pselab_keys.npy"), [110, 130], rng, drop=("probs_3d",))
    _pselab(osp.join(root, "pselab_lengths.npy"), [110, 129], rng)
    cache_images.main(["--preprocess-dir", root, "--image-dir", root, "--splits",
                       "train_usa", "train_singapore", "--out",
                       osp.join(root, "cache"), "--resize", "40", "22"])
    return root


def _config(root, eval_n_points=None, pselab=None, **specific):
    side = dict(preprocess_dir=root, nuscenes_dir=root)
    target = dict(side, TRAIN=["train_singapore"], VAL=["val_singapore"],
                  TEST=["test_singapore"])
    if pselab:
        target["pselab_paths"] = osp.join(root, pselab)
    return {"dataset": {"name": "nuscenes", "source": dict(side, TRAIN=["train_usa"]),
                        "target": target,
                        "specific": {"resize": [40, 22], **specific}},
            "train": {"n_points": 128, "eval_n_points": eval_n_points}}


CASES = {
    "good split": ["--splits", "train_usa", "--resize", "40", "22"],
    "broken split": ["--splits", "broken", "--sample", "4"],
    "unknown split": ["--splits", "nope"],
    "not a list": ["--splits", "not_a_list"],
    "image cache": ["--splits", "train_usa", "--image-cache-dir", "{root}/cache",
                    "--resize", "40", "22"],
    "cache at another size": ["--splits", "train_usa", "--image-cache-dir",
                              "{root}/cache", "--resize", "80", "45"],
    "frames missing from the cache": ["--splits", "broken", "--sample", "4",
                                      "--image-cache-dir", "{root}/cache"],
    "pseudo labels": ["--splits", "train_singapore", "--pselab",
                      "{root}/pselab_good.npy"],
    "pseudo labels of another split": ["--splits", "train_singapore", "--pselab",
                                       "{root}/pselab_count.npy"],
    "pseudo labels without a key": ["--splits", "train_singapore", "--pselab",
                                    "{root}/pselab_keys.npy"],
    "pseudo labels of other lengths": ["--splits", "train_singapore", "--pselab",
                                       "{root}/pselab_lengths.npy"],
    "no pseudo-label file": ["--splits", "train_singapore", "--pselab",
                             "{root}/none.npy"],
    "config: eval budget too small": dict(),
    "config: budgets cover the splits": dict(eval_n_points=1024),
    "config: in-grid counts": dict(eval_n_points=300, scale=20, full_scale=4096),
    "config: pseudo labels": dict(eval_n_points=1024, pselab="pselab_good.npy"),
    "config: pseudo labels of other lengths": dict(eval_n_points=1024,
                                                   pselab="pselab_lengths.npy"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_doctor_reports_as_jax(tree, case, capsys):
    from mm2d3d_tpu.tools import doctor as doctor_jax

    args = CASES[case]
    if isinstance(args, dict):
        runs = [lambda mod: mod.run_from_config(_config(tree, **args))]
    else:
        argv = ["--preprocess-dir", tree, "--scenario", "nuscenes", "--data-dir",
                tree] + [a.format(root=tree) for a in args]
        runs = [lambda mod: mod.main(argv)]
    out = {}
    for name, mod in (("port", doctor), ("jax", doctor_jax)):
        rc = runs[0](mod)
        out[name] = (rc, capsys.readouterr().out.replace("mm2d3d_tpu_torch", "mm2d3d_tpu"))
    assert out["port"] == out["jax"]
    rc, text = out["port"]
    assert ("PROBLEM" in text) == (rc == 1)


def test_cache_images_equals_jax(tree, tmp_path, monkeypatch):
    import mm2d3d_tpu.data.augment as augment_jax
    from mm2d3d_tpu.data.image_cache import ImageCache as ImageCacheJ
    from mm2d3d_tpu.tools import cache_images as cache_images_jax

    monkeypatch.setattr(augment_jax, "_USE_NATIVE", False)
    argv = ["--preprocess-dir", tree, "--image-dir", tree, "--splits", "train_usa",
            "train_singapore", "--resize", "40", "22", "--out"]
    cache_images_jax.main(argv + [str(tmp_path / "jax")])
    port = osp.join(tree, "cache")
    files = sorted(os.path.relpath(osp.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert files == ["meta.json", "samples/f0.jpg.npy", "samples/f1.jpg.npy"]
    for rel in files:
        a, b = osp.join(port, rel), str(tmp_path / "jax" / rel)
        if rel.endswith(".json"):
            with open(a) as f, open(b) as g:
                assert json.load(f) == json.load(g)
        else:
            np.testing.assert_array_equal(np.load(a), np.load(b))
    img, size = ImageCacheJ(port).get("samples/f0.jpg")
    assert img.shape == (22, 40, 3) and img.dtype == np.uint8 and size == (80, 45)
    # a rerun finds every frame cached
    assert cache_images.main(argv + [port]) is None


@pytest.mark.parametrize("shape,kernel,threshold", [
    ((9, 9), 3, 0.1), ((20, 30), 5, 0.1), ((2, 20, 30, 1), 5, 0.2), ((1, 17, 11, 1), 7, 0.05)])
def test_filter_depth_equals_jax(shape, kernel, threshold):
    from mm2d3d_tpu.utils.depth import filter_depth as filter_depth_jax

    r = np.random.RandomState(kernel)
    d = (r.rand(*shape) * 10 * (r.rand(*shape) < 0.4)).astype(np.float32)
    ours = filter_depth(torch.from_numpy(d), kernel, threshold)
    ref = np.asarray(filter_depth_jax(d, kernel, threshold))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ours.numpy() == 0).sum() > (d == 0).sum()  # something was occluded


def test_filter_depth_drops_the_occluded_return():
    d = torch.zeros(9, 9)
    d[4, 4] = 10.0  # background leak
    patch = d[3:6, 3:6]
    patch[patch == 0] = 2.0  # foreground surface
    out = filter_depth(d, kernel_size=3, threshold=0.1)
    assert out[4, 4] == 0.0 and out[3, 3] == 2.0


def test_step_timer_medians_per_phase():
    """The spans that replace `StepTimer`: host time per named span in each
    call's record, summed over the span's uses, kept when the block raises."""
    import time

    for dt in (0.001, 0.003, 0.002):
        with call("train") as rec, span("step"):
            torch.ones(8).sum()
            time.sleep(dt)
    with call("eval"), span("eval"):
        pass
    train, ev = records("train")[-3:], records("eval")[-1]
    assert train[-1] is rec and [set(r["spans"]) for r in train] == [{"step"}] * 3
    step_ms = float(np.median([r["spans"]["step"] for r in train])) / 1e6
    assert 2.0 <= step_ms < 50 and ev["spans"]["eval"] / 1e6 < step_ms
    with call("train") as rec:
        with pytest.raises(ValueError):
            with span("raises"):
                raise ValueError
        with span("twice"):
            time.sleep(0.001)
        with span("twice"):
            time.sleep(0.001)
    assert set(rec["spans"]) == {"raises", "twice"} and rec["spans"]["twice"] >= 2e6


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in k.key for k in prof.key_averages())
