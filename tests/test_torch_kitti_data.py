"""The KITTI-family data path of mm2d3d_tpu_torch vs the JAX package's, on
the CPU.

Fixture trees written here (the formats of tests/test_datasets_kitti.py:
preprocess pickles and PNG frames) go through both packages' SemanticKITTI,
VirtualKITTI and A2D2 datasets, `crop_with_retry`, and the two scenarios'
datamodules (`load_datamodule` with the shipped dataset yaml's `specific`
and `augmentations`) over two epochs: every sample field and every batch
field must be equal bit for bit, in-process and with worker pools.  The
JAX side runs its numpy image ops (`jax_numpy_image_ops`, from
tests/test_torch_data.py), which the port copies.  Both preprocess scripts,
on raw trees written here, must give the JAX scripts' pickles.
"""

import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest
from PIL import Image

from test_torch_data import assert_batches_equal, jax_numpy_image_ops  # noqa: F401

from mm2d3d_tpu.data import augment as augment_jax
from mm2d3d_tpu.data.a2d2 import A2D2 as A2D2J
from mm2d3d_tpu.data.registry import load_datamodule as load_datamodule_jax
from mm2d3d_tpu.data.semantic_kitti import SemanticKITTI as SemanticKITTIJ
from mm2d3d_tpu.data.virtual_kitti import VirtualKITTI as VirtualKITTIJ
from mm2d3d_tpu_torch.data import augment
from mm2d3d_tpu_torch.data.a2d2 import A2D2
from mm2d3d_tpu_torch.data.registry import load_datamodule
from mm2d3d_tpu_torch.data.semantic_kitti import SemanticKITTI
from mm2d3d_tpu_torch.data.virtual_kitti import PROJ_MATRIX, VirtualKITTI
from mm2d3d_tpu_torch.utils.config import load_config

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
AUG = dict(noisy_rot=0.1, flip_x=0.5, rot=6.2831, transl=True, fliplr=0.5,
           color_jitter=(0.4, 0.4, 0.4))
SKITTI_HW = (310, 500)  # one frame size per split: the eval collate stacks them
A2D2_HW = (604, 960)
VKITTI_HW = (375, 1242)
SKITTI_IDS = np.array([0, 1, 10, 11, 18, 30, 40, 44, 48, 50, 51, 60, 70, 72,
                       80, 81, 99, 252, 258, 49])  # unlabeled / unmapped too


def _png(path, hw, rng):
    os.makedirs(osp.dirname(path), exist_ok=True)
    Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(path)


def _scan_in_view(rng, n, hw):
    """(points_img (row, col) float64, pts_cam (N, 3) float32) of `n`
    points anywhere in an `hw` frame, 2-40 m deep."""
    points_img = np.stack([rng.rand(n) * hw[0], rng.rand(n) * hw[1]], 1)
    z = rng.rand(n) * 38 + 2
    pts_cam = np.stack([(points_img[:, 1] - hw[1] / 2) * z / 700,
                        (points_img[:, 0] - hw[0] / 2) * z / 700, z], 1)
    return points_img, pts_cam.astype(np.float32)


def write_semantic_kitti(root, rng, scans=None, hw=SKITTI_HW, points=(250, 400)):
    """Preprocess pickles (`<root>/preprocess/<split>.pkl`) and two PNG
    frames per split under `<root>/sequences`."""
    scans = scans or {"train": 5, "val": 3, "test": 3}
    os.makedirs(osp.join(root, "preprocess"), exist_ok=True)
    for s, (split, count) in enumerate(scans.items()):
        frames = [osp.join("sequences", f"{s:02d}", "image_2", f"{i:06d}.png")
                  for i in range(2)]
        for f in frames:
            _png(osp.join(root, f), hw, rng)
        recs = []
        for i in range(count):
            n = rng.randint(*points)
            points_img, pts_cam = _scan_in_view(rng, n, hw)
            recs.append({
                "points": pts_cam[:, [2, 0, 1]] * np.float32([1, -1, -1]),
                "seg_labels": SKITTI_IDS[rng.randint(0, len(SKITTI_IDS), n)].astype(np.int32),
                "points_img": points_img,
                "lidar_path": f"velodyne/{i:06d}.bin",
                "camera_path": frames[i % 2],
                "intrinsics": np.array([[700.0, 0, hw[1] / 2], [0, 700.0, hw[0] / 2],
                                        [0, 0, 1]]),
                "pts_cam_coord": pts_cam,
            })
        with open(osp.join(root, "preprocess", split + ".pkl"), "wb") as fh:
            pickle.dump(recs, fh)
    return root


def write_virtual_kitti(root, rng, scans=4, points=(10200, 10600),
                        weathers=("clone", "fog", "morning", "overcast", "rain",
                                  "sunset")):
    """`<root>/preprocess/train.pkl` of scans whose points project into the
    1242x375 frame through `PROJ_MATRIX`, and the frames of every weather
    variant under `<root>/vkitti_1.3.1_rgb`."""
    os.makedirs(osp.join(root, "preprocess"), exist_ok=True)
    for w in weathers:
        for f in range(2):
            _png(osp.join(root, "vkitti_1.3.1_rgb", "0001", w, f"{f:05d}.png"),
                 VKITTI_HW, rng)
    fx, cx, cy = float(PROJ_MATRIX[0, 0]), float(PROJ_MATRIX[0, 2]), float(PROJ_MATRIX[1, 2])
    recs = []
    for i in range(scans):
        n = rng.randint(*points)
        rows, cols = rng.rand(n) * (VKITTI_HW[0] - 1), rng.rand(n) * (VKITTI_HW[1] - 1)
        z = rng.rand(n) * 38 + 2
        cam = np.stack([(cols - cx) * z / fx, (rows - cy) * z / fx, z], 1)
        labels = rng.randint(0, 13, n)
        labels[rng.rand(n) < 0.05] = 99  # the raw "Don't care" id
        recs.append({
            # world = (z_c, -x_c, -y_c): the dataset's cam = (-y, -z, x)
            "points": np.stack([cam[:, 2], -cam[:, 0], -cam[:, 1]], 1).astype(np.float32),
            "seg_labels": labels.astype(np.uint8),
            "lidar_path": f"vkitti_npy/0001/{i % 2:05d}.npy",
            "scene_id": "0001", "frame_id": f"{i % 2:05d}",
        })
    with open(osp.join(root, "preprocess", "train.pkl"), "wb") as fh:
        pickle.dump(recs, fh)
    return root


def write_a2d2(root, rng, scans=4, class_list=True, points=(250, 400)):
    """`<root>/preprocess/train.pkl`, two 960x604 frames under `<root>/cam`,
    `cams_lidars.json` and (optionally) `class_list.json`."""
    os.makedirs(osp.join(root, "preprocess"), exist_ok=True)
    for f in range(2):
        _png(osp.join(root, "cam", f"{f}.png"), A2D2_HW, rng)
    with open(osp.join(root, "cams_lidars.json"), "w") as fh:
        json.dump({"cameras": {"front_center": {"Lens": "Telecam"}}}, fh)
    if class_list:
        with open(osp.join(root, "class_list.json"), "w") as fh:
            json.dump({f"#{3 * i:02x}{i:02x}{255 - i:02x}": name
                       for i, name in enumerate(A2D2.class_names)}, fh)
    recs = []
    for i in range(scans):
        n = rng.randint(*points)
        points_img, pts_cam = _scan_in_view(rng, n, A2D2_HW)
        recs.append({
            "points": pts_cam[:, [2, 0, 1]] * np.float32([1, -1, -1]),
            "pts_cam_coord": pts_cam,
            "seg_labels": rng.randint(0, len(A2D2.class_names), n).astype(np.uint8),
            "points_img": points_img,
            "camera_path": f"cam/{i % 2}.png",
        })
    with open(osp.join(root, "preprocess", "train.pkl"), "wb") as fh:
        pickle.dump(recs, fh)
    return root


def assert_samples_equal(ours, ref, where=""):
    assert set(ours) == set(ref), where
    for k, b in ref.items():
        a = ours[k]
        if b is None or a is None:
            assert a is None and b is None, f"{where} {k}"
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where} {k}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")


def _compare_datasets(ds, ds_j, seeds=range(3)):
    assert len(ds) == len(ds_j)
    assert ds.merged_class_names == ds_j.merged_class_names
    np.testing.assert_array_equal(ds.label_mapping, ds_j.label_mapping)
    for i in range(len(ds)):
        for seed in seeds:
            assert_samples_equal(ds.__getitem__(i, np.random.RandomState(seed)),
                                 ds_j.__getitem__(i, np.random.RandomState(seed)),
                                 f"scan {i} seed {seed}")


@pytest.fixture(scope="module")
def skitti(tmp_path_factory):
    return write_semantic_kitti(str(tmp_path_factory.mktemp("skitti")),
                                np.random.RandomState(0))


CROPS = {"bottom": dict(crop_size=(480, 302), bottom_crop=True),
         "random": dict(crop_size=(480, 302), rand_crop=(0.5, 1.0, 0.6, 1.0)),
         "full frame": {}}


@pytest.mark.parametrize("crop", sorted(CROPS))
@pytest.mark.parametrize("style", ["A2D2", "VirtualKITTI", "nuScenes"])
def test_semantic_kitti_samples_equal_jax(skitti, style, crop):
    kw = dict(split=("train",), preprocess_dir=osp.join(skitti, "preprocess"),
              semantic_kitti_dir=skitti, merge_classes_style=style,
              device_image_ops=style == "VirtualKITTI", **CROPS[crop], **AUG)
    _compare_datasets(SemanticKITTI(**kw), SemanticKITTIJ(**kw))
    ds = SemanticKITTI(**kw)
    assert ds.num_classes == {"A2D2": 10}.get(style, 6)
    if crop != "full frame":
        assert ds.__getitem__(0, np.random.RandomState(0))["img"].shape[:2] == (302, 480)


@pytest.fixture(scope="module")
def vkitti(tmp_path_factory):
    return write_virtual_kitti(str(tmp_path_factory.mktemp("vkitti")),
                               np.random.RandomState(1), scans=2)


VKITTI_CASES = {
    "fixed downsample, bottom crop": dict(downsample=(10000,), crop_size=(480, 302),
                                          bottom_crop=True),
    "ranged downsample, random crop": dict(downsample=(4000, 9000), crop_size=(480, 302),
                                           rand_crop=(0.5, 1.0, 0.3, 0.6)),
    "two weathers, no downsample": dict(random_weather=("clone", "fog")),
    "no weather draw": dict(random_weather=(), downsample=(5000,)),
}


@pytest.mark.parametrize("case", sorted(VKITTI_CASES))
def test_virtual_kitti_samples_equal_jax(vkitti, case):
    kw = dict(split=("train",), preprocess_dir=osp.join(vkitti, "preprocess"),
              virtual_kitti_dir=vkitti, device_image_ops=True,
              **VKITTI_CASES[case], **AUG)
    ds = VirtualKITTI(**kw)
    _compare_datasets(ds, VirtualKITTIJ(**kw), seeds=range(2))
    assert ds.num_classes == 6
    if "downsample" in VKITTI_CASES[case]:
        n = len(ds.__getitem__(0, np.random.RandomState(0))["points"])
        assert n <= 9000


@pytest.mark.parametrize("class_list", [True, False])
def test_a2d2_samples_equal_jax(tmp_path, class_list):
    root = write_a2d2(str(tmp_path), np.random.RandomState(2), scans=2,
                      class_list=class_list)
    kw = dict(split=("train",), preprocess_dir=root, resize=(480, 302),
              rand_crop=(0.5, 0.7, 1.0, 0.7, 1.0), device_image_ops=not class_list,
              **AUG)
    ds = A2D2(**kw)
    _compare_datasets(ds, A2D2J(**kw), seeds=range(4))
    assert ds.sensor_config is not None and hasattr(ds, "rgb_to_class") == class_list
    assert ds.num_classes == 10
    assert ds.__getitem__(0, np.random.RandomState(0))["img"].shape[:2] == (302, 480)


@pytest.mark.parametrize("case", ["bottom", "random", "random, no resize",
                                  "fallback after 10 tries"])
def test_crop_with_retry_equals_jax(case):
    r = np.random.RandomState(3)
    image = (r.rand(120, 200, 3) * 255).astype(np.uint8)
    n = 60 if case.startswith("fallback") else 400
    points_img = np.stack([r.rand(n) * 120, r.rand(n) * 200], 1)
    args = {"bottom": ((160, 90), True, np.zeros(0)),
            "random": ((160, 90), False, np.array([0.4, 1.0, 0.5, 1.0])),
            "random, no resize": ((), False, np.array([0.4, 1.0, 0.5, 1.0])),
            "fallback after 10 tries": ((160, 90), True, np.zeros(0))}[case]
    rng, rng_j = np.random.RandomState(4), np.random.RandomState(4)
    ours = augment.crop_with_retry(image, points_img, rng, *args)
    ref = augment_jax.crop_with_retry(image, points_img, rng_j, *args)
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(k))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    # the draws consumed: the next sample's augmentations stay aligned
    assert rng.rand() == rng_j.rand()
    if case.startswith("fallback"):
        assert ours[0] is image and ours[3] == (0, 0) and ours[2].all()


# --------------------------------------------------------------------------
# the two scenarios' datamodules
# --------------------------------------------------------------------------

SCENARIOS = {"vkitti_semantic_kitti": "virtual_kitti_semantic_kitti.yaml",
             "a2d2_semantic_kitti": "a2d2_semantic_kitti.yaml"}


@pytest.fixture(scope="module")
def kitti_roots(tmp_path_factory):
    rng = np.random.RandomState(5)
    base = tmp_path_factory.mktemp("kitti_roots")
    return {
        "semantic_kitti": write_semantic_kitti(str(base / "semantic_kitti"), rng),
        "virtual_kitti": write_virtual_kitti(str(base / "virtual_kitti"), rng),
        "a2d2": write_a2d2(str(base / "a2d2"), rng),
    }


def datamodule_args(name, roots, num_workers=0):
    """load_datamodule's arguments from the shipped dataset yaml, with the
    fixture trees' paths: batch 2, 512 train and 1024 eval points."""
    cfg = load_config(osp.join(REPO, "configs", "config.yaml"),
                      [f"datasets={osp.splitext(SCENARIOS[name])[0]}"])["dataset"]
    src_root = roots["virtual_kitti" if name.startswith("vkitti") else "a2d2"]
    source = dict(cfg["source"], preprocess_dir=(
        osp.join(src_root, "preprocess") if name.startswith("vkitti") else src_root))
    if name.startswith("vkitti"):
        source["virtual_kitti_dir"] = src_root
    target = dict(cfg["target"], preprocess_dir=osp.join(roots["semantic_kitti"],
                                                         "preprocess"),
                  semantic_kitti_dir=roots["semantic_kitti"])
    return dict(name=name, cfg_source=source, cfg_target=target, batch_size=2,
                n_points=512, test_batch_size=2, eval_n_points=1024,
                num_workers=num_workers, augmentations=cfg["augmentations"],
                specific=cfg["specific"], seed=7, full_scale=4096)


def _all_batches(dm, epochs=2):
    out = []
    for epoch in range(epochs):
        for lo in (dm.source_train, dm.target_train, dm.target_val, dm.target_test):
            lo.set_epoch(epoch)
            out.extend(lo)
    return out


def _close(dm):
    for lo in (dm.source_train, dm.target_train, dm.target_val, dm.target_test):
        lo.close()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_datamodule_batches_equal_jax(kitti_roots, name):
    args = datamodule_args(name, kitti_roots)
    dm, dm_j = load_datamodule(**args), load_datamodule_jax(**args)
    assert dm.num_classes == dm_j.num_classes == (6 if name.startswith("vkitti") else 10)
    assert dm.class_names == dm_j.class_names
    ours, ref = _all_batches(dm), _all_batches(dm_j)
    assert len(ours) == len(ref) == 2 * (2 + 2 + 2 + 2)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert_batches_equal(a, b, f"batch {i}")
    # train crops 480x302; eval the whole 500x310 frame
    assert tuple(ours[2].img.shape[1:3]) == (302, 480)
    assert tuple(ours[4].img.shape[1:3]) == SKITTI_HW
    assert ours[0].feats is None  # the device image path, as shipped


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_datamodule_worker_pools_equal_in_process(kitti_roots, name):
    pooled = load_datamodule(**datamodule_args(name, kitti_roots, num_workers=2))
    try:
        got = _all_batches(pooled)
    finally:
        _close(pooled)
    want = _all_batches(load_datamodule(**datamodule_args(name, kitti_roots)))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_batches_equal(a, b, f"batch {i}")


def test_unknown_datamodule_raises(kitti_roots):
    with pytest.raises(ValueError, match="unknown datamodule"):
        load_datamodule(**{**datamodule_args("a2d2_semantic_kitti", kitti_roots),
                           "name": "kitti360"})


# --------------------------------------------------------------------------
# offline preprocessing
# --------------------------------------------------------------------------

def _assert_pickles_equal(a_path, b_path):
    with open(a_path, "rb") as fa, open(b_path, "rb") as fb:
        a, b = pickle.load(fa), pickle.load(fb)
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert_samples_equal(ra, rb, ra.get("lidar_path", ""))
    return a


def write_raw_semantic_kitti(root, rng):
    """The KITTI odometry layout: calib.txt for every sequence, velodyne
    scans (and labels but for sequence 01) in 00, 01 and 08."""
    p2 = np.array([[700.0, 0, 250, 40], [0, 700.0, 155, 0.2], [0, 0, 1, 0.003]])
    tr = np.array([[0.0, -1, 0, 0.1], [0, 0, -1, -0.08], [1, 0, 0, -0.3]])
    for seq in [f"{s:02d}" for s in range(11)]:
        d = osp.join(root, "sequences", seq)
        os.makedirs(d)
        with open(osp.join(d, "calib.txt"), "w") as f:
            for key in ("P0", "P1", "P2", "P3"):
                f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in p2.ravel()) + "\n")
            f.write("Tr: " + " ".join(f"{v:.12e}" for v in tr.ravel()) + "\n")
        if seq not in ("00", "01", "08"):
            continue
        os.makedirs(osp.join(d, "velodyne"))
        os.makedirs(osp.join(d, "labels"))
        for i in range(2):
            n = 500
            pts = np.stack([rng.rand(n) * 60 - 10, (rng.rand(n) - 0.5) * 40,
                            rng.rand(n) * 4 - 2, rng.rand(n)], 1).astype(np.float32)
            pts.tofile(osp.join(d, "velodyne", f"{i:06d}.bin"))
            if seq != "01":
                lab = (SKITTI_IDS[rng.randint(0, len(SKITTI_IDS), n)].astype(np.uint32)
                       | (rng.randint(0, 9, n).astype(np.uint32) << 16))
                lab.tofile(osp.join(d, "labels", f"{i:06d}.label"))


def test_semantic_kitti_preprocess_equals_jax(tmp_path):
    from mm2d3d_tpu.data.preprocess import semantic_kitti as pre_jax
    from mm2d3d_tpu_torch.data.preprocess import semantic_kitti as pre

    root = str(tmp_path / "raw")
    write_raw_semantic_kitti(root, np.random.RandomState(6))
    for split in ("train", "val"):
        pre.preprocess(split, root, str(tmp_path / "port"))
        pre_jax.preprocess(split, root, str(tmp_path / "jax"))
        recs = _assert_pickles_equal(str(tmp_path / "port" / "preprocess" / f"{split}.pkl"),
                                     str(tmp_path / "jax" / "preprocess" / f"{split}.pkl"))
        assert len(recs) == (4 if split == "train" else 2)
        assert all(0 < len(r["points"]) < 500 for r in recs)  # in view only
        # sequence 01 has no labels
        assert sum(r["seg_labels"] is None for r in recs) == (2 if split == "train" else 0)


def test_virtual_kitti_preprocess_equals_jax(tmp_path):
    from mm2d3d_tpu.data.preprocess import virtual_kitti as pre_jax
    from mm2d3d_tpu_torch.data.preprocess import virtual_kitti as pre

    root = str(tmp_path / "raw")
    r = np.random.RandomState(7)
    for scene in ("0001", "0020"):
        os.makedirs(osp.join(root, "vkitti_npy", scene))
        for i in range(2):
            np.save(osp.join(root, "vkitti_npy", scene, f"{i:05d}.npy"),
                    np.concatenate([r.randn(300, 6), r.randint(0, 14, (300, 1))], 1))
    with open(osp.join(root, "vkitti_npy", "0020", "00009.npy"), "wb") as f:
        f.write(b"not a numpy file")  # skipped, as in the reference
    pre.preprocess("train", root, str(tmp_path / "port"))
    pre_jax.preprocess("train", root, str(tmp_path / "jax"))
    recs = _assert_pickles_equal(str(tmp_path / "port" / "preprocess" / "train.pkl"),
                                 str(tmp_path / "jax" / "preprocess" / "train.pkl"))
    assert [(r["scene_id"], r["frame_id"]) for r in recs] == [
        ("0001", "00000"), ("0001", "00001"), ("0020", "00000"), ("0020", "00001")]
