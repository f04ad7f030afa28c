"""The nuScenes-lidarseg preprocessing of mm2d3d_tpu_torch against the JAX
package's, on a fake devkit.

Neither machine has the nuScenes devkit, so the test writes one: a `nusc`
object with the tables `preprocess` reads (samples, scenes, logs, sample
data, calibrated sensors, ego poses, lidarseg files) over lidar scans and
label files it writes from a seed, and stub `nuscenes.nuscenes` and
`nuscenes.eval.lidarseg.utils` modules in `sys.modules`.  Both packages'
`preprocess` and `main` then write the same pickles, byte for byte.
"""

import os
import os.path as osp
import pickle
import sys
import types

import numpy as np
import pytest

from mm2d3d_tpu.data.preprocess import nuscenes_lidarseg as PJ
from mm2d3d_tpu_torch.data.preprocess import nuscenes_lidarseg as P

# (scene, location, description): train only (twice), train carved out to
# val for singapore, train carved out to val for night, test, in no table
SCENES = [
    ("scene-0001", "boston-seaport", "Peds, parked cars"),
    ("scene-0002", "singapore-onenorth", "Night, parked cars"),
    ("scene-0004", "singapore-onenorth", "Wait at intersection"),
    ("scene-1044", "singapore-hollandvillage", "Night, big street"),
    ("scene-0003", "singapore-queenstown", "Night, turn right"),
    ("scene-9999", "boston-seaport", "Rain"),
]
SAMPLES_PER_SCENE = 2
N_FINE = 32  # lidarseg's fine classes


def _quat_about_z(angle):
    return [float(np.cos(angle / 2)), 0.0, 0.0, float(np.sin(angle / 2))]


class FakeNuScenes:
    """The part of the devkit's `NuScenes` that `preprocess` reads."""

    def __init__(self, dataroot: str, seed: int = 0):
        r = np.random.RandomState(seed)
        self.dataroot = dataroot
        self.tables = {k: {} for k in ("scene", "log", "sample_data",
                                       "calibrated_sensor", "ego_pose", "lidarseg")}
        self.sample = []
        self._files = {}
        os.makedirs(osp.join(dataroot, "samples"), exist_ok=True)
        os.makedirs(osp.join(dataroot, "lidarseg"), exist_ok=True)
        # the front camera of nuScenes: z forward in the camera, x forward
        # in the ego frame
        cam_rot = [0.5, -0.5, 0.5, -0.5]
        intrinsic = [[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]]
        for s, (name, location, desc) in enumerate(SCENES):
            self.tables["log"][f"log{s}"] = {"location": location}
            self.tables["scene"][f"sc{s}"] = {"name": name, "description": desc,
                                              "log_token": f"log{s}"}
            for k in range(SAMPLES_PER_SCENE):
                tok = f"s{s}_{k}"
                lidar_rot = _quat_about_z(-np.pi / 2 + r.uniform(-0.05, 0.05))
                lidar_t = [0.94, 0.0, 1.84]
                pose = [float(v) for v in r.uniform(-500, 500, 3)]
                yaw = r.uniform(-np.pi, np.pi)
                self._add_sensor(f"{tok}_lidar", lidar_t, lidar_rot, pose, yaw)
                # the camera's ego pose is a moment later
                self._add_sensor(f"{tok}_cam", [1.70, 0.02, 1.51], cam_rot,
                                 [p + d for p, d in zip(pose, r.uniform(-0.3, 0.3, 3))],
                                 yaw + r.uniform(-0.01, 0.01))
                # points in front of the ego vehicle and around it, then in
                # the lidar frame
                n = r.randint(150, 250)
                ego = np.stack([r.uniform(-30, 40, n), r.uniform(-15, 15, n),
                                r.uniform(-1.5, 2.5, n)])
                lidar = P.quat_to_rot(lidar_rot).T @ (ego - np.array(lidar_t)[:, None])
                scan = np.concatenate([lidar.T, r.rand(n, 2)], 1).astype(np.float32)
                lidar_path = osp.join(dataroot, "samples", f"{tok}.pcd.bin")
                scan.tofile(lidar_path)
                seg_rel = osp.join("lidarseg", f"{tok}_lidarseg.bin")
                r.randint(0, N_FINE, n).astype(np.uint8).tofile(osp.join(dataroot, seg_rel))
                self.tables["lidarseg"][f"{tok}_lidar"] = {"filename": seg_rel}
                self._files[f"{tok}_lidar"] = (lidar_path, [], None)
                self._files[f"{tok}_cam"] = (
                    osp.join(dataroot, "samples", f"{tok}.jpg"), [],
                    np.array(intrinsic))
                self.sample.append({"token": tok, "scene_token": f"sc{s}",
                                    "data": {"LIDAR_TOP": f"{tok}_lidar",
                                             "CAM_FRONT": f"{tok}_cam"}})

    def _add_sensor(self, token, translation, rotation, pose, yaw):
        self.tables["sample_data"][token] = {
            "calibrated_sensor_token": f"cs_{token}", "ego_pose_token": f"ep_{token}"}
        self.tables["calibrated_sensor"][f"cs_{token}"] = {
            "translation": translation, "rotation": rotation}
        self.tables["ego_pose"][f"ep_{token}"] = {
            "translation": pose, "rotation": _quat_about_z(yaw)}

    def get(self, table, token):
        return self.tables[table][token]

    def get_sample_data(self, token):
        return self._files[token]


class FakeMapper:
    def __init__(self, nusc):
        self.nusc = nusc

    def get_fine_idx_2_coarse_idx(self):
        return {i: (i * 7) % 17 for i in range(N_FINE)}


@pytest.fixture
def devkit(monkeypatch, tmp_path):
    """Stub devkit modules in `sys.modules`; `NuScenes(...)` builds the fake
    over `tmp_path / "nuscenes"`."""
    root = str(tmp_path / "nuscenes")
    made = []

    def nuscenes_ctor(version, dataroot, verbose=True):
        made.append((version, dataroot))
        return FakeNuScenes(dataroot)

    mods = {name: types.ModuleType(name) for name in (
        "nuscenes", "nuscenes.nuscenes", "nuscenes.eval", "nuscenes.eval.lidarseg",
        "nuscenes.eval.lidarseg.utils")}
    mods["nuscenes.nuscenes"].NuScenes = nuscenes_ctor
    mods["nuscenes.eval.lidarseg.utils"].LidarsegClassMapper = FakeMapper
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return root, made


def _pickles(out_dir):
    d = osp.join(out_dir, "preprocess")
    return {f: open(osp.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("subset", [
    dict(location="boston", subset_name="usa"),
    dict(location="singapore", subset_name="singapore"),
    dict(keyword="night", keyword_action="exclude", subset_name="day"),
    dict(keyword="night", keyword_action="filter", subset_name="night"),
    dict(),
])
def test_preprocess_pickles_equal_jax(devkit, tmp_path, subset):
    root, _ = devkit
    nusc = FakeNuScenes(root)
    splits = ["train", "val", "test"]
    P.preprocess(nusc, splits, root, str(tmp_path / "port"), **subset)
    PJ.preprocess(nusc, splits, root, str(tmp_path / "jax"), **subset)
    ours, ref = _pickles(tmp_path / "port"), _pickles(tmp_path / "jax")
    assert sorted(ours) == sorted(ref) == sorted(
        f"{s}{'_' + subset['subset_name'] if subset else ''}.pkl" for s in splits)
    assert ours == ref
    records = [r for f in ours.values() for r in pickle.loads(f)]
    assert records, "no sample kept"
    for rec in records:
        n = len(rec["points"])
        assert rec["seg_labels"].shape == (n,) and rec["points_img"].shape == (n, 2)
        assert rec["pts_cam_coord"].shape == (n, 3) and n > 0
        assert not rec["camera_path"].startswith(root)


def test_main_pickles_equal_jax(devkit, tmp_path, monkeypatch, capsys):
    root, made = devkit
    P.main(["--root", root, "--out", str(tmp_path / "port"), "--version", "v1.0-mini"])
    monkeypatch.setattr(sys, "argv", ["nuscenes_lidarseg", "--root", root, "--out",
                                      str(tmp_path / "jax"), "--version", "v1.0-mini"])
    PJ.main()
    assert made == [("v1.0-mini", root)] * 2
    ours, ref = _pickles(tmp_path / "port"), _pickles(tmp_path / "jax")
    assert len(ours) == 12 and ours == ref


def test_preprocess_needs_the_devkit(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(ImportError):
        P.preprocess(object(), ["train"], str(tmp_path), str(tmp_path))


@pytest.mark.parametrize("kw", [dict(keyword="night", location="boston"),
                                dict(keyword="night", keyword_action="keep")])
def test_preprocess_refuses_contradicting_filters(kw):
    with pytest.raises(ValueError):
        P.preprocess(object(), ["train"], "", "", **kw)


def test_projection_matches_jax():
    r = np.random.RandomState(3)
    info = {k: list(r.uniform(-2, 2, 3)) for k in (
        "lidar2ego_translation", "ego2global_translation_lidar",
        "ego2global_translation_cam", "cam2ego_translation")}
    for k in ("lidar2ego_rotation", "ego2global_rotation_lidar",
              "ego2global_rotation_cam", "cam2ego_rotation"):
        info[k] = list(r.randn(4))  # not unit: both normalise
    info["cam_intrinsic"] = [[800.0, 0, 800], [0, 800.0, 450], [0, 0, 1]]
    pc = r.uniform(-40, 40, (3, 500))
    for a, b in zip(P.map_pointcloud_to_image(pc, (900, 1600, 3), info),
                    PJ.map_pointcloud_to_image(pc, (900, 1600, 3), info)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(P.quat_to_rot(info["cam2ego_rotation"]),
                                  PJ.quat_to_rot(info["cam2ego_rotation"]))
