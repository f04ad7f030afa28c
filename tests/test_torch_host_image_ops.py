"""The loader's C++ image ops (`mm2d3d_tpu_torch/csrc/host_ops.cpp`) against
the numpy path of `mm2d3d_tpu_torch.data.augment`, bit for bit.

The numpy resize computes coordinates and weights in float64 and returns
float64 in its own memory order; the C++ one follows it operation by
operation (built with ``-ffp-contract=off``) and stores its result in the
same order, since later reductions (color jitter's means) sum in it.  Held at the shipped configs' frame sizes (integer
and non-integer ratios), an upscale, odd small sizes and strided views; the
maps with duplicate and negative pixel indices; ``MM2D3D_HOST_NATIVE=0``;
and the refusal when the library cannot be built.  The numpy path is also
held against the JAX package's numpy path.
"""

import numpy as np
import pytest

import mm2d3d_tpu.data.augment as augment_jax
from mm2d3d_tpu_torch import native
from mm2d3d_tpu_torch.data import augment as A

# (in_w, in_h) -> (out_w, out_h), PIL order
RESIZES = {
    "nuscenes": ((1600, 900), (400, 225)),
    "a2d2": ((1920, 1208), (480, 302)),
    "skitti_crop": ((1241, 376), (480, 302)),
    "vkitti_half": ((1242, 375), (621, 188)),
    "upscale": ((300, 200), (480, 302)),
    "odd_small": ((7, 5), (3, 11)),
    "odd_small_up": ((3, 2), (13, 9)),
    "one_pixel": ((1, 1), (4, 3)),
}


def _numpy(monkeypatch, fn, *args):
    with monkeypatch.context() as mp:
        mp.setenv("MM2D3D_HOST_NATIVE", "0")
        return fn(*args)


def _layout(a):
    """Strides of the axes longer than one: the memory order."""
    return [s for s, n in zip(a.strides, a.shape) if n > 1]


def _image(in_wh, channels=3, seed=0):
    r = np.random.RandomState(seed)
    return r.randint(0, 256, size=(in_wh[1], in_wh[0], channels), dtype=np.uint8)


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_native_resize_is_bit_equal_to_numpy(case, monkeypatch):
    monkeypatch.delenv("MM2D3D_HOST_NATIVE", raising=False)
    in_wh, out_wh = RESIZES[case]
    img = _image(in_wh)
    out = A.bilinear_resize(img, out_wh[::-1])
    ref = _numpy(monkeypatch, A.bilinear_resize, img, out_wh[::-1])
    assert out.dtype == ref.dtype == np.float64
    assert out.shape == (out_wh[1], out_wh[0], 3)
    np.testing.assert_array_equal(out, ref)
    # numpy's memory order too: color jitter's means sum in it
    assert _layout(out) == _layout(ref)
    # the direct binding too, and the JAX package's numpy path
    np.testing.assert_array_equal(native.bilinear_resize_u8(img, out_wh[::-1]), ref)
    monkeypatch.setattr(augment_jax, "_USE_NATIVE", False)
    np.testing.assert_array_equal(augment_jax.bilinear_resize(img, out_wh[::-1]), ref)


@pytest.mark.parametrize("view", ["crop", "fliplr", "channels_4", "channels_1"])
def test_native_resize_of_views_is_bit_equal_to_numpy(view, monkeypatch):
    """Strided views (a crop, a mirrored image) and other channel counts,
    as `augment.crop_with_retry` and the datasets hand them over."""
    monkeypatch.delenv("MM2D3D_HOST_NATIVE", raising=False)
    img = _image((640, 360), channels={"channels_4": 4, "channels_1": 1}.get(view, 3))
    if view == "crop":
        img = img[37:301, 101:577]
    elif view == "fliplr":
        img = img[:, ::-1]
    assert img.flags.c_contiguous == view.startswith("channels")
    out = A.bilinear_resize(img, (151, 269))
    ref = _numpy(monkeypatch, A.bilinear_resize, img, (151, 269))
    np.testing.assert_array_equal(out, ref)
    assert _layout(out) == _layout(ref)


def _points(hw, n, seed):
    """n projected points on an (h, w) frame: a third on pixels already hit
    (duplicates, later points with other depths and labels), some negative
    (numpy wraps them)."""
    r = np.random.RandomState(seed)
    h, w = hw
    idx = np.stack([r.randint(0, h, n), r.randint(0, w, n)], 1).astype(np.int64)
    dup = r.rand(n) < 0.33
    idx[dup] = idx[r.randint(0, max(n, 1), int(dup.sum()))]
    neg = r.rand(n) < 0.05
    idx[neg] -= np.array([h, w])
    depths = r.uniform(1, 80, n)  # float64: the datasets pass the camera z
    labels = r.randint(-100, 17, n).astype(np.uint8 if seed % 2 else np.int64)
    return idx, depths, labels


@pytest.mark.parametrize("hw,n,seed", [((225, 400), 6000, 0), ((302, 480), 9000, 1),
                                       ((5, 7), 80, 2), ((9, 4), 0, 3)])
def test_native_maps_are_bit_equal_to_numpy(hw, n, seed, monkeypatch):
    monkeypatch.delenv("MM2D3D_HOST_NATIVE", raising=False)
    idx, depths, labels = _points(hw, n, seed)
    depth, lab = A.build_depth_and_label_maps(idx, depths, labels, hw)
    d_ref, l_ref = _numpy(monkeypatch, A.build_depth_and_label_maps, idx, depths,
                          labels, hw)
    assert depth.dtype == d_ref.dtype == np.float32
    assert lab.dtype == l_ref.dtype == np.int64
    np.testing.assert_array_equal(depth, d_ref)
    np.testing.assert_array_equal(lab, l_ref)
    if n:
        # the last point on a pixel wins
        last = {}
        for i, (r, c) in enumerate(idx % np.array(hw)):
            last[r, c] = i
        (r, c), i = max(last.items(), key=lambda kv: kv[1])
        assert depth[r, c] == np.float32(depths[i])


@pytest.mark.parametrize("bad", [(5, 0), (0, 7), (-6, 0), (0, -8)])
def test_maps_refuse_out_of_range_indices_as_numpy(bad, monkeypatch):
    monkeypatch.delenv("MM2D3D_HOST_NATIVE", raising=False)
    idx = np.array([[1, 1], bad], np.int64)
    args = (idx, np.ones(2), np.zeros(2, np.int64), (5, 7))
    with pytest.raises(IndexError):
        A.build_depth_and_label_maps(*args)
    with pytest.raises(IndexError):
        _numpy(monkeypatch, A.build_depth_and_label_maps, *args)


def test_host_native_0_selects_numpy(monkeypatch):
    """With MM2D3D_HOST_NATIVE=0 the library is never asked for."""
    def refuse(*args, **kwargs):
        raise AssertionError("the native path ran")

    monkeypatch.setattr(native, "bilinear_resize_u8", refuse)
    monkeypatch.setattr(native, "depth_label_maps", refuse)
    monkeypatch.setenv("MM2D3D_HOST_NATIVE", "0")
    img = _image((40, 30))
    assert A.bilinear_resize(img, (11, 13)).dtype == np.float64
    idx, depths, labels = _points((30, 40), 50, 4)
    A.build_depth_and_label_maps(idx, depths, labels, (30, 40))
    monkeypatch.setenv("MM2D3D_HOST_NATIVE", "1")
    with pytest.raises(AssertionError, match="native path ran"):
        A.bilinear_resize(img, (11, 13))
    # float images keep the numpy path whatever the switch says
    assert A.bilinear_resize(img.astype(np.float32), (11, 13)).dtype == np.float64


def test_native_path_raises_without_a_library(monkeypatch, tmp_path):
    """No quiet fallback to numpy: where the library cannot be built, the
    image ops raise."""
    monkeypatch.delenv("MM2D3D_HOST_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        A.bilinear_resize(_image((40, 30)), (11, 13))
    with pytest.raises(RuntimeError, match="cannot run"):
        A.build_depth_and_label_maps(*_points((30, 40), 50, 5), (30, 40))


def test_bench_loader_drives_each_path(monkeypatch):
    """`tools/bench_loader.py` at a tiny size without the card: each path
    runs the image ops it names (the numpy path never calls the library,
    the cache path never resizes) and reports a rate."""
    from mm2d3d_tpu_torch.tools import bench_loader

    monkeypatch.delenv("MM2D3D_HOST_NATIVE", raising=False)
    resized = []
    resize = native.bilinear_resize_u8
    monkeypatch.setattr(native, "bilinear_resize_u8",
                        lambda *a: resized.append(1) or resize(*a))
    per_path = []
    rate = bench_loader.loader_rate

    def counted(cfg, native, epochs):
        n = len(resized)
        out = rate(cfg, native, epochs)
        per_path.append(len(resized) - n)
        return out

    monkeypatch.setattr(bench_loader, "loader_rate", counted)
    out = bench_loader.main(["--scans", "4", "--points", "1500", "--batch", "2",
                             "--epochs", "1", "--no-step"])
    assert sorted(out["results"]) == sorted(bench_loader.PATHS)
    assert all(v > 0 for v in out["results"].values())
    # warm-up batch + one epoch of 4 scans on the native path, none elsewhere
    assert per_path == [0, 2 + 4, 0]
    assert "stage_device_step_ms" not in out
