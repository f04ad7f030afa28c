"""ctypes binding of the host library (`csrc/host_ops.cpp`): the loader's
image ops and the host topology.

The library is compiled with ``g++`` at first use into
``mm2d3d_tpu_torch/_build/``; its file name carries a hash of the source,
the flags and the host CPU's model and instruction-set flags (the build
takes ``-march=native``), so an edited source is rebuilt, and a library
built on another kind of CPU is never loaded.  Processes that build at the
same time (test workers, loader processes) serialise on a file lock, and
each build writes a temporary file that is renamed into place, so no
process loads a half-written library.

There is no fallback: when the library cannot be built or loaded, `lib()`
raises, and so does every caller (`data.augment`'s image ops unless
``MM2D3D_HOST_NATIVE=0``, `data.host_topology`, a trainer with
`host_topology=True`).  The calls release the GIL (ctypes), so topologies
build in threads beside the train step.  ``-ffp-contract=off`` keeps the
image ops bit-equal to numpy: no multiply and add is fused.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
             "-fopenmp", "-std=c++17", "-Wall")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32 = ctypes.c_int32
_i64 = ctypes.c_int64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_id() -> bytes:
    """The host CPU's model name and flags lines (Linux), or the machine."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f if ln.startswith((b"model name", b"flags"))]
        return b"".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(_cpu_id())
    return os.path.join(BUILD_DIR, f"libhost_ops-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless an up-to-date build exists -> its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "host_ops.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [CXX, *CXX_FLAGS, "-o", tmp, SOURCE]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX} to build the host topology "
                               f"library: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed for {SOURCE} (rc {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built first if need be; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            so.bilinear_resize_u8.argtypes = [
                ctypes.c_void_p, _i64, _i64, _i64, _i32, _i32, _i32, _f64p, _i32,
                _i32,
            ]
            so.depth_label_maps.argtypes = [
                _i64p, _f32p, _i64p, _i64, _i32, _i32, _f32p, _i64p,
            ]
            so.voxelize_dedup.restype = _i32
            so.voxelize_dedup.argtypes = [
                _i32p, _i32p, _u8p, _i32, _i32, _i32, _i32p, _i32p, _i32p, _i32p,
            ]
            so.build_nbr27.argtypes = [_i32p, _i32p, _i32, _i32, _i32, _i32p]
            so.build_transition.argtypes = [
                _i32p, _i32p, _i32, _i32, _i32p, _i32p, _i32, _i32, _i32,
                _i32p, _i32p, _i32p,
            ]
            so.build_slots_tiered.restype = ctypes.c_int64
            so.build_slots_tiered.argtypes = [_i32p] + [_i32] * 6 + [_i32p] * 9
            _lib = so
        return _lib


def _i32a(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def bilinear_resize_u8(image: np.ndarray, out_hw) -> np.ndarray:
    """(H, W, C) uint8 image (any strides) -> (out_h, out_w, C) float64,
    bit-equal to `data.augment.bilinear_resize`'s numpy path and in its
    memory order (x-major), so that later reductions sum alike."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise TypeError(f"want an (H, W, C) uint8 image, got {image.dtype} "
                        f"{image.shape}")
    out_h, out_w = (int(v) for v in out_hw)
    in_h, in_w, c = image.shape
    if min(in_h, in_w, c, out_h, out_w) <= 0:
        raise ValueError(f"empty resize {image.shape} -> {(out_h, out_w)}")
    out = np.empty((out_w, out_h, c), np.float64)
    lib().bilinear_resize_u8(image.ctypes.data, *image.strides, in_h, in_w, c,
                             out, out_h, out_w)
    return out.transpose(1, 0, 2)


def depth_label_maps(img_indices, depths, labels, hw):
    """Sparse float32 depth map and int64 label map (-100 where no point
    lands) of projected points, as `data.augment.build_depth_and_label_maps`'s
    numpy fancy assignment (negative indices wrap, the last point on a pixel
    wins, an index outside [-h, h) x [-w, w) raises IndexError)."""
    h, w = (int(v) for v in hw)
    idx = np.asarray(img_indices)
    if not np.issubdtype(idx.dtype, np.integer):
        raise IndexError(f"image indices must be integers, got {idx.dtype}")
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1, 2)
    n = len(idx)
    depths = np.ascontiguousarray(np.broadcast_to(depths, (n,)), np.float32)
    labels = np.ascontiguousarray(np.broadcast_to(labels, (n,)), np.int64)
    if n and not ((-h <= idx[:, 0]).all() and (idx[:, 0] < h).all()
                  and (-w <= idx[:, 1]).all() and (idx[:, 1] < w).all()):
        raise IndexError(f"an image index lies outside ({h}, {w})")
    depth_map = np.empty((h, w), np.float32)
    label_map = np.empty((h, w), np.int64)
    lib().depth_label_maps(idx, depths, labels, n, h, w, depth_map, label_map)
    return depth_map, label_map


def voxelize_dedup(coords, batch, valid, full_scale: int, capacity: int):
    """Sorted, deduplicated voxel table of (P, 3) coords -> (vox_coords
    (cap, 3), vox_batch (cap,), p2v (P,), counts (cap,), num_voxels): the
    host counterpart of `ops.voxelize.voxelize`."""
    n = len(coords)
    vox_coords = np.empty((capacity, 3), np.int32)
    vox_batch = np.empty((capacity,), np.int32)
    p2v = np.empty((n,), np.int32)
    counts = np.empty((capacity,), np.int32)
    nvox = lib().voxelize_dedup(
        _i32a(coords), _i32a(batch), np.ascontiguousarray(valid, np.uint8), n,
        full_scale, capacity, vox_coords, vox_batch, p2v, counts)
    return vox_coords, vox_batch, p2v, counts, int(nvox)


def build_nbr27(vox_coords, vox_batch, num_voxels: int, capacity: int,
                full_scale: int) -> np.ndarray:
    """(cap, 27) neighbour rows (the transpose of `GridLevel.nbr`)."""
    nbr = np.empty((capacity, 27), np.int32)
    lib().build_nbr27(_i32a(vox_coords), _i32a(vox_batch), num_voxels, capacity,
                      full_scale, nbr)
    return nbr


def build_slots_tiered(nbr_rows, h1: int, h2: int, h_max: int, vm_cap: int,
                       vh_cap: int):
    """The 3-tier slot tables of `ops.hierarchy.build_hierarchy` from (cap,
    27) neighbour rows, in the device's tap-major layout -> (src1, tap1,
    idxm, invm, srcm, tapm, idxh, srch, taph, dropped).  The 2-tier form
    is h2 == h_max with vh_cap == 0 (its heavy tier is the mid tier here)."""
    nbr_rows = _i32a(nbr_rows)
    cap = nbr_rows.shape[0]
    src1 = np.empty((h1, cap), np.int32)
    tap1 = np.empty((h1, cap), np.int32)
    idxm = np.empty((vm_cap,), np.int32)
    invm = np.empty((cap,), np.int32)
    srcm = np.empty((h2 - h1, vm_cap), np.int32)
    tapm = np.empty((h2 - h1, vm_cap), np.int32)
    idxh = np.empty((vh_cap,), np.int32)
    srch = np.empty((h_max - h2, vh_cap), np.int32)
    taph = np.empty((h_max - h2, vh_cap), np.int32)
    dropped = lib().build_slots_tiered(
        nbr_rows, cap, h1, h2, h_max, vm_cap, vh_cap,
        src1, tap1, idxm, invm, srcm, tapm, idxh, srch, taph)
    return (src1, tap1, idxm, invm, srcm, tapm, idxh, srch, taph,
            np.int32(dropped))


def build_transition(fine_coords, fine_batch, nvox_f: int, cap_f: int,
                     coarse_coords, coarse_batch, nvox_c: int, cap_c: int,
                     full_scale_c: int):
    """-> (parent (cap_f,), off_id (cap_f,), child (cap_c, 8)), as
    `ops.hierarchy.LevelTransition`."""
    parent = np.empty((cap_f,), np.int32)
    off_id = np.empty((cap_f,), np.int32)
    child = np.empty((cap_c, 8), np.int32)
    lib().build_transition(
        _i32a(fine_coords), _i32a(fine_batch), nvox_f, cap_f,
        _i32a(coarse_coords), _i32a(coarse_batch), nvox_c, cap_c, full_scale_c,
        parent, off_id, child)
    return parent, off_id, child
