"""Topology of mm2d3d_tpu_torch vs the JAX package: keys, voxelize, the
whole hierarchy build and the K3 plain version, all bit-identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_equal, jax_batch

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops import keys as KJ
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu.train import batch as BJ
from mm2d3d_tpu.train.batch import build_topology as build_topology_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import keys as K
from mm2d3d_tpu_torch.ops.kernels.propagate import propagate_slots, propagate_slots_ref
from mm2d3d_tpu_torch.ops.voxelize import voxelize
from mm2d3d_tpu_torch.train import batch as B
from mm2d3d_tpu_torch.train.batch import build_topology

GRID_FIELDS = ("key_hi", "key_lo", "coords", "batch", "valid", "num_voxels",
               "p2v", "counts", "sort_perm", "seg_sorted", "valid_sorted")
LEVEL_FIELDS = ("key_hi", "key_lo", "coords", "batch", "valid", "num_voxels",
                "nbr", "slot_src", "slot_tap", "slot_overflow", "slot_idx",
                "slot_src2", "slot_tap2", "slot_idxm", "slot_invm",
                "slot_srcm", "slot_tapm")
TRANS_FIELDS = ("parent", "off_id", "child")


def _compare(port, ref, fields, where):
    for name in fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), f"{where}.{name}"
        if a is not None:
            assert_equal(a, b, f"{where}.{name}")


def test_pack_unpack_match_jax(rng):
    coords = rng.randint(0, 4096, size=(4096, 3)).astype(np.int32)
    batch = rng.randint(0, 8, size=(4096,)).astype(np.int32)
    hi, lo = K.pack(torch.from_numpy(coords), torch.from_numpy(batch))
    hij, loj = KJ.pack(jnp.asarray(coords), jnp.asarray(batch))
    assert hi.dtype == lo.dtype == torch.int32
    assert_equal(hi, hij, "hi")
    assert_equal(lo, loj, "lo")
    c, b = K.unpack(hi, lo)
    assert_equal(c, coords, "coords")
    assert_equal(b, batch, "batch")


@pytest.mark.parametrize("presorted", [False, True])
def test_voxelize_matches_jax(rng, presorted):
    if presorted:
        src = make_batch(np.random.RandomState(3), batch_size=2, height=32,
                         width=48, n_points=512, full_scale=64)
        coords = src.coords.reshape(-1, 3).numpy()
        valid = src.point_mask.reshape(-1).numpy()
    else:
        coords = rng.randint(-2, 34, size=(1024, 3)).astype(np.int32)
        valid = rng.rand(1024) < 0.9
    batch = np.repeat(np.arange(2, dtype=np.int32), len(coords) // 2)
    kw = dict(full_scale=64 if presorted else 32, capacity=700, presorted=presorted)
    grid = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                    torch.from_numpy(valid), **kw)
    ref = voxelize_jax(jnp.asarray(coords), jnp.asarray(batch),
                       jnp.asarray(valid), **kw)
    _compare(grid, ref, GRID_FIELDS, "grid")


def _small_two_level(seed):
    r = np.random.RandomState(seed)
    n, fs = 1200, 32
    coords = r.randint(0, fs, size=(n, 3)).astype(np.int32)
    batch = r.randint(0, 2, size=(n,)).astype(np.int32)
    valid = r.rand(n) < 0.9
    grid = voxelize_jax(jnp.asarray(coords), jnp.asarray(batch),
                        jnp.asarray(valid), fs, capacity=1024)
    grid_c, trans = HJ._coarsen_grid(grid, capacity=512)
    return grid, trans, HJ.build_nbr(grid_c)


@pytest.mark.parametrize("h1", [3, 8])
def test_propagate_plain_version_matches_pallas_interpret(h1):
    """K3's plain version (the CPU route of the wrapper) vs the Pallas kernel
    in interpret mode, on the JAX package's own candidates."""
    grid, trans, nbr_c = _small_two_level(h1)
    crows = HJ._propagate_candidates(grid, trans, nbr_c)
    par = (grid.coords & 1).T.astype(jnp.int32)
    valid = grid.valid.astype(jnp.int32)[None, :]
    ref = HJ.propagate_nbr_slots(grid, trans, nbr_c, h1, interpret=True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    for fn in (propagate_slots_ref, propagate_slots):
        out = fn(t(crows), t(par), t(valid), h1)
        for name, a, b in zip(("nbr", "src1", "tap1", "cnt"), out, ref):
            assert a.dtype == torch.int32
            assert_equal(a, b, f"{fn.__name__}.{name}")


def test_propagate_candidates_match_jax():
    grid, trans, nbr_c = _small_two_level(5)
    ref = HJ._propagate_candidates(grid, trans, nbr_c)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    from mm2d3d_tpu_torch.ops.voxelize import VoxelGrid

    fine = VoxelGrid(key_hi=t(grid.key_hi), key_lo=t(grid.key_lo),
                     coords=t(grid.coords), batch=t(grid.batch),
                     valid=t(grid.valid), num_voxels=t(grid.num_voxels),
                     p2v=t(grid.p2v), counts=t(grid.counts), full_scale=32)
    tr = H.LevelTransition(parent=t(trans.parent), off_id=t(trans.off_id),
                           child=t(trans.child))
    assert_equal(H._propagate_candidates(fine, tr, t(nbr_c)), ref, "crows")


def test_build_nbr_refuses_large_grids():
    """Grids past the dense map (fs > 1024) are no longer refused: the
    table comes from the key search and equals JAX's."""
    coords = np.array([[0, 0, 0], [0, 0, 1], [1, 1, 1], [2047, 2047, 2047]], np.int32)
    args = (np.zeros(4, np.int32), np.ones(4, bool))
    g = voxelize(torch.from_numpy(coords), *map(torch.from_numpy, args),
                 full_scale=2048)
    ref = voxelize_jax(jnp.asarray(coords), *map(jnp.asarray, args), 2048)
    nbr = H.build_nbr(g, num_batches=1)
    assert_equal(nbr, HJ.build_nbr(ref, num_batches=1), "nbr")
    assert int((nbr < 4).sum()) == 4 + 6  # centres; 0-1, 0-2, 1-2 both ways


SIZES = {
    # dryrun: every level 3-tier, the coarsest built without propagation
    "dryrun": (dict(batch_size=2, height=32, width=48, n_points=128,
                    full_scale=256), 256, 3),
    # flagship scale: 2-tier levels 5-6, coarsest build_slots_split and the
    # dense-map build_nbr at full_scale 64
    "flagship": (dict(batch_size=2, height=32, width=48, n_points=8192,
                      full_scale=4096), 4096, 7),
}


@pytest.mark.parametrize("size", sorted(SIZES))
def test_build_topology_matches_jax(size):
    kw, fs, planes = SIZES[size]
    port_grid, port_hier = build_topology(
        make_batch(np.random.RandomState(0), **kw), fs, planes)
    ref_grid, ref_hier = jax.jit(
        lambda b: build_topology_jax(b, fs, planes)
    )(jax_batch(make_batch_jax(np.random.RandomState(0), **kw)))

    _compare(port_grid, ref_grid, GRID_FIELDS, "grid")
    assert len(port_hier.levels) == len(ref_hier.levels) == planes
    for l, (a, b) in enumerate(zip(port_hier.levels, ref_hier.levels)):
        _compare(a, b, LEVEL_FIELDS, f"level{l}")
        # the voxel-overflow monitor of the train/eval logs
        assert bool(a.num_voxels >= a.capacity) == bool(b.num_voxels >= b.capacity)
    for l, (a, b) in enumerate(zip(port_hier.transitions, ref_hier.transitions)):
        _compare(a, b, TRANS_FIELDS, f"trans{l}")
    # both overflow counts of a healthy build are zero
    assert sum(int(l.slot_overflow) for l in port_hier.levels) == 0
    assert all(int(l.num_voxels) < l.capacity for l in port_hier.levels)
    if size == "flagship":
        assert port_hier.levels[5].slot_srcm is None
        assert port_hier.levels[5].slot_src2 is not None


@pytest.mark.parametrize("num_points", [2048, 65536, 131072, 163840])
@pytest.mark.parametrize("profile", ["default", "dense"])
def test_capacities_and_slot_caps_match_jax(profile, num_points):
    """Both profiles' level capacities and slot specs over a sweep of point
    counts, batch sizes and depths, and the specs of the JAX default
    capacities (65,536 rows) without any."""
    for batch_size in (None, 1, 4, 8, 16):
        for levels in (3, 7):
            caps = B.default_capacities(num_points, levels, batch_size, profile)
            assert caps == BJ.default_capacities(num_points, levels, batch_size, profile)
            assert (B.default_slot_caps(levels, caps, profile)
                    == BJ.default_slot_caps(levels, caps, profile))
    assert B.default_slot_caps(7, profile=profile) == BJ.default_slot_caps(7, profile=profile)


def test_unknown_slot_profile_raises():
    with pytest.raises(ValueError, match="unknown slot profile"):
        B.default_slot_caps(7, B.default_capacities(8192, 7), "sparse")
    with pytest.raises(ValueError, match="unknown slot profile"):
        build_topology(make_batch(np.random.RandomState(0), **SIZES["dryrun"][0]),
                       256, 3, slot_profile="sparse")


KITTI = dict(batch_size=4, height=32, width=48, n_points=10240, num_classes=10,
             full_scale=4096, variant="kitti")


@pytest.mark.parametrize("profile", ["dense", "default"])
def test_kitti_topology_matches_jax(profile):
    """64-beam scans at batch 4 x 10,240 (tests/test_spconv.py's case): the
    `dense` profile's tables identical to JAX's with no hit dropped; the
    `default` profile drops hits there, the same number in both."""
    port_grid, port_hier = build_topology(
        make_batch(np.random.RandomState(0), **KITTI), 4096, 7, slot_profile=profile)
    ref_grid, ref_hier = jax.jit(
        lambda b: build_topology_jax(b, 4096, 7, slot_profile=profile)
    )(jax_batch(make_batch_jax(np.random.RandomState(0), **KITTI)))
    _compare(port_grid, ref_grid, GRID_FIELDS, "grid")
    for l, (a, b) in enumerate(zip(port_hier.levels, ref_hier.levels)):
        _compare(a, b, LEVEL_FIELDS, f"level{l}")
        assert a.capacity == b.capacity
    for l, (a, b) in enumerate(zip(port_hier.transitions, ref_hier.transitions)):
        _compare(a, b, TRANS_FIELDS, f"trans{l}")
    dropped = sum(int(l.slot_overflow) for l in port_hier.levels
                  if l.slot_overflow is not None)
    assert dropped == sum(int(l.slot_overflow) for l in ref_hier.levels
                          if l.slot_overflow is not None)
    assert (dropped == 0) == (profile == "dense")
    assert all(int(l.num_voxels) < l.capacity for l in port_hier.levels)
