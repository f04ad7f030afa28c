"""The coarsest level's neighbour table by key search, against the JAX package.

`mm2d3d_tpu_torch.ops.keys` searches the sorted (hi, lo) Morton pairs with
one `torch.searchsorted` over packed int64 keys; the JAX package runs a
branchless binary search.  Held here: the four key functions on random
pairs (negative lo, INVALID rows and queries, absent keys); `build_nbr` at
the coarsest fs 64 of the shipped configs above the dense map's 16 scans,
at fs 2048 and without `num_batches`; its two branches against each other;
`coarsen`; a whole 17-scan topology; and the CLI evaluating 17 scans per
batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_equal, jax_batch, two_threads  # noqa: F401  (fixture)
from test_torch_topology import GRID_FIELDS, LEVEL_FIELDS, TRANS_FIELDS, _compare

from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.ops import hierarchy as HJ
from mm2d3d_tpu.ops import keys as KJ
from mm2d3d_tpu.ops.voxelize import voxelize as voxelize_jax
from mm2d3d_tpu.train.batch import build_topology as build_topology_jax
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.ops import hierarchy as H
from mm2d3d_tpu_torch.ops import keys as K
from mm2d3d_tpu_torch.ops.voxelize import voxelize
from mm2d3d_tpu_torch.train.batch import build_topology

INVALID = np.iinfo(np.int32).max


def _table_and_queries(seed, n=600, n_invalid=40, n_query=(26, 50)):
    """A sorted unique pair table (signed lo, INVALID rows last) and queries:
    a third present, a third absent, a third INVALID."""
    r = np.random.RandomState(seed)
    hi = r.randint(0, 40, size=n).astype(np.int32)
    lo = r.randint(-2 ** 31, 2 ** 31 - 1, size=n, dtype=np.int64).astype(np.int32)
    lo[: n // 8] = r.choice([-1, 0, 1, -2 ** 31], size=n // 8)
    pairs = np.unique(np.stack([hi, lo], 1), axis=0)  # sorted, (hi, lo) order
    t_hi = np.concatenate([pairs[:, 0], np.full(n_invalid, INVALID, np.int32)])
    t_lo = np.concatenate([pairs[:, 1], np.full(n_invalid, INVALID, np.int32)])
    pick = r.randint(0, len(pairs), size=n_query)
    q_hi, q_lo = pairs[pick, 0].copy(), pairs[pick, 1].copy()
    kind = r.randint(0, 3, size=n_query)
    absent = kind == 1  # neighbours of present keys, mostly not in the table
    q_lo[absent] += r.choice([-1, 1], size=int(absent.sum())).astype(np.int32)
    q_hi[kind == 2] = INVALID
    q_lo[kind == 2] = np.where(r.rand(int((kind == 2).sum())) < 0.5, INVALID,
                               r.randint(-5, 5, size=int((kind == 2).sum())))
    return (t_hi.astype(np.int32), t_lo.astype(np.int32),
            q_hi.astype(np.int32), q_lo.astype(np.int32))


@pytest.mark.parametrize("fn", ["pairs_less", "pairs_equal", "searchsorted_pairs",
                                "lookup_pairs"])
@pytest.mark.parametrize("seed", [0, 1])
def test_key_search_matches_jax(fn, seed):
    t_hi, t_lo, q_hi, q_lo = _table_and_queries(seed)
    tt = [torch.from_numpy(a) for a in (t_hi, t_lo, q_hi, q_lo)]
    tj = [jnp.asarray(a) for a in (t_hi, t_lo, q_hi, q_lo)]
    if fn in ("pairs_less", "pairs_equal"):
        # query pairs against query pairs in another order: equal, less and
        # greater in hi and in lo of either sign
        r = np.random.RandomState(seed + 10)
        perm = r.permutation(q_hi.size).reshape(q_hi.shape)
        b = [q_hi.reshape(-1)[perm], q_lo.reshape(-1)[perm]]
        out = getattr(K, fn)(tt[2], tt[3], *map(torch.from_numpy, b))
        ref = getattr(KJ, fn)(tj[2], tj[3], *map(jnp.asarray, b))
    elif fn == "searchsorted_pairs":
        out, ref = K.searchsorted_pairs(*tt), KJ.searchsorted_pairs(*tj)
        assert out.dtype == torch.int32
    else:
        n = len(t_hi)
        out = K.lookup_pairs(*tt, missing=n)
        ref = KJ.lookup_pairs(*tj, missing=n)
        assert out.dtype == torch.int32
        found = out.numpy() < n
        assert not found[q_hi == INVALID].any()  # INVALID queries never match
        assert found.any() and not found.all()
    assert_equal(out, ref, fn)


def _grids(seed, batches, fs, n=3000, capacity=2500):
    """The port's and the JAX package's voxel grid of the same random
    points (10% masked) over `batches` scans at `fs`, dense enough for
    neighbours: most in the top corner, a few at the origin (both edges)."""
    r = np.random.RandomState(seed)
    coords = r.randint(fs - 16, fs, size=(n, 3)).astype(np.int32)
    coords[: n // 10] = r.randint(0, 3, size=(n // 10, 3))
    batch = r.randint(0, batches, size=n).astype(np.int32)
    valid = r.rand(n) < 0.9
    grid = voxelize(torch.from_numpy(coords), torch.from_numpy(batch),
                    torch.from_numpy(valid), full_scale=fs, capacity=capacity)
    ref = voxelize_jax(jnp.asarray(coords), jnp.asarray(batch), jnp.asarray(valid),
                       fs, capacity=capacity)
    return grid, ref


@pytest.mark.parametrize("batches", [17, 24, 32])
def test_build_nbr_search_matches_jax(batches):
    """fs 64, the coarsest level of full_scale 4096 at 7 planes: above 16
    scans the dense map's 4M cells are exceeded and both packages search."""
    assert 64 ** 3 * batches > H._DENSE_NBR_MAX_ENTRIES
    grid, ref = _grids(batches, batches, 64)
    nbr = H.build_nbr(grid, num_batches=batches)
    assert nbr.dtype == torch.int32 and nbr.shape == (27, grid.capacity)
    assert_equal(nbr, HJ.build_nbr(ref, num_batches=batches), "nbr")
    off = torch.cat([nbr[:H.CENTER], nbr[H.CENTER + 1:]])
    assert int((off < grid.capacity).sum()) > 1000  # the grid has neighbours


@pytest.mark.parametrize("batches", [4, 16])
def test_dense_and_search_branches_agree(batches):
    assert 64 ** 3 * batches <= H._DENSE_NBR_MAX_ENTRIES
    grid, ref = _grids(100 + batches, batches, 64)
    dense = H.build_nbr(grid, num_batches=batches)
    assert_equal(H.build_nbr(grid), dense, "search vs dense")
    assert_equal(dense, HJ.build_nbr(ref, num_batches=batches), "dense vs JAX")


@pytest.mark.parametrize("fs,batches", [(2048, 1), (2048, None), (64, None)])
def test_build_nbr_large_scale_and_no_batch_count_match_jax(fs, batches):
    """fs > 1024 (the Morton key spills into hi) and `num_batches=None`
    (`coarsen`'s and a standalone level's call) take the search."""
    grid, ref = _grids(7, batches or 3, fs)
    assert_equal(H.build_nbr(grid, num_batches=batches),
                 HJ.build_nbr(ref, num_batches=batches), "nbr")


@pytest.mark.parametrize("capacity", [None, 600])
def test_coarsen_matches_jax(capacity):
    grid, ref = _grids(3, 5, 128)
    level = H._level(grid, H.build_nbr(grid))
    level_j = HJ._level_from_grid(ref)
    coarse, trans = H.coarsen(level, capacity=capacity)
    coarse_j, trans_j = HJ.coarsen(level_j, capacity=capacity)
    _compare(coarse, coarse_j, LEVEL_FIELDS, "coarse")
    _compare(trans, trans_j, TRANS_FIELDS, "trans")
    assert coarse.full_scale == coarse_j.full_scale == 64


def test_17_scan_topology_matches_jax(two_threads):  # noqa: F811
    """A whole `build_topology` of 17 scans at full_scale 4096 and 7 planes
    (the shipped shape): the coarsest table by search, every table of every
    level and transition equal to JAX's."""
    kw = dict(batch_size=17, height=16, width=24, n_points=384, full_scale=4096)
    searched = []
    lookup = K.lookup_pairs

    def counting(*args, **kwargs):
        searched.append(args[2].shape)
        return lookup(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "lookup_pairs", counting)
        grid, hier = build_topology(make_batch(np.random.RandomState(4), **kw), 4096, 7)
    assert searched == [(26, hier.levels[-1].capacity)]
    ref_grid, ref_hier = jax.jit(lambda b: build_topology_jax(b, 4096, 7))(
        jax_batch(make_batch_jax(np.random.RandomState(4), **kw)))
    _compare(grid, ref_grid, GRID_FIELDS, "grid")
    for l, (a, b) in enumerate(zip(hier.levels, ref_hier.levels)):
        _compare(a, b, LEVEL_FIELDS, f"level{l}")
    for l, (a, b) in enumerate(zip(hier.transitions, ref_hier.transitions)):
        _compare(a, b, TRANS_FIELDS, f"trans{l}")
    assert hier.levels[-1].full_scale == 64
    assert int(hier.levels[-1].num_voxels) > 17 * 8


def test_cli_evaluates_17_scans_per_batch(tmp_path):
    """The CLI on tests/test_torch_trainer.py's tiny workspace (full_scale
    256, 3 planes: coarsest fs 64) with 17 scans per split and
    `run.test_batch_size=17`: validation and test take the search branch
    and finish with finite metrics."""
    from test_torch_data import write_nuscenes
    from test_torch_trainer import write_workspace

    from mm2d3d_tpu_torch.run import main

    ws = write_workspace(tmp_path)
    write_nuscenes(str(ws / "data"), np.random.RandomState(17), scans_per_split=17)
    searched = []
    lookup = K.lookup_pairs

    def counting(*args, **kwargs):
        searched.append(int(args[2].shape[1]))
        return lookup(*args, **kwargs)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(K, "lookup_pairs", counting)
            trainer, results = main([
                "--config", str(ws / "configs" / "config.yaml"), "--device", "cpu",
                "run.test_batch_size=17"])
        assert trainer.global_step == 2
        # one val and one test batch of 17 scans, each one searched table;
        # the train batches of 2 take the dense map
        assert len(searched) >= 2
        assert {"test/target/iou", "test/target/iou_3d"} <= set(results)
        assert all(np.isfinite(v) for v in results.values())
    finally:
        import shutil

        shutil.rmtree(ws / "runs", ignore_errors=True)
