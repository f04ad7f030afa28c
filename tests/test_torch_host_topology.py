"""The host (C++) topology of mm2d3d_tpu_torch (`native`,
`data.host_topology`) against the port's device-path `build_topology` and
the JAX package's `build_topology_host`, on the CPU.

- Every table equal, bit for bit, to the port's `build_topology` (the sort
  fields of the grid included), under both slot profiles, for presorted
  loader batches, unsorted ones and random points with out-of-range and
  masked entries, with and without child slots
  (`child_slot_caps="default"`).  Where a level overflows its capacity
  (which the train step's `voxel_overflow_levels` monitor reports), the
  voxel tables and the transitions still agree; the neighbour tables do
  not, as in the JAX package: the device path propagates them through the
  coarse tables, which miss the dropped voxels, and the host path looks
  every neighbour up.
- Every table the JAX package's host build makes equal, bit for bit, to the
  port's, the slot profile passed to both (with the port's capacities:
  the JAX host build takes the default profile's when it is given none).
  That build is a private copy of the JAX package's host library, made
  from the same sources in a temporary directory: the JAX loader builds
  its shared copy in place without a lock between processes, and a test
  process that loads it half-written keeps the failure for its lifetime.
- An fp32 train step with host-built topologies bit-equal to one with
  device-built ones, and a `Trainer(host_topology=True)` fit bit-equal to
  one with `host_topology=False`; the CLI with `train.host_topology: true`
  reaches the host path; a broken compiler raises; concurrent first
  builds are safe.
"""

import contextlib
import dataclasses
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import assert_equal
from _torch_port import two_threads  # noqa: F401  (fixture)
from test_torch_trainer import nusc, tmp_path, workspace  # noqa: F401  (fixtures)
from test_torch_trainer import Recorder, _differing, loaders

from mm2d3d_tpu_torch import native
from mm2d3d_tpu_torch.data import host_topology as HT
from mm2d3d_tpu_torch.data.loader import prefetch_topology_pairs
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.tools.train_repro import differing, snapshot
from mm2d3d_tpu_torch.train.batch import build_topology, default_capacities

pytestmark = pytest.mark.usefixtures("two_threads")

FS, LEVELS = 256, 4
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMALL = dict(full_scale=256, num_planes=3, m=8)
BATCH = dict(batch_size=2, height=32, width=48, n_points=512, full_scale=FS)


def _batch(kind: str, seed: int = 0):
    """A PointBatch of one kind: "loader" (presorted, as the loaders'),
    "unsorted" (the same points shuffled), "random" (uniform points with
    out-of-range coordinates and masked entries)."""
    b = make_batch(np.random.RandomState(seed), **BATCH)
    if kind == "loader":
        return b
    r = np.random.RandomState(seed + 100)
    if kind == "unsorted":
        perm = torch.from_numpy(r.permutation(b.n_points))
        return dataclasses.replace(b, coords=b.coords[:, perm],
                                   point_mask=b.point_mask[:, perm],
                                   coords_sorted=False)
    # a box small enough that no level overflows and voxels have many hits
    coords = r.randint(-2, 14, size=b.coords.shape).astype(np.int32)
    return dataclasses.replace(b, coords=torch.from_numpy(coords),
                               point_mask=torch.from_numpy(r.rand(*b.point_mask.shape) < 0.9),
                               coords_sorted=False)


def _tables(topo):
    grid, hier = topo
    for where, obj in [("grid", grid)] + [(f"L{i}", x) for i, x in enumerate(hier.levels)] \
            + [(f"T{i}", x) for i, x in enumerate(hier.transitions)]:
        for f in dataclasses.fields(obj):
            yield f"{where}.{f.name}", getattr(obj, f.name)


def _assert_same(port, ref):
    a, b = dict(_tables(port)), dict(_tables(ref))
    assert a.keys() == b.keys()
    n = 0
    for name, x in a.items():
        y = b[name]
        assert (x is None) == (y is None), name
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(x, y), name
            n += 1
        else:
            assert x == y, name
    return n


@pytest.mark.parametrize("child", [None, "default"])
@pytest.mark.parametrize("kind", ["loader", "unsorted", "random"])
@pytest.mark.parametrize("profile", ["default", "dense"])
def test_host_topology_equals_device_build(profile, kind, child):
    batch = _batch(kind, seed=3)
    kw = dict(slot_profile=profile, child_slot_caps=child)
    host = HT.topology_for_batch(batch, FS, LEVELS, **kw)
    dev = build_topology(batch, FS, LEVELS, **kw)
    assert _assert_same(host, dev) > 40
    grid, hier = host
    assert (grid.sort_perm is None) == (kind == "loader")
    assert all(int(l.num_voxels) < l.capacity for l in hier.levels)
    assert (hier.transitions[0].cslot_src is None) == (child is None)


VOXEL_TABLES = ("key_hi", "key_lo", "coords", "batch", "valid", "num_voxels")


@pytest.mark.parametrize("profile", ["default", "dense"])
def test_host_topology_under_overflow(profile):
    batch = _batch("unsorted", seed=4)
    caps = tuple(c // 4 for c in default_capacities(2 * 512, LEVELS, 2, profile))
    host, dev = (fn(batch, FS, LEVELS, capacities=caps, slot_profile=profile)
                 for fn in (HT.topology_for_batch, build_topology))
    assert int(host[1].levels[0].num_voxels) == caps[0]
    grid_host, grid_dev = dict(_tables((host[0], host[1]))), dict(_tables(dev))
    for name, a in grid_host.items():
        if name.startswith("grid."):
            b = grid_dev[name]
            assert (a is None) == (b is None), name
            assert a is None or (torch.equal(a, b) if isinstance(a, torch.Tensor)
                                 else a == b), name
    for a, b in zip(host[1].levels, dev[1].levels):
        for name in VOXEL_TABLES:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    for a, b in zip(host[1].transitions, dev[1].transitions):
        for name in ("parent", "off_id", "child"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


@contextlib.contextmanager
def private_jax_host_lib(directory):
    """The JAX package's host library built from its sources
    (csrc/host_ops.cpp, csrc/Makefile) in `directory` and loaded from there:
    `mm2d3d_tpu.native`'s library path, loaded library and latched build
    failure point at the private copy inside the block and are restored
    after it.  The shared copy under csrc/ is built in place by whichever
    process asks first, with no lock between processes, so a test worker
    can load it half-written and latch `_build_failed` for its lifetime."""
    from mm2d3d_tpu import native as native_jax

    for name in ("host_ops.cpp", "Makefile"):
        shutil.copy(osp.join(REPO, "csrc", name), osp.join(directory, name))
    subprocess.run(["make", "-C", str(directory)], check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_jax, "_LIB_PATH", osp.join(directory, "libmm2d3d_host.so"))
        mp.setattr(native_jax, "_lib", None)
        mp.setattr(native_jax, "_build_failed", False)
        yield native_jax


@pytest.fixture(scope="module")
def jax_host_lib(tmp_path_factory):
    with private_jax_host_lib(tmp_path_factory.mktemp("jax_host_lib")) as native_jax:
        yield native_jax


def test_private_jax_host_lib_survives_a_broken_shared_copy(tmp_path):
    """The failure the private copy prevents: a truncated library at the
    shared path (as a concurrent in-place build leaves it) makes the JAX
    loader latch `_build_failed`, and it then refuses a whole library at
    that path too.  Inside `private_jax_host_lib` the library loads; after
    it, the module's state is back as it was."""
    from mm2d3d_tpu import native as native_jax

    whole = tmp_path / "whole"
    whole.mkdir()
    shared = tmp_path / "libmm2d3d_host.so"
    shared.write_bytes(b"\x7fELF" + bytes(36))  # the first bytes of a build
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_jax, "_LIB_PATH", str(shared))
        mp.setattr(native_jax, "_lib", None)
        mp.setattr(native_jax, "_build_failed", False)
        assert not native_jax.available() and native_jax._build_failed
        with private_jax_host_lib(whole) as private:
            assert private.available()
            assert private._LIB_PATH == str(whole / "libmm2d3d_host.so")
        assert native_jax._LIB_PATH == str(shared) and native_jax._build_failed
        shutil.copy(whole / "libmm2d3d_host.so", shared)  # latched: still refused
        assert not native_jax.available()


@pytest.mark.parametrize("child", [None, "default"])
@pytest.mark.parametrize("profile", ["default", "dense"])
def test_host_topology_equals_jax_host_build(profile, child, jax_host_lib):
    from mm2d3d_tpu.data.host_topology import build_topology_host as host_jax

    assert jax_host_lib.available()
    batch = _batch("random", seed=5)
    b, n = batch.coords.shape[:2]
    coords = batch.coords.reshape(-1, 3).numpy()
    bidx = np.repeat(np.arange(b, dtype=np.int32), n)
    valid = batch.point_mask.reshape(-1).numpy()
    caps = default_capacities(b * n, LEVELS, batch_size=b, profile=profile)
    kw = dict(capacities=caps, batch_size=b, slot_profile=profile,
              child_slot_caps=child)
    port = HT.build_topology_host(coords, bidx, valid, FS, LEVELS, **kw)
    grid_j, hier_j = host_jax(coords, bidx, valid, FS, LEVELS, **kw)
    ref = dict(_tables((grid_j, hier_j)))
    n_cmp = 0
    for name, x in _tables(port):
        if name not in ref:  # the port's own tables (L0.nbr5: a 5^3 stem's only)
            assert x is None, name
            continue
        y = ref[name]
        if y is None:  # the JAX host grid has no sort fields
            assert x is None or name in ("grid.sort_perm", "grid.seg_sorted",
                                         "grid.valid_sorted"), name
            continue
        if isinstance(x, torch.Tensor):
            assert_equal(x, y, name)
            n_cmp += 1
        else:
            assert x == y, name
    assert n_cmp > 40


def _small_task():
    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.init_params(torch.Generator().manual_seed(0))
    return task


@pytest.fixture
def one_thread():
    """One CPU thread: the CPU's multithreaded backward of the point-to-pixel
    gather adds a pixel's duplicate points in a varying order, so two runs
    of one step may differ in the last bits with several threads (the card's
    backward sorts them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["loader", "unsorted"])
def test_train_step_with_host_topologies_is_bit_equal(kind, one_thread):
    """Two steps from one state, one task building its topologies on the
    device path, the other handed host-built ones: the same bits in every
    weight, statistic, optimizer moment and log."""
    kw = dict(batch_size=2, height=32, width=48, n_points=256, full_scale=256,
              wire=True)
    pairs = []
    for s in (0, 2):
        src, trg = (make_batch(np.random.RandomState(s + i), **kw) for i in (0, 1))
        if kind == "unsorted":
            src, trg = (dataclasses.replace(x, coords_sorted=False) for x in (src, trg))
        pairs.append((src, trg))
    runs = []
    for host in (False, True):
        task, gen = _small_task(), torch.Generator().manual_seed(1)
        logs = []
        for src, trg in pairs:
            topos = ([HT.topology_for_batch(x, 256, 3) for x in (src, trg)]
                     if host else [None, None])
            logs.append(task.train_step(src, trg, gen, *topos))
        runs.append((snapshot(task, gen), logs))
    (s0, l0), (s1, l1) = runs
    assert differing(s0, s1) == []
    for a, b in zip(l0, l1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_prefetch_topology_pairs_in_order():
    batches = [make_batch(np.random.RandomState(s), **BATCH) for s in range(7)]
    pairs = list(zip(batches, batches[1:]))  # more than the 4 in flight
    out = list(prefetch_topology_pairs(iter(pairs), FS, LEVELS, "dense"))
    assert len(out) == len(pairs)
    for (src, trg), (s, t, ts, tt) in zip(pairs, out):
        assert s is src and t is trg
        _assert_same(ts, build_topology(src, FS, LEVELS, slot_profile="dense"))
        _assert_same(tt, build_topology(trg, FS, LEVELS, slot_profile="dense"))


def test_trainer_host_topology_equals_device_topologies(nusc, tmp_path):  # noqa: F811
    """Two steps of `Trainer.fit` with topologies built on the host and on
    the device path: the same logs and the same bits in every tensor of
    the task."""
    from mm2d3d_tpu_torch.train.trainer import Trainer

    runs = []
    for host in (False, True):
        task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
        src, trg = loaders(nusc)[:2]
        log = Recorder()
        trainer = Trainer(task, src, trg, ckpt_dir=str(tmp_path / str(host)),
                          limit_train_batches=2, logger=log, host_topology=host)
        trainer.fit()
        assert trainer.global_step == 2
        runs.append((trainer, log.train_logs()))
    (ref, ref_logs), (host, host_logs) = runs
    assert host_logs == ref_logs and len(ref_logs) == 2
    assert not _differing(host, ref)


def test_cli_host_topology_reaches_the_host_path(workspace, monkeypatch):  # noqa: F811
    """`train.host_topology: true` builds every train topology on the host,
    two per step, under the task's slot profile."""
    from mm2d3d_tpu_torch.run import main

    calls = []
    build = HT.topology_for_batch

    def counted(*a, **kw):
        calls.append(kw["slot_profile"])
        return build(*a, **kw)

    monkeypatch.setattr(HT, "topology_for_batch", counted)
    host, results = main(["--config", str(workspace / "configs" / "config.yaml"),
                          "--device", "cpu", "train.host_topology=true"])
    assert host.host_topology and host.global_step == 2
    assert calls == ["default"] * 4


def test_host_topology_raises_without_a_working_build(workspace, monkeypatch, tmp_path):  # noqa: F811
    from mm2d3d_tpu_torch.run import main

    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="host topology library"):
        native.lib()
    with pytest.raises(RuntimeError, match="host topology library"):
        main(["--config", str(workspace / "configs" / "config.yaml"), "--device", "cpu",
              "train.host_topology=true"])
    with pytest.raises(RuntimeError):
        HT.topology_for_batch(_batch("loader"), FS, LEVELS)


def test_concurrent_first_builds(tmp_path):
    """Four processes build the library into one empty directory at once:
    each loads a whole library, one file is left and no temporary one."""
    code = (
        "import sys\n"
        "from mm2d3d_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "lib = native.lib()\n"
        "print(native.library_path())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert len({o.strip() for o, _ in outs}) == 1
    assert sorted(f.name for f in tmp_path.iterdir() if f.suffix != ".lock") == [
        outs[0][0].strip().rsplit("/", 1)[1]]
