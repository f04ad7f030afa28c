"""Data parallelism of mm2d3d_tpu_torch vs the JAX package's, on the CPU.

- The sharded `Loader(num_shards=2, shard_id=s)`: every shard's batches
  equal the JAX loader's bit for bit (shuffled train with the global tail
  dropped, eval with the global tail padded, the cases of
  tests/test_data_pipeline.py).
- Two gloo ranks (`tools/ddp_check.py` under torchrun) against
  `make_sharded_train_step` on a 2-device JAX mesh of the virtual CPU
  devices: the sizes, weights and optimizer of tests/test_torch_train.py
  (fp32, SGD with momentum, dropout off on both sides, BN biases near 1;
  its docstring says why) at batch 2 per rank per domain, three steps.
  The shards are that file's four batches: at step s rank 0 trains on its
  pair s, rank 1 on the other.  Held as there: every log within 1e-4
  relative, the weights and running statistics after step 3 within
  1e-4 * max|leaf|, the seven BatchNorm-shadowed biases' step-1 gradients
  below 1e-6 of the branch's largest gradient (that file's level of
  rounding noise); and every rank's state bit-identical to rank 0's.  The
  other step-1 gradients are held within 1e-4 * max|leaf| plus that noise
  level: at this size a 2D leaf whose gradient is small against the
  branch's is ill-conditioned for many batches.  That file's
  single-process step on seeds 10 and 11 puts JAX and the port 2.1e-2 of
  such a leaf's own maximum apart (rgb_backbone layer3_2, a gradient
  2.5e-5 of the branch's largest), and here fuse3's averaged kernel
  gradient misses by 2.8e-4 of its own maximum (4e-7 of the branch's
  largest); no data parallelism is needed for the effect.
- The eval tail: 10 scans over 2 ranks at 4 per rank, so the last global
  batch holds 2 real scans and rank 1 only filler.  The reduced confusion
  matrices count every real point once and equal a single-process eval of
  the same scans in the same batches; the weighted losses equal its losses
  within 1e-5 relative.
- A gloo group of one: the data-parallel train step equals the plain step
  bit for bit.
"""

import dataclasses

import flax.linen
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_port import jax_batch, randomize_stats, to_numpy_tree
from test_torch_train import (
    BATCH, BN_SHADOWED, OPTIMIZER, PAIRS, REL, SMALL, _biases_near_one, _capture, _flat)

from mm2d3d_tpu.data.loader import Loader as LoaderJ
from mm2d3d_tpu.data.synthetic import make_batch as make_batch_jax
from mm2d3d_tpu.flagship import flagship_task as flagship_task_jax
from mm2d3d_tpu.parallel.mesh import make_mesh, make_sharded_train_step, replicate, shard_batch
from mm2d3d_tpu_torch.data.loader import Loader
from mm2d3d_tpu_torch.data.synthetic import make_batch
from mm2d3d_tpu_torch.flagship import flagship_task
from mm2d3d_tpu_torch.models.convert import from_flax, to_flax
from mm2d3d_tpu_torch.parallel import mesh
from mm2d3d_tpu_torch.tools import ddp_check
from mm2d3d_tpu_torch.tools.train_repro import differing, restore, snapshot
from mm2d3d_tpu_torch.train.batch import PointBatch
from mm2d3d_tpu_torch.train.trainer import evaluate

RANKS = 2
SEEDS = sorted({s for p in PAIRS for s in p})
EVAL_SCANS, EVAL_PER_RANK = 10, 4
TIMEOUT_S = 300
NOISE = 1e-6  # of the branch's largest gradient: test_torch_train's rounding noise


def shard_seed(s: int, rank: int) -> int:
    """Rank `rank`'s shard of global batch `s`: the batch of this seed."""
    return SEEDS[(SEEDS.index(s) + 2 * rank) % len(SEEDS)]


class Scans:
    """`n` synthetic scans at the sizes of `BATCH`, scan i from seed 1000 + i."""

    def __init__(self, n: int, points: int = 96):
        self.n = n
        self.points = points

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        r = np.random.RandomState(1000 + index)
        n, h, w = self.points, BATCH["height"], BATCH["width"]
        idx = np.stack([r.randint(0, h, n), r.randint(0, w, n)], 1)
        depth = np.zeros((h, w, 1), np.float32)
        depth[idx[:, 0], idx[:, 1], 0] = r.rand(n) * 50
        return {
            "img": r.rand(h, w, 3).astype(np.float32),
            "depth": depth,
            "img_indices": idx.astype(np.int64),
            "coords": r.randint(0, SMALL["full_scale"], (n, 3)).astype(np.int64),
            "feats": r.rand(n, 3).astype(np.float32),
            "seg_label": r.randint(0, 6, n).astype(np.int64),
        }


def _assert_batches_equal(ours, ref, what):
    assert len(ours) == len(ref), what
    for i, (a, b) in enumerate(zip(ours, ref)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f"{what} batch {i} {f.name}")
            else:
                assert x == y, (what, i, f.name)


@pytest.mark.parametrize("n,shuffle,drop_last,pad_last", [
    (37, True, False, False),  # eval pads the global tail, shard 1 partly
    (38, False, False, False),  # shard 1's tail slice is all filler
    (38, True, True, False),  # train drops the whole global tail
    (EVAL_SCANS, False, False, True),  # the eval tail below
])
def test_sharded_loader_matches_jax(n, shuffle, drop_last, pad_last):
    kw = dict(shuffle=shuffle, drop_last=drop_last, pad_last=pad_last, seed=7,
              num_shards=RANKS)
    g = 2 * RANKS
    shards = []
    for s in range(RANKS):
        ours, ref = Loader(Scans(n), 2, 128, shard_id=s, **kw), \
            LoaderJ(Scans(n), 2, 128, shard_id=s, **kw)
        assert len(ours) == len(ref) == (n // g if drop_last else -(-n // g))
        batches = list(ours)
        _assert_batches_equal(batches, list(ref), f"shard {s}")
        assert len(batches) == len(ours)
        shards.append(batches)
    # every real scan once over the shards: its points, and no more
    valid = sum(int(b.point_mask.sum()) for bs in shards for b in bs)
    kept = (n // g) * g if drop_last else n
    assert valid == kept * 96


def _global(shard_batches):
    """The global batch the shards came from (rows of shard 0, then 1)."""
    a = shard_batches[0]
    return dataclasses.replace(a, **{
        f.name: torch.cat([getattr(b, f.name) for b in shard_batches])
        for f in dataclasses.fields(a) if isinstance(getattr(a, f.name), torch.Tensor)})


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX sharded steps in this process; the port's steps and eval in
    two gloo ranks."""
    mesh_j = make_mesh(jax.devices()[:RANKS])
    task_j = flagship_task_jax(compute_dtype=jax.numpy.float32, optimizer_2d=OPTIMIZER,
                               optimizer_3d=OPTIMIZER, axis_name="data", **SMALL)
    task_j.tx2d, task_j.tx3d = _capture(task_j.tx2d), _capture(task_j.tx3d)
    first = make_batch_jax(np.random.RandomState(SEEDS[0]), **BATCH)
    state = task_j.init_state(jax.random.PRNGKey(0), jax_batch(first))
    params2d = _biases_near_one(state.params2d, 3)
    state = state.replace(params2d=params2d, opt2d=task_j.tx2d.init(params2d),
                          stats2d=randomize_stats(state.stats2d, 1),
                          stats3d=randomize_stats(state.stats3d, 2))
    init = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                            state.params3d, state.stats3d))
    batches_j = {s: jax.tree_util.tree_map(
        lambda *rows: np.concatenate(rows),
        *(make_batch_jax(np.random.RandomState(shard_seed(s, r)), **BATCH)
          for r in range(RANKS))) for s in SEEDS}
    state = replicate(state, mesh_j)
    logs_j, grads_j = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        step = make_sharded_train_step(task_j, mesh_j)
        for i, (s, t) in enumerate(PAIRS):
            state, logs = step(state, shard_batch(batches_j[s], mesh_j),
                               shard_batch(batches_j[t], mesh_j), jax.random.PRNGKey(7))
            logs_j.append({k: float(v) for k, v in logs.items()})
            if i == 0:
                grads_j = (to_numpy_tree(state.opt2d[0]), to_numpy_tree(state.opt3d[0]))
    final_j = tuple(to_numpy_tree(t) for t in (state.params2d, state.stats2d,
                                               state.params3d, state.stats3d))

    # the eval tail: each rank's loader shard, stacked into global batches
    shards = [list(Loader(Scans(EVAL_SCANS), EVAL_PER_RANK, 128, num_shards=RANKS,
                          shard_id=s)) for s in range(RANKS)]
    root = tmp_path_factory.mktemp("dp")
    sd2, sd3 = from_flax(*init)
    config = {"task": {**SMALL, "compute_dtype": "float32", "optimizer_2d": OPTIMIZER,
                       "optimizer_3d": OPTIMIZER},
              "pairs": [[SEEDS.index(s), SEEDS.index(t)] for s, t in PAIRS],
              "dropout": False, "seed": 0}
    ddp_check.write_inputs(
        str(root / "in.npz"), sd2, sd3,
        [_global([make_batch(np.random.RandomState(shard_seed(s, r)), **BATCH)
                  for r in range(RANKS)]) for s in SEEDS], config,
        eval_batches=[_global(bs) for bs in zip(*shards)])
    ddp_check.launch(["step", str(root / "in.npz"), str(root / "out"), "--device", "cpu"],
                     nproc=RANKS, timeout_s=TIMEOUT_S)
    ranks = ddp_check.read_ranks(str(root / "out" / "rank*.npz"))
    assert len(ranks) == RANKS
    return dict(ranks=ranks, logs_j=logs_j, grads_j=grads_j, final_j=final_j,
                shards=shards)


def _tree(rank, prefix):
    """(flax trees of model2d, of model3d) from a rank's `prefix/model*/` keys."""
    sds = [{k[len(f"{prefix}/{m}/"):]: torch.from_numpy(v) for k, v in rank.items()
            if k.startswith(f"{prefix}/{m}/")} for m in ("model2d", "model3d")]
    return to_flax(*sds)


def test_dp_logs_match_jax(dp_run):
    r0 = dp_run["ranks"][0]
    for step, lj in enumerate(dp_run["logs_j"]):
        lt = {k.split("/", 1)[1]: float(v) for k, v in r0.items()
              if k.startswith(f"log{step}/")}
        assert set(lt) == set(lj), step
        assert lt["train/nbr_slot_overflow"] == lj["train/nbr_slot_overflow"] == 0
        assert lt["train/voxel_overflow_levels"] == lj["train/voxel_overflow_levels"] == 0
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=REL, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")


@pytest.mark.parametrize("branch", ["2d", "3d"])
def test_dp_step1_gradients_match_jax(dp_run, branch):
    g2t, _, g3t, _ = _tree(dp_run["ranks"][0], "grad")
    g2j, g3j = dp_run["grads_j"]
    ours, ref = (_flat(g2t), _flat(g2j)) if branch == "2d" else (_flat(g3t), _flat(g3j))
    assert set(ours) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    worst = []
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        if k in BN_SHADOWED:
            assert np.abs(ours[k]).max() <= NOISE * scale, k
            assert np.abs(ref[k]).max() <= NOISE * scale, k
            continue
        tol = REL * float(np.abs(ref[k]).max()) + NOISE * scale
        worst.append((float(np.abs(ours[k] - ref[k]).max()) / tol, k))
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=tol, err_msg=k)
    print(branch, sorted(worst)[-4:])


@pytest.mark.parametrize("part", ["params2d", "stats2d", "params3d", "stats3d"])
def test_dp_weights_and_stats_after_three_steps_match_jax(dp_run, part):
    i = ("params2d", "stats2d", "params3d", "stats3d").index(part)
    ours = _flat(_tree(dp_run["ranks"][0], "state")[i])
    ref = _flat(dp_run["final_j"][i])
    assert set(ours) == set(ref) and ref
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                   atol=REL * float(np.abs(ref[k]).max()), err_msg=k)


def test_dp_ranks_hold_identical_state(dp_run):
    r0, *others = dp_run["ranks"]
    for r in others:
        assert set(r) == set(r0)
        differ = [k for k in r0 if not np.array_equal(r[k], r0[k])]
        assert differ == []
    # weights, running statistics, momenta, the dropout generator
    assert sum(k.startswith("state/opt2d/") for k in r0) > 0


def test_dp_eval_tail_exact(dp_run):
    """Rank 1's share of the last global batch is all filler: the reduced
    matrices still count every real point once, and its zero losses (weight
    0) do not pull the reported loss down."""
    r0 = dp_run["ranks"][0]
    sd2, sd3 = ({k[len(f"state/{m}/"):]: torch.from_numpy(v) for k, v in r0.items()
                 if k.startswith(f"state/{m}/")} for m in ("model2d", "model3d"))
    task = flagship_task(compute_dtype=torch.float32, device="cpu", **SMALL)
    task.load_state_dicts(sd2, sd3)
    shards = dp_run["shards"]
    tail = shards[1][-1]
    assert not tail.point_mask.any() and (tail.seg_label == -100).all()
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the ranks
    try:
        # the same scans in the same batches, one process
        ref, ref_logs, _ = evaluate(task, [b for bs in zip(*shards) for b in bs])
    finally:
        torch.set_num_threads(n)
    for name in ("cm_2d", "cm_3d", "cm_avg"):
        cm = r0[f"eval/{name}"]
        np.testing.assert_array_equal(cm, getattr(ref, name).numpy(), err_msg=name)
        assert cm.sum() == EVAL_SCANS * 96  # every real point once
    n_batches = len(shards[0])
    logs = [{k.split("/", 1)[1]: float(v) for k, v in r0.items()
             if k.startswith(f"eval{i}/")} for i in range(n_batches)]
    assert [lg["valid_weight"] for lg in logs] == [
        float(ref_logs[2 * i]["valid_weight"] + ref_logs[2 * i + 1]["valid_weight"])
        for i in range(n_batches)]

    def weighted(lgs, key):
        return (sum(float(lg[key]) * float(lg["valid_weight"]) for lg in lgs)
                / sum(float(lg["valid_weight"]) for lg in lgs))

    for key in ("loss_segmentation", "loss_segmentation_3d"):
        np.testing.assert_allclose(weighted(logs, key), weighted(ref_logs, key),
                                   rtol=1e-5, err_msg=key)


def test_world_of_one_is_bit_identical(monkeypatch):
    """The data-parallel step in a gloo group of one, against the plain
    step from the same state: every weight, statistic, momentum, generator
    and log bit for bit."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(ddp_check.free_port())}.items():
        monkeypatch.setenv(k, v)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's threaded gather backward is not bit-stable
    try:
        task = flagship_task(compute_dtype=torch.float32, optimizer_2d=OPTIMIZER,
                             optimizer_3d=OPTIMIZER, device="cpu", **SMALL)
        task.init_params(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(5)
        src, trg = (make_batch(np.random.RandomState(s), **BATCH) for s in (0, 1))
        task.train_step(src, trg, gen)  # momenta in the state
        start = snapshot(task, gen)
        plain = task.train_step(src, trg, gen)
        want = snapshot(task, gen)

        restore(task, gen, start)
        assert mesh.init_process_group("cpu") == torch.device("cpu")
        try:
            assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
            task.group = dist.group.WORLD
            got = task.train_step(src, trg, gen)
        finally:
            mesh.destroy_process_group()
    finally:
        torch.set_num_threads(n)
    assert not dist.is_initialized()
    assert differing(want, snapshot(task, gen)) == []
    assert set(got) == set(plain)
    for k in plain:
        assert torch.equal(got[k], plain[k]), k


def test_point_batch_fields_survive_the_inputs_file(tmp_path):
    """`write_inputs` and a rank's read of its rows: every field, flags too."""
    b = _global([make_batch(np.random.RandomState(4 + r), **BATCH) for r in range(RANKS)])
    arrays = ddp_check.batch_arrays(b, "batch0")
    for rank in range(RANKS):
        got = ddp_check.rank_batch(arrays, "batch0", rank, RANKS)
        assert isinstance(got, PointBatch)
        for f in dataclasses.fields(b):
            x, y = getattr(b, f.name), getattr(got, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x[2 * rank:2 * rank + 2], y), f.name
            else:
                assert x == y, f.name

