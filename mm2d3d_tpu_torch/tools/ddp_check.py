"""Data-parallel train steps, evaluation and CLI runs, one process per rank
under torchrun, each rank's outcome written to a file.

    python -m torch.distributed.run --nproc_per_node=N \\
        -m mm2d3d_tpu_torch.tools.ddp_check step INPUTS.npz OUT_DIR [--device cpu]
    python -m torch.distributed.run --nproc_per_node=N \\
        -m mm2d3d_tpu_torch.tools.ddp_check cli PREFIX -- [mm2d3d_tpu_torch.run arguments]

`step`: every rank loads one set of weights and the global batches from
INPUTS (`write_inputs`), takes its shard of each (rows rank*b to
(rank+1)*b, b = B / N), runs the configured data-parallel train steps over
the configured (source, target) pairs and, when INPUTS holds eval batches,
the data-parallel evaluation of them (`train.trainer.evaluate`), and writes
OUT_DIR/rank<r>.npz: every step's logs (`log<s>/<key>`), the averaged
gradients of step 1 (`grad/model2d/<name>`, ...), the final state
(`state/<path>`: `train_repro.snapshot`'s tensors), the confusion matrices
(`eval/cm_2d`, ...) and each eval batch's reduced logs (`eval<i>/<key>`).

`cli`: every rank runs `mm2d3d_tpu_torch.run.main` with the given arguments
and writes PREFIX.rank<r>.pt: the kernels' launches, what the hierarchies
of the topologies the task built predict for them, both overflow monitors
of each topology, the end of each train step (synchronised), the rank's
peak device memory, the confusion matrices of each eval loop, a digest of the
final state (weights, buffers, optimizers, schedules, dropout generator)
and the results.

The ranks run with TF32 off, as `chip_smoke.py` does.  `launch` starts the
ranks with a wall limit (and kills them all at it) and `read_ranks` reads
their files; `chip_smoke.py` phase 13 and tests/test_torch_parallel*.py
drive both.  No JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- the caller's side ----------------------------------------------------

def batch_arrays(batch, prefix: str) -> dict:
    """A PointBatch as numpy arrays under `prefix/<field>` (None left out)."""
    out = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if v is not None:
            out[f"{prefix}/{f.name}"] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                         else np.asarray(v))
    return out


def write_inputs(path: str, state2d, state3d, batches, config: dict,
                 eval_batches=()) -> None:
    """The inputs of `step`: the two networks' state dicts, the global train
    batches and eval batches (PointBatches), and `config`: {"task": keyword
    arguments of `flagship_task` (with "compute_dtype" a DTYPES name),
    "pairs": [[source batch, target batch], ...] one per step,
    "dropout": bool, "seed": the dropout generator's seed}."""
    arrays = {"config": np.asarray(json.dumps(config))}
    for name, sd in (("model2d", state2d), ("model3d", state3d)):
        arrays.update({f"{name}/{k}": v.detach().cpu().numpy() for k, v in sd.items()})
    for i, b in enumerate(batches):
        arrays.update(batch_arrays(b, f"batch{i}"))
    for i, b in enumerate(eval_batches):
        arrays.update(batch_arrays(b, f"eval{i}"))
    np.savez(path, **arrays)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, nproc: int = 2, timeout_s: float = 600, env=None) -> str:
    """`python -m torch.distributed.run` with `nproc` ranks of this module
    and `args`, from the repository's root -> their output.  Raises if a
    rank fails; at `timeout_s` every process of the launch is killed and
    TimeoutError raised."""
    cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={nproc}",
           "--nnodes=1", "--master_addr=localhost", f"--master_port={free_port()}",
           "-m", "mm2d3d_tpu_torch.tools.ddp_check", *args]
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "MM2D3D_DISTRIBUTED"):
        env.pop(k, None)  # the launcher sets the ranks' own
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise TimeoutError(f"ranks still running after {timeout_s} s:\n{out[-4000:]}")
    finally:
        # interrupted, or done: leave no rank (nor a loader's server) behind
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    if proc.returncode:
        raise RuntimeError(f"ranks failed (exit {proc.returncode}):\n{out[-6000:]}")
    return out


def read_ranks(pattern: str) -> list:
    """The files the ranks wrote (`OUT_DIR/rank*.npz` or `PREFIX.rank*.pt`),
    in rank order: dicts of numpy arrays, or the saved dicts."""
    paths = sorted(glob.glob(pattern),
                   key=lambda p: int(p.rsplit("rank", 1)[1].split(".")[0]))
    out = []
    for p in paths:
        if p.endswith(".npz"):
            with np.load(p) as z:
                out.append({k: z[k] for k in z.files})
        else:
            out.append(torch.load(p, weights_only=False))
    return out


def reference_eval(argv, batch_size: int, limit: int, device="cuda") -> dict:
    """One process's eval of the ``last`` checkpoint of the run that `argv`
    (`mm2d3d_tpu_torch.run` arguments) describes, over its val split in
    batches of `batch_size`, at most `limit` of them: a data-parallel run's
    scans in the batches its ranks evaluated them (batch k is rank k % N's
    share of global batch k // N) -> the confusion matrices, on the CPU."""
    import os.path as osp

    from .. import run as cli
    from ..train.trainer import CheckpointIO, evaluate

    _, cfg = cli.parse(list(argv))
    cfg["run"]["test_batch_size"] = batch_size
    dm = cli.build_datamodule(cfg)
    try:
        cli.resolve_auto_params(cfg, dm)
        task = cli.build_task(cfg, dm.num_classes, device=device)
        task.init_params(torch.Generator())  # onto the device; then the weights
        gen = torch.Generator(device=task.device)
        CheckpointIO(osp.join(cfg["train"]["out_dir"], "ckpts")).restore("last", task, gen)
        metrics, _, _ = evaluate(task, (b.to(task.device) for b in dm.target_val), limit)
    finally:
        for lo in (dm.source_train, dm.target_train, dm.target_val, dm.target_test):
            lo.close()
    return {k: v.cpu() for k, v in dataclasses.asdict(metrics).items()}


def digest(tree) -> dict:
    """path -> sha1 of dtype, shape and bytes for every tensor of a nested
    dict/list (`train_repro.snapshot`, a checkpoint); the other leaves
    (schedule counters, the step) as JSON under `scalars`."""
    from .train_repro import tensor_leaves

    out = {}
    for path, t in tensor_leaves(tree):
        t = t.detach().cpu().contiguous()
        h = hashlib.sha1(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        out[path] = h.hexdigest()
    out["scalars"] = json.dumps({k: tree[k] for k in ("step", "sched2d", "sched3d")
                                 if k in tree}, default=str, sort_keys=True)
    return out


# -- the ranks' side ------------------------------------------------------

def rank_batch(data: dict, prefix: str, rank: int, world: int):
    """The PointBatch under `prefix`, this rank's rows of it."""
    from ..train.batch import PointBatch

    kw = {}
    for f in dataclasses.fields(PointBatch):
        a = data.get(f"{prefix}/{f.name}")
        if a is None:
            kw[f.name] = None
        elif a.ndim == 0:
            kw[f.name] = bool(a)
        else:
            b = a.shape[0] // world
            kw[f.name] = torch.from_numpy(np.ascontiguousarray(a[rank * b:(rank + 1) * b]))
    return PointBatch(**kw)


def run_steps(inputs: str, out_dir: str, device: str) -> None:
    import torch.distributed as dist

    from ..flagship import flagship_task
    from ..parallel import mesh
    from ..train.trainer import evaluate
    from .train_repro import snapshot, tensor_leaves

    dev = mesh.init_process_group(device)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        with np.load(inputs) as z:
            data = {k: z[k] for k in z.files}
        cfg = json.loads(str(data["config"]))
        kw = dict(cfg["task"])
        kw["compute_dtype"] = DTYPES[kw.get("compute_dtype", "bfloat16")]
        task = flagship_task(device=dev, group=dist.group.WORLD, **kw)
        task.load_state_dicts(
            *({k.split("/", 1)[1]: torch.from_numpy(v) for k, v in data.items()
               if k.startswith(name + "/")} for name in ("model2d", "model3d")))
        mesh.replicate(task, task.group)
        if not cfg.get("dropout", True):
            for enc in (task.model2d.rgb_backbone, task.model2d.depth_backbone):
                enc.dropout_rate = 0.0
        gen = torch.Generator(device=dev).manual_seed(cfg.get("seed", 0))
        out = {}
        for s, (i, j) in enumerate(cfg["pairs"]):
            logs = task.train_step(rank_batch(data, f"batch{i}", rank, world).to(dev),
                                   rank_batch(data, f"batch{j}", rank, world).to(dev), gen)
            out.update({f"log{s}/{k}": v.float().cpu().numpy() for k, v in logs.items()})
            if s == 0:
                for name in ("model2d", "model3d"):
                    out.update({f"grad/{name}/{k}": p.grad.cpu().numpy()
                                for k, p in getattr(task, name).named_parameters()
                                if p.grad is not None})
        evals = sorted({k.split("/")[0] for k in data if k.startswith("eval")},
                       key=lambda k: int(k[4:]))
        if evals:
            metrics, logs, _ = evaluate(task, [rank_batch(data, e, rank, world).to(dev)
                                               for e in evals])
            for k, cm in dataclasses.asdict(metrics).items():
                out[f"eval/{k}"] = cm.cpu().numpy()
            for i, lg in enumerate(logs):
                out.update({f"eval{i}/{k}": v.float().cpu().numpy() for k, v in lg.items()})
        for path, t in tensor_leaves(snapshot(task, gen)):
            out["state" + path] = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        mesh.destroy_process_group()


def run_cli(prefix: str, argv) -> None:
    """`run.main(argv)` in this rank, with every topology the task builds
    kept (kind "train", "eval", or "viz" for a figure's forward, which rank
    0 alone runs) and every eval loop's matrices."""
    from .. import run as cli
    from ..data.loader import stop_worker_server
    from ..ops import kernels
    from ..train import trainer as trainer_mod
    from ..train.step import MM2D3DTask, slot_overflow
    from .kernel_cases import expected_launches, expected_train_launches
    from .train_repro import snapshot

    topologies, ends, evals, in_viz = [], [], [], []
    build, step, evaluate, viz = (MM2D3DTask.build_topology, MM2D3DTask.train_step,
                                  trainer_mod.evaluate, MM2D3DTask.viz_forward)

    def kept_build(self, batch):
        topo = build(self, batch)
        hier = topo[1]
        kind = ("viz" if in_viz else
                "eval" if torch.is_inference_mode_enabled() else "train")
        topologies.append({
            "kind": kind,
            "expected": (expected_train_launches([hier]) if kind == "train"
                         else expected_launches(hier)),
            "levels_at_capacity": sum(int(lvl.num_voxels) >= lvl.capacity
                                      for lvl in hier.levels),
            "slot_overflow": int(slot_overflow(hier) + 0)})
        return topo

    def timed_step(self, *a, **kw):
        logs = step(self, *a, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ends.append(time.perf_counter())
        return logs

    def kept_viz(self, *a, **kw):
        in_viz.append(True)
        try:
            return viz(self, *a, **kw)
        finally:
            in_viz.pop()

    def kept_evaluate(task, batches, limit=None):
        metrics, logs, dropped = evaluate(task, batches, limit)
        evals.append({k: v.cpu() for k, v in dataclasses.asdict(metrics).items()})
        return metrics, logs, dropped

    MM2D3DTask.build_topology, MM2D3DTask.train_step = kept_build, timed_step
    MM2D3DTask.viz_forward = kept_viz
    trainer_mod.evaluate = kept_evaluate
    kernels.reset_counts()
    try:
        trainer, results = cli.main(list(argv))
    finally:
        MM2D3DTask.build_topology, MM2D3DTask.train_step = build, step
        MM2D3DTask.viz_forward = viz
        trainer_mod.evaluate = evaluate
    dev = trainer.task.device
    rank = int(os.environ["RANK"])
    torch.save({
        "rank": rank, "device": str(dev), "ends": ends,
        "launches": kernels.counts(), "topologies": topologies, "evals": evals,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30  # this process's
                     if dev.type == "cuda" else None),
        "global_step": trainer.global_step, "start_epoch": trainer.start_epoch,
        "state": digest(snapshot(trainer.task, trainer.generator)),
        "results": results,
    }, f"{prefix}.rank{rank}.pt")
    stop_worker_server()  # main closed the loaders


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("step")
    p.add_argument("inputs")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("cli")
    p.add_argument("prefix")
    p.add_argument("argv", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    # fp32 is fp32, as in chip_smoke.py's own process (cuDNN would take
    # TF32 for fp32 convolutions by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mode == "step":
        run_steps(args.inputs, args.out_dir, args.device)
    else:
        run_cli(args.prefix, args.argv[1:] if args.argv[:1] == ["--"] else args.argv)


if __name__ == "__main__":
    main()
