"""Data parallelism (port of `mm2d3d_tpu/parallel/mesh.py`).

The JAX package runs one program over a mesh of devices: `shard_map` around
the train step, batches sharded on their leading dimension, the state
replicated, and the step `pmean`s gradients, running statistics and logs
before the optimizers update.  Here one process drives one device, as
`torchrun` (`python -m torch.distributed.run`) starts them.  Every rank runs
the whole task on its shard of each global batch (`data.loader.Loader
(num_shards, shard_id)`), builds its own topologies on its device, and
averages what JAX pmeans at the same point of the step
(`MM2D3DTask(group=...)` calls `all_mean`).  BatchNorm normalises with each
rank's own batch statistics, as flax's BatchNorm without an axis name does
under `shard_map`; only the running statistics are averaged.

The backend follows the layout: NCCL where each rank has a GPU of its own,
gloo where ranks share a GPU (NCCL refuses two ranks on one device) and on
the CPU.  A backend that cannot start raises; nothing falls back to another
backend, to the CPU or to one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List

import torch
import torch.distributed as dist

TIMEOUT_S = 300  # rendezvous and every collective
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True where a launcher (torchrun) set the ranks' environment."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK % visible devices), or the CPU
    when `device` names it."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"no {kind} device for this rank; pass --device cpu "
                           "to run the ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """NCCL where every rank of this host has a GPU of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_process_group(device="cuda", timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the launcher's process group (env://) -> this rank's device."""
    if not launched():
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        raise RuntimeError(
            f"data-parallel runs need the launcher's environment ({', '.join(missing)} "
            "unset): start every rank with torchrun, e.g. `torchrun "
            "--nproc_per_node=N -m mm2d3d_tpu_torch.run ...`")
    dev = rank_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def _by_dtype(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


@torch.no_grad()
def _collective(tensors, device, op) -> None:
    """`op` on one flat buffer per dtype (on `device`), then the result
    back into each tensor, whatever its layout or device."""
    for ts in _by_dtype(tensors):
        flat = torch.cat([t.reshape(-1).to(device) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def all_mean(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Average floating tensors across the ranks, in place: the sum over
    ranks divided by their number, as `lax.pmean` computes it (gloo has no
    AVG).  A world of one leaves every bit as it was."""
    tensors = list(tensors)
    if not tensors:
        return
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)

    _collective(tensors, tensors[0].device, mean)


def _optimizer_tensors(opt) -> List[torch.Tensor]:
    """The state tensors of a torch optimizer, or of `train.optim.MultiSteps`
    (its inner optimizer's and its gradient accumulators)."""
    inner = getattr(opt, "inner", opt)
    out = [v for state in inner.state.values() for v in state.values()
           if isinstance(v, torch.Tensor)]
    return out + list(getattr(opt, "acc", []))


def replicate(task, group=None, src: int = 0) -> None:
    """Rank `src`'s weights, buffers and optimizer state on every rank (a
    broadcast), as the JAX trainer replicates one state over the mesh."""
    tensors = [t for net in (task.model2d, task.model3d)
               for t in net.state_dict().values()]
    tensors += _optimizer_tensors(task.opt2d) + _optimizer_tensors(task.opt3d)
    _collective(tensors, task.device,
                lambda flat: dist.broadcast(flat, src=src, group=group))


def reduce_eval(before, after, logs: Dict[str, torch.Tensor], group=None):
    """One eval batch's reduction across the ranks, as
    `make_sharded_eval_step` computes it: the confusion matrices' deltas
    summed (int64, exact); with a `valid_weight` log w, each `loss*` log as
    Σ(v·w) / max(Σw, 1), so a rank that holds only tail filler (w = 0) does
    not pull the loss down, and `valid_weight` summed; every other log
    (the overflow monitors) averaged.  `before` is the metrics the batch
    started from, equal on every rank, `after` this rank's update of them.
    -> (metrics, logs), equal on every rank."""
    names = [f.name for f in dataclasses.fields(after)]
    olds = [getattr(before, k) for k in names]
    delta = torch.stack([(getattr(after, k) - o).long() for k, o in zip(names, olds)])
    dist.all_reduce(delta, group=group)
    metrics = dataclasses.replace(after, **{
        k: o + delta[i].to(o.dtype) for i, (k, o) in enumerate(zip(names, olds))})

    w = logs.get("valid_weight")
    keys = list(logs)

    def weighted(k):
        return w is not None and k.startswith("loss")

    vals = torch.stack([logs[k].float() * w.float() if weighted(k) else logs[k].float()
                        for k in keys])
    dist.all_reduce(vals, group=group)
    n = dist.get_world_size(group)
    out = {}
    for j, k in enumerate(keys):
        if weighted(k):
            out[k] = vals[j] / torch.clamp(vals[keys.index("valid_weight")], min=1.0)
        elif k == "valid_weight":
            out[k] = vals[j]
        else:
            out[k] = vals[j] / n
    return metrics, out
