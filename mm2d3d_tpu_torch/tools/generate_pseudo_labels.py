"""Generate self-training pseudo-labels for the target-train split (port of
`mm2d3d_tpu/tools/generate_pseudo_labels.py`).

Runs a trained checkpoint (`train.trainer.CheckpointIO`: ``best_2d``,
``best_3d`` or ``last`` under ``<train.out_dir>/ckpts``) over the
target-train scans in eval mode (no augmentation), one scan per forward,
and writes the schema the datasets read through ``pselab_paths``: one
record per scan, ``{probs_2d, pseudo_label_2d, probs_3d, pseudo_label_3d,
probs_ensemble, pseudo_label_ensemble}`` over the scan's FULL point set
(points the dataset drops get prob 0 and label 0, which the refinement
discards), in scan order.  The datasets refine them with the BDL median
filter (`data.pseudo_labels.refine_pseudo_labels`) at load time.

Each scan is padded to the next power of two of its kept points (at least
256), as in JAX, so the level capacities are the JAX generator's.  The
topology is the task's own (`train.slot_profile`).  Conv hits dropped by
the slot tables are warned per scan, or refused with ``--strict``.

Usage:
    python -m mm2d3d_tpu_torch.tools.generate_pseudo_labels \
        --config configs/config.yaml --ckpt best_2d \
        --out runs/default/pselab/target_train.npy [--device cpu] [overrides...]
"""

from __future__ import annotations

import argparse
import copy
import os
import os.path as osp
from typing import Dict, List

import numpy as np
import torch

KEYS = ("2d", "3d", "ensemble")


def _next_pow2(n: int) -> int:
    return 1 << max(8, (n - 1).bit_length())


def scan_batch(dataset, i: int, task):
    """Scan `i` of `dataset` as the generator feeds it -> (a batch of one on
    the task's device, the scan's kept-point mask)."""
    from ..data.base import collate

    sample = dataset[i]
    idxs = np.asarray(sample["orig_points_idx"])  # (full,) bool
    batch = collate([sample], _next_pow2(int(idxs.sum())),
                    full_scale=task.full_scale).to(task.device)
    return batch, idxs


def to_scan_order(x: torch.Tensor, batch, idxs: np.ndarray, fill) -> np.ndarray:
    """A (1, N) per-point tensor of `batch` over the scan's full point set, in
    scan order; `fill` at the points the dataset dropped.  collate
    Morton-sorts the points: the recorded permutation restores their order
    before the kept rows are taken."""
    perm = batch.point_perm[0].cpu().numpy()
    sorted_ = x[0].cpu().numpy()
    orig = np.empty_like(sorted_)
    orig[perm] = sorted_
    out = np.full(len(idxs), fill, sorted_.dtype)
    out[idxs] = orig[:int(idxs.sum())]
    return out


def margins(task, dataset, i: int) -> Dict[str, np.ndarray]:
    """The top-two gap of each of the three softmaxes at scan `i`'s points,
    in scan order (inf at dropped points): where two runs' labels may
    differ by summation order alone."""
    batch, idxs = scan_batch(dataset, i, task)
    f = task.forward(batch)
    n = batch.n_points
    out = {}
    for key, probs in (("2d", torch.softmax(f["seg_logit_2d"].reshape(n, -1), -1)),
                       ("3d", torch.softmax(f["seg_logit_3d"], -1)),
                       ("ensemble", f["ensemble"])):
        top2 = probs.topk(2, -1).values.double()
        out[key] = to_scan_order((top2[:, 0] - top2[:, 1])[None], batch, idxs, np.inf)
    return out


def target_train_dataset(cfg: Dict):
    """(the eval-mode dataset of the registry's val path — no augmentation,
    output_orig — pointed at the target TRAIN split, the datamodule)."""
    from ..run import build_datamodule

    cfg = copy.deepcopy(cfg)
    target = cfg["dataset"]["target"]
    target["VAL"] = target["TRAIN"]
    target.pop("pselab_paths", None)
    dm = build_datamodule(cfg)
    return dm.target_val.dataset, dm


def restore_task(cfg: Dict, dm, ckpt_name: str, device="cuda"):
    """`cfg`'s task on `device` with checkpoint `ckpt_name` of
    ``<train.out_dir>/ckpts`` restored into it, as the trainer resumes."""
    from ..run import build_task, resolve_auto_params
    from ..train.trainer import CheckpointIO

    resolve_auto_params(cfg, dm)  # `weight: compute` (configs/a2d2.yaml)
    task = build_task(cfg, dm.num_classes, device=device)
    ckpt_dir = osp.join(cfg["train"].get("out_dir", "runs/default"), "ckpts")
    mgr = CheckpointIO(ckpt_dir)
    if not mgr.exists(ckpt_name):
        raise FileNotFoundError(f"checkpoint {ckpt_name!r} not in {ckpt_dir}")
    # the weights' home is the task's device: place them there first
    task.init_params(torch.Generator().manual_seed(0))
    meta = mgr.restore(ckpt_name, task, None)  # no dropout at inference
    print(f"restored {ckpt_name} from {ckpt_dir} (meta: {meta})")
    return task


def generate(cfg: Dict, ckpt_name: str, out_path: str, strict: bool = False,
             device="cuda") -> List[Dict]:
    """Write the pseudo-label records of `cfg`'s target-train split from
    checkpoint `ckpt_name` to `out_path` -> the records."""
    cfg = copy.deepcopy(cfg)
    dataset, dm = target_train_dataset(cfg)
    task = restore_task(cfg, dm, ckpt_name, device)

    records: List[Dict] = []
    for i in range(len(dataset)):
        batch, idxs = scan_batch(dataset, i, task)
        raw = task.point_predictions(batch)
        overflow = int(raw.pop("slot_overflow"))
        if overflow:
            msg = (
                f"scan {i}: {overflow} conv hits dropped by the "
                "slot-table cap — pseudo labels are approximate; raise "
                "default_slot_caps (train.slot_profile: dense)"
            )
            if strict:
                # approximate pseudo labels poison the whole self-training
                # run: strict mode refuses to write them
                raise RuntimeError(msg)
            print(f"WARNING: {msg}")
        # dropped points: prob 0 and label 0, which the refinement discards
        rec = {}
        for key in KEYS:
            rec[f"probs_{key}"] = to_scan_order(raw[f"probs_{key}"], batch, idxs, 0)
            rec[f"pseudo_label_{key}"] = to_scan_order(
                raw[f"pseudo_label_{key}"], batch, idxs, 0)
        records.append(rec)
        if (i + 1) % 200 == 0 or i + 1 == len(dataset):
            print(f"  {i + 1}/{len(dataset)} scans")

    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    np.save(out_path, np.asarray(records, dtype=object), allow_pickle=True)
    print(f"wrote {len(records)} pseudo-label records to {out_path}")
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--ckpt", default="best_2d",
                        help="checkpoint name: best_2d | best_3d | last")
    parser.add_argument("--out", required=True, help="output .npy path")
    parser.add_argument("--strict", action="store_true",
                        help="error (instead of warn) on slot overflow — "
                        "refuse to write approximate pseudo labels")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    from ..run import parse_config

    cfg = parse_config(args.config, args.overrides)
    return generate(cfg, args.ckpt, args.out, strict=args.strict, device=args.device)


if __name__ == "__main__":
    main()
