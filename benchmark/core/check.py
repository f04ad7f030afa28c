"""The numbers that decide `correct`, and their limits.

Train cells (the program's first three steps, which the window's own call
drives on pool pairs 0-2, against the reference's three steps from the same
weights, batches and dropout stream):
  loss_gap    max over the steps of |loss - ref| / |ref| (the total loss);
  grad_gap    the median over the leaves of |‖g‖ - ‖g_ref‖| of the first
              gradient (the program's from its optimizer's state after step
              1), over max(‖g_ref‖ of the leaf, the median leaf's): the worst
              leaf's gap is the 4-parameter RGB gate's or a 3D BatchNorm's on
              most seeds and swings 0.06-0.72 from seed to seed, wider than
              the control moves it;
  change_gap  the same for each leaf's change over the three steps, over the
              leaves whose reference gradient is at least a thousandth of
              the median leaf's (a bias ahead of a BatchNorm has none but
              round-off, which Adam would scale up to a full step);
  overflow    voxels and rulebook hits dropped in any step (exact: 0).
Eval cells (every call of the window; the reference once per pool batch):
  logit_gap_2d, logit_gap_3d   ‖L - L_ref‖ / ‖L_ref‖ over the valid points
              of one call per pool batch, drawn from the seed; the worst;
  cm_gap      the worst of the three accumulated confusion matrices' share
              of points counted in another cell than the reference's:
              sum |cm - cm_ref| / (2 sum cm_ref);
  loss_gap    the worst call's relative gap of either segmentation loss;
  overflow    as above.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

EXACT = ("overflow",)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    keys = sorted(ref) if keep is None else keep
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def train_numbers(prog: Dict, ref: Dict) -> Dict:
    """`prog`, `ref`: {"losses", "grad_norms", "change_norms"} (and the
    program's "overflow")."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    med_g = statistics.median(ref["grad_norms"].values())
    keep = sorted(k for k, v in ref["grad_norms"].items() if v >= 1e-3 * med_g)
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    return {
        "loss_gap": max(_rel(a, b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": statistics.median(grad.values()),
        "change_gap": change[worst_change],
        "overflow": prog.get("overflow", 0.0),
        "_worst": {"grad": [worst_grad, grad[worst_grad]],
                   "change": [worst_change, change[worst_change]],
                   "median_change": statistics.median(change.values()),
                   "excluded": len(ref["grad_norms"]) - len(keep)},
    }


def _frob_gap(p: torch.Tensor, r: torch.Tensor, valid: torch.Tensor) -> float:
    if p.shape != r.shape:  # an answer of the wrong size is wrong
        return float("inf")
    p, r = p[valid].double(), r[valid].double()
    return float((p - r).norm() / r.norm().clamp(min=1e-30))


def eval_numbers(prog: Dict, ref: List[Dict]) -> Dict:
    """`prog`: {"calls": [(pool index, loss_2d, loss_3d)], "cm": {name: (nc,
    nc)}, "logits": {pool index: (logit_2d, logit_3d)}, "overflow"}; `ref`:
    `Reference.eval_batch` of each pool batch."""
    counts = [0] * len(ref)
    loss_gap = 0.0
    for j, l2, l3 in prog["calls"]:
        counts[j] += 1
        loss_gap = max(loss_gap, _rel(l2, ref[j]["loss_segmentation"]),
                       _rel(l3, ref[j]["loss_segmentation_3d"]))
    cm_gap = 0.0
    for name in ("cm_2d", "cm_3d", "cm_avg"):
        want = sum(c * r[name].cpu().long() for c, r in zip(counts, ref))
        got = prog["cm"][name].cpu().long()
        cm_gap = max(cm_gap, float((got - want).abs().sum()) / (2 * float(want.sum())))
    g2 = g3 = 0.0
    for j, (l2, l3) in prog["logits"].items():
        valid = ref[j]["valid"]
        g2 = max(g2, _frob_gap(l2, ref[j]["logit_2d"], valid))
        g3 = max(g3, _frob_gap(l3, ref[j]["logit_3d"], valid))
    return {"logit_gap_2d": g2, "logit_gap_3d": g3, "cm_gap": cm_gap,
            "loss_gap": loss_gap, "overflow": prog.get("overflow", 0.0)}


def judge(numbers: Dict, limits: Optional[Dict], not_compared=()):
    """-> (correct, {name: {"value", "limit"}}) over the numbers compared;
    without limits nothing is correct."""
    shown = {}
    ok = limits is not None
    for name, value in numbers.items():
        if name.startswith("_") or name in not_compared:
            continue
        limit = 0.0 if name in EXACT else (limits or {}).get(name)
        shown[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, shown
