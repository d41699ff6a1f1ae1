"""The comparison that decides ``correct``: the numbers compared, each
against its limit in ``portbench/limits/<cell>.json``.

Training (three steps from the same weights on the same batches):
- ``loss_gap``: the largest gap between the program's and the reference's
  loss over the steps, as a share of the reference's loss;
- ``grad_gap``: by the worst leaf, the gap between the norms of the
  program's and the reference's first gradient, as a share of the larger
  of the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for each leaf's change after the steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (the others move by round-off alone under Adam);
- ``grad_diff``: by the worst leaf, the norm of the difference between the
  program's and the reference's first gradient, as a share of the larger
  of the reference's norm of that leaf and of the median leaf. The three
  above are gaps between norms, and a rounding error that is as likely to
  raise a norm as to lower it mostly cancels there, for bf16 and for fp8
  alike (PERF.md §2): this number is the one the fp8 control fails.
A reading that is missing or not finite counts as infinitely far.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

ADAM_ROUNDOFF = 1e-3  # a leaf whose reference gradient is below this share of the median's


def sync(device) -> None:
    if getattr(device, "type", str(device)) == "cuda":
        import torch

        torch.cuda.synchronize(device)


def norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.detach(), dtype=torch.float64))


def _finite(x) -> float:
    return x if isinstance(x, (int, float)) and math.isfinite(x) else math.inf


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    base = statistics.median(ref[k] for k in leaves)
    worst = 0.0
    for k in leaves:
        denom = max(ref[k], base)
        if denom <= 0:
            continue
        worst = max(worst, abs(_finite(prog.get(k, math.nan)) - ref[k]) / denom)
    return worst


def train_numbers(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    losses = prog.get("losses", [])
    if len(losses) != len(ref["losses"]):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(_finite(p) - r) / abs(r) for p, r in zip(losses, ref["losses"]))
    grads = ref["grad_norms"]
    leaves = sorted(grads)
    base = statistics.median(grads.values())
    moved = [k for k in leaves if grads[k] >= ADAM_ROUNDOFF * base]
    out = {
        "loss_gap": loss_gap,
        "grad_gap": leaf_gap(prog.get("grad_norms", {}), grads, leaves),
        "change_gap": leaf_gap(prog.get("change_norms", {}), ref["change_norms"], moved),
    }
    if "first_grads" in ref:
        out["grad_diff"] = grad_diff(prog.get("first_grads", {}), ref["first_grads"], grads)
    return out


def grad_diff(prog, ref, ref_norms: Dict[str, float]) -> float:
    """The worst leaf's norm of (program's - reference's) first gradient over
    the larger of the reference leaf's norm and the median leaf's."""
    base = statistics.median(ref_norms.values())
    worst = 0.0
    for k, r in ref.items():
        denom = max(ref_norms[k], base)
        p = prog.get(k)
        if p is None or tuple(p.shape) != tuple(r.shape):
            return math.inf
        worst = max(worst, _finite(norm(p.to(r.device, r.dtype) - r)) / denom)
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Whether every number is within its limit, and each beside it."""
    out = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    ok = all(name in numbers and numbers[name] <= limits[name] for name in limits)
    return ok, out
