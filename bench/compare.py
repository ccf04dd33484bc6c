"""The numbers that decide ``correct`` for a training cell.

Both sides give a *snapshot* of their first three steps from the same
start, on the same rows: ``loss`` (the three losses), ``grad`` (each leaf's
gradient at step 1 as the optimizer gets it) and ``delta`` (each leaf's
change after step 3). The numbers, each by the worst leaf:

* ``loss_gap.step<k>``: |L_prog - L_ref| / |L_ref|;
* ``grad_norm_gap`` / ``update_norm_gap``: the gap between the two norms
  of a leaf, over the reference's norm of that leaf or of the median
  counted leaf, whichever is larger;
* ``grad_diff`` / ``update_diff``: the norm of the leaf's difference, over
  the same denominator.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a gradient nought to rounding) count in none of them.

An evaluation is compared by its logits and its accuracy against the
reference's forward on the same parameters and test rows
(:func:`eval_numbers`); a training feed by the rows it owes
(:func:`feed_rows_missed`). Which of the numbers a cell compares, and their
limits, are in its workload file.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

COUNTED_SHARE = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def counted_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: _norm(v) for k, v in ref_grad.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= COUNTED_SHARE * median]


def _leaf_numbers(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  leaves: List[str]) -> Tuple[float, float]:
    """(worst gap of the norms, worst norm of the difference) over ``leaves``."""
    ref_norms = {k: _norm(ref[k]) for k in leaves}
    median = statistics.median(ref_norms.values())
    gap, diff = 0.0, 0.0
    for k in leaves:
        p, r = prog[k].to(torch.float64), ref[k].to(torch.float64)
        if p.shape != r.shape:
            return math.inf, math.inf
        den = max(ref_norms[k], median)
        g, d = abs(_norm(p) - ref_norms[k]) / den, _norm(p - r) / den
        if not (math.isfinite(g) and math.isfinite(d)):  # a NaN fails, never hides
            return math.inf, math.inf
        gap, diff = max(gap, g), max(diff, d)
    return gap, diff


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number of a snapshot pair (see the module's docstring)."""
    out: Dict[str, float] = {}
    for k, (lp, lr) in enumerate(zip(prog["loss"], ref["loss"]), start=1):
        out[f"loss_gap.step{k}"] = abs(lp - lr) / abs(lr) if math.isfinite(lp) else math.inf
    leaves = counted_leaves(ref["grad"])
    g_gap, g_diff = _leaf_numbers(prog["grad"], ref["grad"], leaves)
    u_gap, u_diff = _leaf_numbers(prog["delta"], ref["delta"], leaves)
    out.update(grad_norm_gap=g_gap, grad_diff=g_diff, update_norm_gap=u_gap,
               update_diff=u_diff)
    return out


def eval_numbers(logits: Optional[torch.Tensor], acc: float, ref_logits: torch.Tensor,
                 labels) -> Dict[str, float]:
    """``eval_logit_diff``: the norm of the logits' difference over the
    reference's norm (infinite where the rows differ in number or a logit
    is not finite); ``eval_acc_rows``: the test rows by which the reported
    accuracy departs from the reference logits' accuracy."""
    labels = torch.as_tensor(labels).long()
    ref_correct = int((ref_logits.argmax(-1) == labels).sum())
    n = int(labels.shape[0])
    rows = float(abs(round(acc * n) - ref_correct)) if math.isfinite(acc) else math.inf
    if logits is None or logits.shape != ref_logits.shape:
        return {"eval_logit_diff": math.inf, "eval_acc_rows": rows}
    diff = _norm(logits.double() - ref_logits.double()) / _norm(ref_logits)
    return {"eval_logit_diff": diff if math.isfinite(diff) else math.inf,
            "eval_acc_rows": rows}


def feed_rows_missed(perms, n_rows: int, per_epoch: int) -> int:
    """Over the epochs' feeds (each the row indices an epoch trains on, in
    order): the entries that repeat a row or lie outside ``[0, n_rows)``,
    and the gap between an epoch's entries and the ``per_epoch`` it owes.
    A feed of distinct rows of the training set, as many as owed, reads 0."""
    missed = 0
    for p in perms:
        p = np.asarray(p).reshape(-1)
        distinct = np.unique(p[(p >= 0) & (p < n_rows)]).size
        missed += (p.size - distinct) + abs(per_epoch - p.size)
    return int(missed)


def leaf_report(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Per leaf: the reference's gradient norm, and the gap and the
    difference of the gradient and of the change (for the look behind a
    reading)."""
    leaves = list(ref["grad"])
    g_norms = {k: _norm(ref["grad"][k]) for k in leaves}
    u_norms = {k: _norm(ref["delta"][k]) for k in leaves}
    g_med, u_med = statistics.median(g_norms.values()), statistics.median(u_norms.values())
    out = {}
    for k in leaves:
        gd, ud = max(g_norms[k], g_med), max(u_norms[k], u_med)
        out[k] = {"ref_grad_norm": g_norms[k],
                  "grad_gap": abs(_norm(prog["grad"][k]) - g_norms[k]) / gd,
                  "grad_diff": _norm(prog["grad"][k].double() - ref["grad"][k].double()) / gd,
                  "update_gap": abs(_norm(prog["delta"][k]) - u_norms[k]) / ud,
                  "update_diff": _norm(prog["delta"][k].double() - ref["delta"][k].double()) / ud}
    return out


def judged(values: Dict[str, float], limits: Dict[str, float]):
    """``[(name, value, limit)]`` of the numbers a cell compares."""
    return [(name, values[name], float(lim)) for name, lim in limits.items()]
