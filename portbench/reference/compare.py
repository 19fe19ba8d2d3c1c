"""The comparison that decides ``correct``: the program's readings from
its first training steps against the plain reference's.

A reading holds each leaf's tensor (``reference/train.py``). Each leaf's
number is taken over the reference's norm of that leaf or of the median
leaf, whichever is larger, and a cell's number is its worst leaf's:

- ``loss_gap``: the largest absolute gap between the two sides' losses of
  the same step; ``first_loss_gap`` the first step's (before any update).
- ``sum_gap``: the gap between the two sides' norms of a leaf of the first
  step's accumulated sum of micro-batch gradients, before the mean. A
  micro-batch left out, with the mean taken over the rest, leaves the mean
  alike where the micro-batches' gradients agree, and halves the sum.
- ``grad_gap``: the same for the first step's gradient as the optimizer
  gets it (after the accumulator's mean and the contribution clip).
- ``change_gap``: the same for each leaf's change after the steps
  followed. A parameter whose reference gradient is under a thousandth of
  the median leaf's (such as a key's bias under softmax, whose gradient is
  zero but for rounding) moves by round-off alone and is left out; state
  with no gradient (running statistics) always counts.
- ``*_diff``: the norm of the two sides' difference in place of the gap of
  their norms. It sees an update's direction, which LAMB's and LARS's
  trust ratios keep out of its norm (a change of the wrong sign has the
  right norm).

``*_median`` is the median leaf's number. A cell's file names the numbers
it compares, each with its limit; a number passes when it is at most its
limit; a reading that is not finite is infinitely far.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import torch

QUIET_SHARE = 1e-3  # of the median leaf's reference gradient

Tensors = Dict[str, torch.Tensor]


def norms(tensors: Tensors) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _over_reference(values: Dict[str, float], ref_norms: Dict[str, float]
                    ) -> Dict[str, float]:
    med = statistics.median(ref_norms.values())
    out = {}
    for k, r in ref_norms.items():
        x = values[k] / max(r, med, 1e-30)
        out[k] = x if math.isfinite(x) else math.inf
    return out


def _check(prog: Tensors, ref: Tensors) -> None:
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))[:4]}")


def leaf_gaps(prog: Tensors, ref: Tensors) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms."""
    _check(prog, ref)
    p, r = norms(prog), norms(ref)
    return _over_reference({k: abs(p[k] - r[k]) for k in r}, r)


def leaf_diffs(prog: Tensors, ref: Tensors) -> Dict[str, float]:
    """Each leaf's norm of the two sides' difference."""
    _check(prog, ref)
    diff = {k: float(torch.linalg.vector_norm(prog[k].double() - ref[k].double()))
            for k in ref}
    return _over_reference(diff, norms(ref))


def _worst(per_leaf: Dict[str, float]) -> Tuple[float, str]:
    leaf = max(per_leaf, key=per_leaf.get)
    return per_leaf[leaf], leaf


def gaps(prog: dict, ref: dict) -> Dict[str, object]:
    """Every number, and the leaf each worst-leaf number was read on."""
    n = min(len(prog["losses"]), len(ref["losses"]))
    steps = [abs(a - b) for a, b in zip(prog["losses"][:n], ref["losses"][:n])]
    steps = [g if math.isfinite(g) else math.inf for g in steps]
    ref_grads = norms(ref["grads"])
    med = statistics.median(ref_grads.values())
    quiet = {k for k, g in ref_grads.items() if g < QUIET_SHARE * med}
    keep = lambda d: {k: v for k, v in d.items() if k not in quiet}
    out: Dict[str, object] = {"loss_gap": max(steps), "first_loss_gap": steps[0],
                              "step_loss_gaps": steps}
    for what, p, r in (("sum", prog["sums"], ref["sums"]),
                       ("grad", prog["grads"], ref["grads"]),
                       ("change", keep(prog["changes"]), keep(ref["changes"]))):
        for kind, per_leaf in (("gap", leaf_gaps(p, r)), ("diff", leaf_diffs(p, r))):
            worst, leaf = _worst(per_leaf)
            out[f"{what}_{kind}"] = worst
            out[f"{what}_{kind}_median"] = statistics.median(per_leaf.values())
            out[f"{what}_{kind}_leaf"] = leaf
    out["quiet_leaves"] = sorted(quiet)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell holds a limit for is at most its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
