"""The numbers that decide ``correct``, each held to its limit.

Every number is a gap between what the program produced and what the
plain reference works out from the same inputs, as a share of a scale of
the reference's own, so that one limit holds at any size:

- a scalar answer: ``|program - reference| / scale``;
- a set of leaves (the optimizer's first moment, the parameters' change):
  each leaf's ``| |program| - |reference| |`` (the gap of their norms, not
  the norm of their difference) over the larger of the reference leaf's
  norm and the median leaf's; the number is the median leaf's gap (the
  worst leaf is one of the smallest, whose gradient at the learner's
  initialisation is a near-cancelling sum, and swings over two decades
  from seed to seed).  Leaves whose reference gradient is below a
  thousandth of the median leaf's are left out: Adam moves them by
  round-off alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def scalar_gap(program: float, reference: float, scale: float) -> float:
    if not math.isfinite(program):
        return math.inf
    return abs(program - reference) / scale


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              gradient: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, list]:
    """Each kept leaf's ``[program norm, reference norm, gap]``."""
    norms = {k: float(torch.linalg.vector_norm(v.float())) for k, v in reference.items()}
    keep = _kept(norms, gradient)
    median = statistics.median(norms[k] for k in keep)
    out = {}
    for k in keep:
        p = float(torch.linalg.vector_norm(program[k].float()))
        out[k] = [p, norms[k], abs(p - norms[k]) / max(norms[k], median) if math.isfinite(p) else math.inf]
    return out


def _kept(norms: Dict[str, float], gradient: Optional[Dict[str, torch.Tensor]]) -> list:
    if gradient is None:
        return list(norms)
    g = {k: float(torch.linalg.vector_norm(v.float())) for k, v in gradient.items()}
    g_median = statistics.median(g.values())
    return [k for k in norms if g[k] >= NEGLIGIBLE * g_median]


def median_leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                    gradient: Optional[Dict[str, torch.Tensor]] = None) -> float:
    """The median over the kept leaves of their gaps of norms (module
    docstring); ``gradient`` (the reference's gradient measure by leaf)
    names the leaves left out."""
    return statistics.median(v[2] for v in leaf_gaps(program, reference, gradient).values())


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> tuple:
    """``(correct, checked)``: every number at or under its limit, and
    ``{name: {"value", "limit"}}`` in the numbers' order.  A number without
    a limit fails."""
    checked = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        checked[name] = {"value": value, "limit": limit}
        if limit is None or not (value <= limit):
            ok = False
    return ok, checked
