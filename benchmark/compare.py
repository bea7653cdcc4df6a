"""The comparison that decides ``correct`` for a training cell.

Both sides hand over the same readings of the first three steps, from one
set of inputs: each step's losses, the norm of the first gradient leaf by
leaf (as the optimizer got it) and the norm of each leaf's change after the
three steps. The numbers compared are

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps and
  losses;
- ``grad_gap`` and ``delta_gap``: over the leaves, the largest gap between
  the two norms (not the norm of their difference), over the reference's
  norm of that leaf or of the median leaf, whichever is larger.

Leaves whose reference gradient is under a thousandth of the median leaf's
are nought to rounding, move by round-off alone, and are left out of both
(``SKIP_BELOW``).
"""

from __future__ import annotations

import math
import statistics

import torch

SKIP_BELOW = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "delta_gap")


def flat(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of nested dicts and lists: the leaf names
    both sides use (``blocks.3.qkv``, ``deep.w0``)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def norm(x: torch.Tensor) -> float:
    """The Euclidean norm of a leaf, summed in float64."""
    return float(torch.linalg.vector_norm(x.double()))


def _leaf_gap(prog: dict, ref: dict, keep: list[str]) -> float:
    if set(prog) != set(ref):
        return math.inf  # a leaf missing on one side
    floor = statistics.median(ref[k] for k in keep)
    gap = 0.0
    for k in keep:
        a, r = float(prog[k]), float(ref[k])
        if not math.isfinite(a):
            return math.inf
        gap = max(gap, abs(a - r) / max(r, floor))
    return gap


def numbers(prog: dict, ref: dict) -> dict:
    """``{loss_gap, grad_gap, delta_gap}`` of the program's readings
    against the reference's (see the module docstring)."""
    pl, rl = prog["loss"], ref["loss"]
    if len(pl) != len(rl) or any(len(a) != len(b) for a, b in zip(pl, rl)):
        loss_gap = math.inf
    else:
        loss_gap = max(abs(float(a) - float(r)) / abs(float(r))
                       if math.isfinite(float(a)) else math.inf
                       for sa, sr in zip(pl, rl) for a, r in zip(sa, sr))
    med = statistics.median(ref["grad"].values())
    keep = sorted(k for k, v in ref["grad"].items() if v >= SKIP_BELOW * med)
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["grad"], ref["grad"], keep),
            "delta_gap": _leaf_gap(prog["delta"], ref["delta"], keep),
            "leaves": len(ref["grad"]), "leaves_skipped":
                len(ref["grad"]) - len(keep)}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number compared under its limit, {name: {value, limit}}).
    The cell's limits file names the numbers compared; a number with no
    upper reading there (``"limit": null``) is not compared."""
    checks = {k: {"value": nums[k], "limit": limits[k]["limit"]}
              for k in NUMBERS if limits[k]["limit"] is not None}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
