"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, on the same weights and batches.

The numbers, each against a limit of the cell's; a cell compares the
numbers its file gives limits for:

* ``loss``: the largest relative gap of a step's a2c loss over the
  compared steps;
* ``entropy``: the same of the loss's entropy term: lower precision in
  the logits widens their spread and lifts the entropy, where the total
  is led by its policy-gradient term's noise;
* ``grad``: the first gradient's norm, leaf by leaf, as the optimizer
  got it; each leaf's gap between the two norms, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change``: the norm of each leaf's change over the compared steps,
  each leaf's gap likewise.

A leaf number is the worst leaf's gap, or where the cell's file says so
for that number (``"leaf_stat": {"grad": "median"}``) the median leaf's:
for a configuration whose low-precision gradient is chaotic in its
shallow leaves, where the worst leaf reads rounding amplified through
depth and not the program.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of ``grad`` and ``change``: Adam moves them by
round-off alone.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

FLAT = 1e-3
NUMBERS = ("loss", "entropy", "grad", "change")


def kept(ref_grad: Dict[str, float]) -> set:
    """The leaves compared: reference gradient norm >= FLAT x median."""
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= FLAT * med}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: set) -> Dict[str, float]:
    """Each leaf's gap, over the larger of its and the median leaf's
    reference norm."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in leaves}


def ranked(prog: dict, ref: dict, key: str, top: int = 5) -> list:
    """The ``top`` leaves of ``key`` by gap: (leaf, gap, program's,
    reference's)."""
    gaps = leaf_gaps(prog[key], ref[key], kept(ref["grad"]))
    return [(n, gaps[n], prog[key][n], ref[key][n])
            for n in sorted(gaps, key=gaps.get, reverse=True)[:top]]


def readings(prog: dict, ref: dict,
             leaf_stat: Optional[Dict[str, str]] = None) -> Dict[str, dict]:
    """{number: {"value", and for a leaf number "leaf"}} of the program's
    readings ``prog`` against the reference's ``ref`` (each {"terms":
    [per step {"loss", "entropy", ...}], "grad": {leaf: norm}, "change":
    {leaf: norm}}); a leaf number is the worst leaf's gap, or the median
    leaf's where ``leaf_stat`` maps it to ``"median"``."""
    leaf_stat = leaf_stat or {}
    out = {}
    for term in ("loss", "entropy"):
        p, r = ([t[term] for t in x["terms"]] for x in (prog, ref))
        gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(p, r))
        out[term] = {"value": gap if len(p) == len(r) else math.inf}
    leaves = kept(ref["grad"])
    for key in ("grad", "change"):
        if set(prog[key]) != set(ref[key]):
            out[key] = {"value": math.inf, "leaf": "leaves differ"}
            continue
        gaps = leaf_gaps(prog[key], ref[key], leaves)
        order = sorted(gaps, key=gaps.get)
        stat = leaf_stat.get(key, "worst")
        if stat == "worst":
            leaf = order[-1]
        elif stat == "median":
            leaf = order[(len(order) - 1) // 2]
        else:
            raise ValueError(f"unknown leaf_stat {stat!r}")
        out[key] = {"value": gaps[leaf], "leaf": leaf}
    return out


def verdict(found: Dict[str, dict], limits: Dict[str, float]) -> Tuple[
        bool, Dict[str, dict]]:
    """(correct, each number the cell has a limit for beside its
    limit)."""
    checks = {k: {"value": found[k]["value"], "limit": limits[k],
                  **({"leaf": found[k]["leaf"]} if "leaf" in found[k]
                     else {})} for k in NUMBERS if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
