"""The comparison that decides ``correct`` for a training cell.

A record holds what one side's first steps produced from the same weights and
batches: each step's loss, the norm of each leaf's step-1 gradient, and the
norm of each leaf's change after the steps (a stacked leaf counts once a
layer, ``weights.slices``). The numbers that compare the program's record
with the reference's:

- ``loss``: the largest relative gap of a step's loss; ``loss1``: step 1's;
- ``grad``: the worst leaf's gap between the two gradient norms, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  ``grad_median``: the median leaf's gap;
- ``change``, ``change_median``: the same of the change's norms, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf the loss leaves all but untouched moves under Adam by
  round-off alone).

A cell compares the numbers its file (``portbench/workloads/<cell>.json``)
gives limits for; the run is correct when each is at or under its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NAMES = ("loss", "loss1", "grad", "grad_median", "change", "change_median")
STILL = 1e-3  # of the median leaf's gradient norm


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """Per leaf, the gap of the two norms over the reference's norm of the
    leaf or of the median leaf, whichever is larger; inf where the
    program's is missing or not finite."""
    names = list(names)
    floor = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        gap = abs(prog.get(n, float("nan")) - ref[n]) / max(ref[n], floor)
        out[n] = gap if math.isfinite(gap) else float("inf")
    return out


def _worst(per: Dict[str, float]) -> Dict:
    name = max(per, key=per.get)
    return {"value": per[name], "at": name}


def _median(per: Dict[str, float]) -> Dict:
    return {"value": statistics.median(per.values()), "at": f"median of {len(per)} leaves"}


def gaps(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """``{name: {"value": gap, "at": where}}`` for each of :data:`NAMES`."""
    steps = {f"step {i + 1}": abs(a - b) / abs(b)
             for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    steps = {k: v if math.isfinite(v) else float("inf") for k, v in steps.items()}
    if len(prog["losses"]) != len(ref["losses"]):
        steps["steps"] = float("inf")
    grad = _leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    median_grad = statistics.median(ref["grad"].values())
    change = _leaf_gaps(prog["change"], ref["change"],
                        [n for n, g in ref["grad"].items() if g >= STILL * median_grad])
    return {"loss": _worst(steps), "loss1": {"value": steps["step 1"], "at": "step 1"},
            "grad": _worst(grad), "grad_median": _median(grad),
            "change": _worst(change), "change_median": _median(change)}


def judge(found: Dict[str, Dict], limits: Dict[str, float]) -> Tuple[bool, Dict, List[str]]:
    """(correct, the result line's ``checks``, the lines for standard
    error): each number the cell compares (its ``limits``) beside its
    limit."""
    checks, lines, ok = {}, [], True
    for name, limit in limits.items():
        value = found[name]["value"]
        ok = ok and value <= limit
        checks[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} (worst at {found[name]['at']})")
    return ok, checks, lines
