"""What decides `correct`: the program's first steps against the reference's.

The numbers compared, each a gap between the program's reading and the
reference's (both lists of readings as run.first_steps and
reference.run_steps give them):

- `loss_gap`: the largest |loss| gap over the steps compared, in nats;
- `gnorm_gap`: the largest gap of the raw global gradient norm over those
  steps, as a share of the reference's;
- `grad_gap`: step 1's gradient as the optimizer got it (clipped), by the
  worst leaf: the gap between the two norms of the leaf, as a share of the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- `change_gap`: how far each leaf moved over the steps, by the worst leaf
  in the same way, leaving out leaves whose raw gradient in the reference
  is under a thousandth of the median leaf's (such a leaf moves under Adam
  by round-off alone).

A cell's limits file (`benchmark/limits/<cell>.json`) gives each number's
limit; the cell compares the numbers its file names, and `steps`, the
steps the reference follows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

NUMBERS = ("loss_gap", "gnorm_gap", "grad_gap", "change_gap")
# A leaf whose raw gradient is under this share of the median leaf's moves
# by round-off alone.
STILL = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    names = sorted(ref) if keep is None else keep
    median = sorted(ref[n] for n in names)[len(names) // 2]
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """The leaf that sets `grad_gap` and the one that sets `change_gap`."""
    out = {}
    for key in ("grad_leaf", "change_leaf"):
        by_leaf = leaf_gaps(prog[key], ref[key])
        out[key] = max(by_leaf, key=by_leaf.get)
    return out


def still_leaves(ref: dict) -> List[str]:
    """The leaves left out of `change_gap`: raw gradient in the reference
    under STILL of the median leaf's."""
    raw = ref["raw_leaf"]
    median = sorted(raw.values())[len(raw) // 2]
    return sorted(k for k, v in raw.items() if v < STILL * median)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    n = len(ref["loss"])
    still = still_leaves(ref)
    moving = sorted(k for k in ref["raw_leaf"] if k not in still)
    return {
        "loss_gap": max(abs(prog["loss"][i] - ref["loss"][i]) for i in range(n)),
        "gnorm_gap": max(abs(prog["grad_norm"][i] - ref["grad_norm"][i]) / ref["grad_norm"][i]
                         for i in range(n)),
        "grad_gap": max(leaf_gaps(prog["grad_leaf"], ref["grad_leaf"]).values()),
        "change_gap": max(leaf_gaps(prog["change_leaf"], ref["change_leaf"], moving).values()),
    }


def judge(values: Dict[str, float], limits: dict) -> Tuple[Dict[str, dict], bool]:
    """({number: {value, limit}}, whether every number is within its limit;
    a number that is not finite is not)."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    if not checks:
        raise ValueError("the cell's limits name no number to compare")
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return checks, ok
