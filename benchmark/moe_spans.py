"""The port's expert-layer ranges and its counter in a traced window, for
the per-layer metrics of a MoE cell.

The port's dropless MoE layer (training_operator_tpu_torch/trainer/moe.py)
opens these ranges only while a profiler is active
(training_operator_tpu_torch/observe/spans.py); the names are copied here,
as program_spans.py copies the step's, so a reader finds nothing under a
name the program lacks and returns None.

- `model.moe`: the layer's forward and its recompute; `model.moe.route`
  and `model.moe.experts` inside it;
- `model.moe.grad`: the layer's backward, from its first autograd node to
  its last; `model.moe.experts.grad`, the grouped products' backward,
  inside it. Both open in one node and close in another, so neither has a
  parent in the trace (as `model.head.grad`): a kernel under
  `model.moe.experts.grad` has no chain up to `model.moe.grad`.
- the counter `model.moe.expert_load_max`: once a layer and step, an empty
  host range named `model.moe.expert_load_max=<value>`.

A kernel is under a range when the range is in the chain of host ops that
launched it (`Trace.under`).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional

from benchmark.device_trace import Trace

MOE = "model.moe"
MOE_GRAD = "model.moe.grad"
ROUTE = "model.moe.route"
EXPERTS = "model.moe.experts"
EXPERTS_GRAD = "model.moe.experts.grad"
EXPERT_LOAD = "model.moe.expert_load_max"
# Every kernel of the layer: the products' backward range lies inside the
# layer's, but the trace does not chain it there.
LAYER = frozenset((MOE, MOE_GRAD, EXPERTS_GRAD))


def device_ms(run, names: FrozenSet[str]) -> Optional[float]:
    """Device ms per traced step of the kernels under any range of `names`,
    each counted once; None without a trace, steps or such a kernel."""
    t = run.trace
    if t is None or run.steps == 0:
        return None
    ns = sum(d.end - d.start for d in t.device if t.under(d, names) is not None)
    return ns / 1e6 / run.steps if ns else None


def expert_calls(t: Trace) -> Dict[str, object]:
    """The grouped products' calls in the window and their kernels' device
    ns: {"forward": calls under `model.moe.experts` (forward and recompute),
    "backward": calls under `model.moe.experts.grad`, "ns": their kernels'
    time}; a call is one range holding at least one kernel."""
    ids = {"forward": set(), "backward": set()}
    ns = 0
    for d in t.device:
        grad = t.under(d, (EXPERTS_GRAD,))
        call = grad if grad is not None else t.under(d, (EXPERTS,))
        if call is None:
            continue
        ids["backward" if grad is not None else "forward"].add(call)
        ns += d.end - d.start
    return {"forward": len(ids["forward"]), "backward": len(ids["backward"]), "ns": ns}


def counter_values(t: Trace, name: str) -> List[float]:
    """The values of counter `name` the window's trace holds."""
    prefix = name + "="
    return [float(op.name[len(prefix):]) for op in t.host.values()
            if op.name.startswith(prefix)]
