"""The program's own ranges in a traced window, and the device time under
them, for the per-layer metrics that follow the train step's layers rather
than kernel names.

The port opens these ranges (training_operator_tpu_torch/observe/spans.py)
only while a profiler is active; `device_trace.from_profiler` reads them as
host ops like any other. The names are copied here, as the yardstick's
arithmetic is: a reader finds nothing under a name the program lacks, and
then returns None.

- A kernel is *under* a range when the range is in the chain of host ops
  that launched it (`Trace.chain`).
- A kernel's *phase* follows from when the host op that launched it
  started, on any thread: inside a `train.backward` range, the backward; else
  inside a `train.step` range, the forward before that step's backward and
  the optimizer after it. On a card, autograd's device thread launches the
  backward's kernels while the caller's thread waits inside
  `train.backward`, and a range that opens in one autograd node and closes
  in another (`model.head.grad`) has no parent, so no chain from inside it
  reaches `train.backward`. And the trace gives its overhead events (a full
  command buffer) the correlation id of an op open on the caller's thread,
  which `from_profiler` then takes for that op: on an H100, up to 2 of a
  40 s window's 19 to 44 `train.forward` or `train.optimizer` ranges went
  so, while `train.step` and `train.backward`, inside which the caller's
  thread launches nothing itself, kept theirs.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

from benchmark.device_trace import DeviceOp, Trace

STEP = "train.step"
FORWARD = "train.forward"
BACKWARD = "train.backward"
BACKWARD_WAIT = "train.backward.wait"
OPTIMIZER = "train.optimizer"
HEAD = "model.head"
HEAD_GRAD = "model.head.grad"
LAYER = "model.layer"
DATA = "data.next"
NAMES = frozenset((STEP, FORWARD, BACKWARD, BACKWARD_WAIT, OPTIMIZER, HEAD, HEAD_GRAD, LAYER,
                   DATA))


class Spans:
    """The program's ranges of one trace, as each device op sees them."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self._names: Dict[int, FrozenSet[str]] = {}
        self._steps = _intervals(trace, STEP)
        self._backward = _intervals(trace, BACKWARD)
        self._backward_starts = [start for start, _ in self._backward]

    def chain(self, d: DeviceOp) -> FrozenSet[str]:
        """The program's range names in the chain of host ops that launched
        `d`."""
        host, memo = self.trace.host, self._names
        path, op = [], d.op
        while op in host and op not in memo:
            path.append(op)
            op = host[op].parent
        names = memo.get(op, frozenset())
        for op in reversed(path):
            if host[op].name in NAMES:
                names = names | {host[op].name}
            memo[op] = names
        return names

    def phase(self, d: DeviceOp) -> Optional[str]:
        """"forward", "backward" or "optimizer" by when the host op that
        launched `d` started; None outside every step."""
        op = self.trace.host.get(d.op)
        if op is None:
            return None
        if _holding(self._backward, op.start) is not None:
            return "backward"
        step = _holding(self._steps, op.start)
        if step is None:
            return None
        starts = self._backward_starts
        i = bisect.bisect_left(starts, step[0])
        if i == len(starts) or starts[i] > step[1]:
            return None
        return "forward" if op.start < starts[i] else "optimizer"


def _intervals(trace: Trace, name: str) -> List[Tuple[int, int]]:
    return sorted((op.start, op.end) for op in trace.host.values() if op.name == name)


def _holding(intervals: List[Tuple[int, int]], t: int) -> Optional[Tuple[int, int]]:
    """The interval of `intervals` (sorted, none overlapping) that holds
    `t`, or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return intervals[i] if i >= 0 and t <= intervals[i][1] else None


def device_ms(run, keep: Callable[[Spans, DeviceOp], bool]) -> Optional[float]:
    """Device ms per traced step of the window's device ops that `keep`
    selects, each counted once; None without a trace, steps, device ops or
    a selected op."""
    t = run.trace
    if t is None or run.steps == 0 or not t.device:
        return None
    spans = Spans(t)
    ns = sum(d.end - d.start for d in t.device if keep(spans, d))
    return ns / 1e6 / run.steps if ns else None
