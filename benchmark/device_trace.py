"""Reads a torch.profiler trace of the measured window into what the
per-layer metrics need, from the profiler's raw events.

- Device operations: the kernels, copies and fills the card ran inside
  the window, each with the host op that launched it (the profiler's
  correlation link) and that op's enclosing ops on its thread.
- Busy time: the union of the device operations' intervals, so two that
  overlap count once; idle time is the window less that.
- Host spans: the benchmark's own `bench.*` spans around each call into
  the program (run.py), and the program's ops under them, which name what
  the host was doing in each idle gap.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
# CUDA runtime and driver calls: their ids are the tracer's, not the ops'.
_API = re.compile(r"^(cuda|cu[A-Z])")


@dataclass
class DeviceOp:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    op: int  # correlation id of the host op that launched it (0: none)


@dataclass
class HostOp:
    name: str
    start: int
    end: int
    thread: int
    parent: Optional[int] = None  # correlation id


@dataclass
class Trace:
    window: Tuple[int, int]
    device: List[DeviceOp]
    host: Dict[int, HostOp]
    main_thread: int
    _by_thread: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for s, e in sorted((max(d.start, lo), min(d.end, hi)) for d in self.device):
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The window's idle intervals, in order."""
        edges, t = [], self.window[0]
        for s, e in self.busy():
            if s > t:
                edges.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            edges.append((t, self.window[1]))
        return edges

    def chain(self, op: int) -> List[str]:
        """The names of host op `op` and of the ops that enclose it, the
        innermost first."""
        names = []
        while op in self.host:
            names.append(self.host[op].name)
            op = self.host[op].parent
        return names

    def under(self, dev: DeviceOp, names: Iterable[str]) -> Optional[int]:
        """The id of the outermost host op named in `names` among those that
        launched `dev`: one call of that op, however its dispatch nests."""
        found, op = None, dev.op
        while op in self.host:
            if self.host[op].name in names:
                found = op
            op = self.host[op].parent
        return found

    def host_at(self, t: int) -> str:
        """What the window's thread was doing at `t`: its outermost benchmark
        span and its innermost op, as "span > op"."""
        spans = self._by_thread.get(self.main_thread, [])
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        # The innermost op holding t encloses the last op to start before t.
        inner = spans[i][1] if i >= 0 else None
        while inner is not None and self.host[inner].end <= t:
            inner = self.host[inner].parent
        if inner is None:
            return "host idle"
        names = self.chain(inner)
        outer = next((n for n in reversed(names) if n.startswith(SPAN_PREFIX)
                      and n != WINDOW_SPAN), None)
        return names[0] if outer is None or outer == names[0] else f"{outer} > {names[0]}"


def from_profiler(prof) -> Trace:
    """The trace of a finished `torch.profiler.profile` whose window the
    benchmark marked with a `bench.window` span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host: Dict[int, HostOp] = {}
    device: List[DeviceOp] = []
    window = None
    main = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if (e.start_thread_id() != e.end_thread_id() or e.correlation_id() == 0
                    or _API.match(name)):
                continue
            host[e.correlation_id()] = HostOp(name, e.start_ns(), e.end_ns(),
                                              e.start_thread_id())
            if name == WINDOW_SPAN:
                window, main = (e.start_ns(), e.end_ns()), e.start_thread_id()
        elif not name.startswith(SPAN_PREFIX) and not _annotation(e):
            device.append(DeviceOp(name, e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    by_thread = _nest(host)
    lo, hi = window
    device = [d for d in device if d.end > lo and d.start < hi]
    return Trace(window=window, device=device, host=host, main_thread=main,
                 _by_thread=by_thread)


def _annotation(e) -> bool:
    is_annotation = getattr(e, "is_user_annotation", None)
    return bool(is_annotation and is_annotation())


def _nest(host: Dict[int, HostOp]) -> Dict[int, List[Tuple[int, int]]]:
    """Sets each host op's parent (the innermost op of its thread that
    encloses it); returns each thread's (start, id) list in order."""
    threads: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
    for cid, op in host.items():
        threads[op.thread].append((op.start, -op.end, cid))
    out = {}
    for tid, ops in threads.items():
        ops.sort()
        stack: List[int] = []
        for start, neg_end, cid in ops:
            while stack and host[stack[-1]].end <= start:
                stack.pop()
            if stack and host[stack[-1]].end >= -neg_end:
                host[cid].parent = stack[-1]
            stack.append(cid)
        out[tid] = [(start, cid) for start, _, cid in ops]
    return out
