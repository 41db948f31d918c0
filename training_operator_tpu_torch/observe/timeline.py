"""Job-lifecycle span tracer: per-job phase timelines on the API server.

Dapper-style per-request tracing applied to the TrainJob lifecycle
(SURVEY §5: the reference's only observability is flat counters plus k8s
Events — nobody can answer "where did this job spend its time: admission,
queue, gang solve, bind, or container start?" without reading logs).

The model is deliberately small:

- A `Span` is a named interval on one job's timeline. `start`/`end` are
  cluster-clock timestamps (comparable with job conditions and Events);
  `wall` carries the REAL elapsed seconds where the measurement is a wall
  quantity (solver time, queue wait) — on a virtual clock start == end for
  instantaneous work, and `wall` is then the truthful duration.
- A `JobTimeline` is a bounded ring of completed spans plus first-wins
  `marks` (named instants), keyed by (namespace, name). Span `uid` attrs
  distinguish incarnations of a recreated name; the timeline itself is NOT
  reset on uid change — a TrainJob and the workload job it owns share a
  name on purpose, and their spans interleave into one lifecycle view.
- A `TimelineStore` holds one timeline per job in an LRU ring (oldest job
  evicted past `max_jobs`), with an injected clock so virtual-clock
  simulations trace in simulated time.

Everything here is dependency-free (no cluster imports): the APIServer
owns a store instance, and instrumentation sites reach it as
`api.timelines`. Tracing can be disabled process-wide (`set_enabled`) —
the bench's `observe` block measures that the instrumented hot paths stay
within 5% of the disabled run.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Process-wide master switch, consulted by every record/mark call. Module
# attribute (not config) so the bench and tests can flip it without
# plumbing; per-store `enabled` composes with it.
_ENABLED = True


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


@dataclass
class Span:
    """One completed interval of a job's lifecycle."""

    name: str
    start: float
    end: float
    # Real elapsed seconds when the measurement is a wall quantity (queue
    # wait, solver time); 0.0 means "end - start is the duration".
    wall: float = 0.0
    attrs: Dict[str, Any] = field(default_factory=dict)

    def duration(self) -> float:
        """The truthful duration: wall where recorded, else end - start."""
        return self.wall if self.wall > 0.0 else max(0.0, self.end - self.start)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "wall": self.wall,
            "attrs": dict(self.attrs),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(
            name=str(d.get("name", "")),
            start=float(d.get("start", 0.0)),
            end=float(d.get("end", 0.0)),
            wall=float(d.get("wall", 0.0)),
            attrs=dict(d.get("attrs", {})),
        )


class JobTimeline:
    """Bounded span ring + first-wins marks for one (namespace, name)."""

    def __init__(self, namespace: str, name: str, max_spans: int = 256):
        self.namespace = namespace
        self.name = name
        self.uids: List[str] = []  # insertion order, first = original
        self.spans: "deque[Span]" = deque(maxlen=max_spans)
        self.marks: Dict[str, float] = {}

    def sorted_spans(self) -> List[Span]:
        """Spans in timeline order (start, then end) — recording order is
        arrival order across components, not time order."""
        return sorted(self.spans, key=lambda s: (s.start, s.end, s.name))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "namespace": self.namespace,
            "name": self.name,
            "uids": list(self.uids),
            "spans": [s.to_dict() for s in self.sorted_spans()],
            "marks": dict(self.marks),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any], max_spans: int = 256) -> "JobTimeline":
        tl = cls(d.get("namespace", ""), d.get("name", ""), max_spans=max_spans)
        tl.uids = list(d.get("uids", []))
        for sd in d.get("spans", []):
            tl.spans.append(Span.from_dict(sd))
        tl.marks = {str(k): float(v) for k, v in d.get("marks", {}).items()}
        return tl


class TimelineStore:
    """LRU ring of JobTimelines, keyed by (namespace, name).

    Thread-safe: instrumentation records from API handler threads, manager
    worker pools, and the scheduler tick concurrently. `now_fn` is the
    injected cluster clock (Cluster wires its own in; the host role's
    WallClock makes timestamps restart-comparable)."""

    def __init__(self, now_fn=None, max_jobs: int = 512, max_spans: int = 256):
        self._now = now_fn or _time.time
        self.max_jobs = max_jobs
        self.max_spans = max_spans
        self.enabled = True
        self._jobs: "OrderedDict[tuple, JobTimeline]" = OrderedDict()
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def set_clock(self, now_fn) -> None:
        self._now = now_fn

    def now(self) -> float:
        return self._now()

    def count(self) -> int:
        """Timelines currently retained (LRU-bounded by max_jobs) — the
        INV009 accumulator feed."""
        with self._lock:
            return len(self._jobs)

    def _timeline_locked(self, namespace: str, name: str) -> JobTimeline:
        key = (namespace or "", name)
        tl = self._jobs.get(key)
        if tl is None:
            tl = self._jobs[key] = JobTimeline(
                namespace or "", name, max_spans=self.max_spans
            )
        self._jobs.move_to_end(key)
        while len(self._jobs) > self.max_jobs:
            self._jobs.popitem(last=False)
        return tl

    # Incarnation history cap: a name resubmitted forever (nightly jobs)
    # must not grow its uid list unboundedly — keep the first + recent.
    MAX_UIDS = 8

    @classmethod
    def _note_uid(cls, tl: JobTimeline, uid: str) -> None:
        if not uid or uid in tl.uids:
            return
        if len(tl.uids) >= cls.MAX_UIDS:
            tl.uids = [tl.uids[0], *tl.uids[-(cls.MAX_UIDS - 2):]]
        tl.uids.append(uid)

    def record_span(
        self,
        namespace: str,
        name: str,
        uid: str,
        span_name: str,
        start: Optional[float] = None,
        end: Optional[float] = None,
        wall: float = 0.0,
        attrs: Optional[Dict[str, Any]] = None,
        **extra: Any,
    ) -> None:
        """Record one completed span. `start`/`end` default to now; `wall`
        carries the real elapsed seconds where that is the measurement.
        Attributes ride either as keywords (trusted call sites) or via
        `attrs` — the wire ingest path, where client-chosen keys must not
        collide with this signature."""
        if not (_ENABLED and self.enabled):
            return
        t = None
        if start is None or end is None:
            t = self._now()
        merged = {**(attrs or {}), **extra}
        span = Span(
            span_name,
            t if start is None else start,
            t if end is None else end,
            wall=wall,
            attrs=merged,
        )
        if uid:
            span.attrs.setdefault("uid", uid)
        with self._lock:
            tl = self._timeline_locked(namespace, name)
            self._note_uid(tl, uid)
            tl.spans.append(span)

    def mark(
        self, namespace: str, name: str, uid: str, mark_name: str,
        t: Optional[float] = None,
    ) -> None:
        """First-wins named instant (e.g. "created", "running")."""
        if not (_ENABLED and self.enabled):
            return
        if t is None:
            t = self._now()
        with self._lock:
            tl = self._timeline_locked(namespace, name)
            self._note_uid(tl, uid)
            tl.marks.setdefault(mark_name, t)

    def timeline(self, namespace: str, name: str) -> Optional[JobTimeline]:
        with self._lock:
            return self._jobs.get((namespace or "", name))

    def timelines(self) -> List[JobTimeline]:
        with self._lock:
            return list(self._jobs.values())

    def forget(self, namespace: str, name: str) -> None:
        with self._lock:
            self._jobs.pop((namespace or "", name), None)
