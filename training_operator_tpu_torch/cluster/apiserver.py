"""In-process API server: object store + watch streams + optimistic concurrency.

This is the substrate the reconcile engine writes to, standing in for the
Kubernetes API server. Three properties matter and are reproduced faithfully:

1. **Asynchronous watch echo.** Writes return immediately, but watch events are
   *queued* and only observed when the consumer drains its informer queue.
   This is exactly the window the reference's expectations cache exists for
   (expectation/expectation.go:29-40): between `CreatePod` returning and the
   informer seeing the new pod, a naive reconcile would create duplicates.

2. **Optimistic concurrency.** Every write bumps `resourceVersion`; an update
   carrying a stale version conflicts (like k8s), which the engine's status
   writer must retry (reference UpdateJobStatusInApiServer path).

3. **Copy-on-read.** get/list return deep copies and writes store copies, so
   in-place mutation of a read object never reaches the store without an
   update() — the class of stale-read/lost-update bug real k8s surfaces is
   surfaced here too instead of being structurally invisible. Watch events
   carry ONE shared copy per write (the informer contract: handlers may keep
   the object but must treat it as read-only or accept cross-watcher skew;
   the store itself can't be corrupted either way).

A per-(kind, label) inverted index backs label-selector lists, so the engine's
per-job pod/service lookups don't scan (and clone) the whole pod population.

Counterpart of training_operator_tpu/cluster/apiserver.py. The store is
volatile here: the write-ahead journal, snapshot and restore, replication and
the uid floor belong to the wire and HA, which are still to be ported.
"""

from __future__ import annotations

import copy as _copylib
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

from training_operator_tpu_torch.cluster.objects import Event
from training_operator_tpu_torch.observe.timeline import TimelineStore
from training_operator_tpu_torch.utils import metrics

# Default event-retention cap (see APIServer._event_cap). Sized to hold
# every event of a 1k-job burst several times over; long-lived hosts and
# soak runs may lower it via set_event_cap.
DEFAULT_EVENT_CAP = 16384


def _is_job_like(obj: Any) -> bool:
    """Objects the lifecycle tracer follows: v1 jobs (replica_specs) and v2
    TrainJobs — not pods/services/etc., whose churn would flood the ring."""
    return hasattr(obj, "replica_specs") or obj.KIND == "TrainJob"


class ConflictError(Exception):
    """Stale resourceVersion on update."""


class AlreadyExistsError(Exception):
    pass


class NotFoundError(Exception):
    pass


def graft_status_retry(try_get: Callable, update: Callable, obj: Any) -> None:
    """THE conflict arm for the engine's status writes: re-get the current
    stored version, graft the writer's status AND its annotation changes
    (the recreate-restart budget rides an annotation — dropping its bump on
    a raced write would let a crash-looping job restart past its backoff
    limit forever), then write unconditionally (the controller's tally is the truth source).
    NotFoundError from either call means the object was deleted in the
    race window — nothing left to write; callers decide what that means."""
    fresh = try_get(
        obj.KIND, getattr(obj.metadata, "namespace", "") or "", obj.metadata.name
    )
    if fresh is None:
        return
    fresh.status = obj.status
    merged = dict(fresh.metadata.annotations)
    merged.update(obj.metadata.annotations)
    fresh.metadata.annotations = merged
    update(fresh, check_version=False, status_only=True)


@dataclass
class WatchEvent:
    type: str  # Added | Modified | Deleted
    kind: str
    obj: Any
    # True for writes that only touched .status (controllers' own writes);
    # managers skip re-enqueueing these to avoid self-echo reconcile storms
    # (the role GenerationChangedPredicate plays in controller-runtime).
    status_only: bool = False


class WatchQueue:
    """A subscriber's pending-event queue (an informer's delta FIFO)."""

    def __init__(self, kinds: Optional[Iterable[str]] = None):
        self.kinds = set(kinds) if kinds else None
        self._q: Deque[WatchEvent] = deque()

    def push(self, ev: WatchEvent) -> None:
        if self.kinds is None or ev.kind in self.kinds:
            self._q.append(ev)

    def drain(self) -> List[WatchEvent]:
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self) -> int:
        return len(self._q)


class SharedInformer:
    """Cluster-wide read cache fed by one watch stream (controller-runtime's
    shared informer). Components read full state from here instead of listing
    (and cloning) the store on every tick; the cache holds the per-write
    event copies, so reads are O(1) and allocation-free.

    Contract: cached objects are the shared event copies — treat them as
    read-only unless you immediately persist the same change with update()
    (write-through). sync() applies queued events; `Cluster.step` calls it
    before tickers run, so caches lag the store by at most one tick — the
    same lag every real informer has.
    """

    def __init__(self, api: "APIServer"):
        self._watch = api.watch()
        self.caches: Dict[str, Dict[Tuple[str, str], Any]] = {}
        # Seed from the store (initial LIST, then WATCH).
        for kind in list(api._by_kind):
            for obj in api.list(kind):
                ns = getattr(obj.metadata, "namespace", "") or ""
                self.caches.setdefault(kind, {})[(ns, obj.metadata.name)] = obj

    def sync(self) -> None:
        for ev in self._watch.drain():
            ns = getattr(ev.obj.metadata, "namespace", "") or ""
            key = (ns, ev.obj.metadata.name)
            if ev.type == "Deleted":
                self.caches.get(ev.kind, {}).pop(key, None)
            else:
                self.caches.setdefault(ev.kind, {})[key] = ev.obj

    def list(self, kind: str) -> List[Any]:
        return list(self.caches.get(kind, {}).values())

    def get(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        return self.caches.get(kind, {}).get((namespace or "", name))


class APIServer:
    """Typed object store keyed by (kind, namespace, name)."""

    def __init__(self) -> None:
        self._objects: Dict[Tuple[str, str, str], Any] = {}
        # Per-kind index so list(kind) doesn't scan the whole store — at
        # 1k-job-burst scale the reconcilers list pods thousands of times.
        self._by_kind: Dict[str, Dict[Tuple[str, str], Any]] = {}
        # Inverted label index: (kind, label_key, label_value) -> {(ns, name)}
        # so selector lists touch only matching objects.
        self._by_label: Dict[Tuple[str, str, str], set] = {}
        self._rv_value = 0
        self._watchers: List[WatchQueue] = []
        self._events: List[Event] = []
        # Event aggregation index (k8s parity): aggregation_key -> index in
        # _events, so identical repeats bump a count instead of appending.
        self._event_index: Dict[tuple, int] = {}
        # Per-object read index: object_name -> indices into _events, so
        # `events(object_name=...)` (the explain/attribution evidence read,
        # issued once per job) is O(own events), not a full-list scan.
        self._events_by_name: Dict[str, List[int]] = {}
        # Event retention bound (the k8s events-TTL analogue, count-shaped
        # for a virtual-clock store): the event list was the last unbounded
        # accumulator in the control plane — a week-long soak grows it
        # linearly with fleet life while everything else (timelines, resume
        # rings, WAL ring, pod logs) is ring-bounded. Past the cap the
        # OLDEST quarter is dropped (hysteresis: trimming exactly to cap
        # would rebuild the aggregation index on every append once full).
        # Aggregated repeats keep bumping retained records; a repeat of a
        # dropped record starts a fresh count, exactly like an expired k8s
        # Event recurring.
        self._event_cap = DEFAULT_EVENT_CAP
        # lockcheck: allow CL008 — store lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.RLock()
        # Admission hooks: kind -> [callable(obj) raising on rejection]
        self._admission: Dict[str, List[Callable[[Any], None]]] = {}
        # Per-pod log buffers (the k8s pod-log subresource analogue): the
        # kubelet appends lifecycle + container stdout lines; readers tail
        # by cursor so `follow` streaming is O(new lines). Bounded per pod;
        # `base` keeps cursors stable across trimming. Logs die with the
        # pod object, like kubelet-held logs do.
        self._pod_logs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._pod_log_max = 4096
        # Job-lifecycle timeline ring (observe/timeline.py): admission,
        # queue-wait, reconcile, gang-solve, bind, and condition-transition
        # spans land here, served at GET /timelines/{ns}/{name}. The owning
        # Cluster injects its clock so virtual-clock sims trace in sim time.
        self.timelines = TimelineStore()

    @staticmethod
    def _clone(obj: Any) -> Any:
        return _copylib.deepcopy(obj)

    def _index_labels(self, key: Tuple[str, str, str], obj: Any) -> None:
        for lk, lv in obj.metadata.labels.items():
            self._by_label.setdefault((key[0], lk, lv), set()).add(key[1:])

    def _unindex_labels(self, key: Tuple[str, str, str], obj: Any) -> None:
        for lk, lv in obj.metadata.labels.items():
            bucket = self._by_label.get((key[0], lk, lv))
            if bucket is not None:
                bucket.discard(key[1:])

    # -- admission ---------------------------------------------------------

    def register_admission(self, kind: str, fn: Callable[[Any], None]) -> None:
        self._admission.setdefault(kind, []).append(fn)

    def unregister_admission(self, kind: str, fn: Callable[[Any], None]) -> None:
        hooks = self._admission.get(kind)
        if hooks is not None and fn in hooks:
            hooks.remove(fn)

    # -- watch -------------------------------------------------------------

    def unwatch(self, queue: WatchQueue) -> None:
        """Detach a watcher (component shutdown) — without this a dead
        component's queue keeps accumulating cloned events forever."""
        with self._lock:
            if queue in self._watchers:
                self._watchers.remove(queue)

    def watch(self, kinds: Optional[Iterable[str]] = None) -> WatchQueue:
        wq = WatchQueue(kinds)
        with self._lock:
            self._watchers.append(wq)
        return wq

    def _next_rv(self) -> int:
        self._rv_value += 1
        return self._rv_value

    def version(self) -> int:
        """Global write counter — lets the cluster loop detect quiescence."""
        with self._lock:
            return self._rv_value

    def _notify(self, ev_type: str, obj: Any, status_only: bool = False) -> None:
        ev = WatchEvent(ev_type, obj.KIND, obj, status_only=status_only)
        for w in self._watchers:
            w.push(ev)

    # -- CRUD --------------------------------------------------------------

    @staticmethod
    def _key(obj: Any) -> Tuple[str, str, str]:
        ns = getattr(obj.metadata, "namespace", "") or ""
        return (obj.KIND, ns, obj.metadata.name)

    def get_timeline(self, namespace: str, name: str) -> Optional[Dict[str, Any]]:
        """One job's timeline as a wire-shaped dict (None when absent) —
        the same payload GET /timelines/{ns}/{name} serves, and the shape
        observe.export_chrome_trace consumes."""
        tl = self.timelines.timeline(namespace, name)
        return None if tl is None else tl.to_dict()

    def get_timelines(self, limit: int = 256) -> List[Dict[str, Any]]:
        """The newest retained timelines as wire-shaped dicts — the bulk
        feed GET /timelines serves, and what the merged chrome-trace export
        fans in per shard/replica. Capped: the LRU retains max_jobs, and a
        wire response walking all of them at 10k-job scale would be a
        self-inflicted LIST storm."""
        return [tl.to_dict() for tl in self.timelines.timelines()[-limit:]]

    def record_spans(
        self,
        namespace: str,
        name: str,
        spans: List[Dict[str, Any]],
        marks: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        """Bulk span/mark ingest (wire POST /timelines: a remote operator's
        manager pushes its queue-wait/reconcile spans to the host ring)."""
        for sd in spans:
            attrs = dict(sd.get("attrs", {}))
            uid = str(attrs.pop("uid", ""))
            # Client-chosen attr keys ride the `attrs` dict, never the
            # call signature — a span attr named "start" must not shadow
            # the parameter (or 500 the wire boundary).
            self.timelines.record_span(
                namespace, name, uid, str(sd.get("name", "")),
                start=float(sd.get("start", 0.0)),
                end=float(sd.get("end", 0.0)),
                wall=float(sd.get("wall", 0.0)),
                attrs=attrs,
            )
        for md in marks or []:
            self.timelines.mark(
                namespace, name, "", str(md.get("name", "")),
                t=float(md.get("t", 0.0)),
            )

    def create(self, obj: Any) -> Any:
        with self._lock:
            hooks = self._admission.get(obj.KIND, [])
            traced = hooks and _is_job_like(obj) and self.timelines.enabled
            if traced:
                t0 = _time.perf_counter()
            for fn in hooks:
                fn(obj)
            if traced:
                admission_wall = _time.perf_counter() - t0
                metrics.job_admission_seconds.observe(admission_wall)
                now = self.timelines.now()
                self.timelines.record_span(
                    getattr(obj.metadata, "namespace", "") or "",
                    obj.metadata.name,
                    obj.metadata.uid or "",
                    "admission",
                    start=now, end=now, wall=admission_wall, kind=obj.KIND,
                )
            key = self._key(obj)
            if key in self._objects:
                raise AlreadyExistsError(f"{key} already exists")
            obj.metadata.ensure_uid(obj.KIND)
            obj.metadata.resource_version = self._next_rv()
            stored = self._clone(obj)
            self._objects[key] = stored
            self._by_kind.setdefault(key[0], {})[key[1:]] = stored
            self._index_labels(key, stored)
            self._notify("Added", self._clone(stored))
            return obj

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            try:
                return self._clone(self._objects[(kind, namespace or "", name)])
            except KeyError:
                raise NotFoundError(f"{kind} {namespace}/{name} not found") from None

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        with self._lock:
            obj = self._objects.get((kind, namespace or "", name))
            return self._clone(obj) if obj is not None else None

    def resource_version(self, kind: str, namespace: str, name: str) -> Optional[int]:
        """Version probe without the read copy — cache-validation fast path
        (a clone per probe would defeat the caches that key on this)."""
        with self._lock:
            obj = self._objects.get((kind, namespace or "", name))
            return obj.metadata.resource_version if obj is not None else None

    def update(self, obj: Any, check_version: bool = True, status_only: bool = False) -> Any:
        with self._lock:
            key = self._key(obj)
            current = self._objects.get(key)
            if current is None:
                raise NotFoundError(f"{key} not found")
            if check_version and (
                obj.metadata.resource_version != current.metadata.resource_version
            ):
                raise ConflictError(
                    f"{key}: stale resourceVersion {obj.metadata.resource_version} "
                    f"!= {current.metadata.resource_version}"
                )
            obj.metadata.resource_version = self._next_rv()
            stored = self._clone(obj)
            self._unindex_labels(key, current)
            self._objects[key] = stored
            self._by_kind.setdefault(key[0], {})[key[1:]] = stored
            self._index_labels(key, stored)
            self._notify("Modified", self._clone(stored), status_only=status_only)
            return obj

    def delete(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            key = (kind, namespace or "", name)
            obj = self._objects.get(key)
            if obj is None:
                raise NotFoundError(f"{key} not found")
            del self._objects[key]
            self._by_kind.get(kind, {}).pop(key[1:], None)
            self._unindex_labels(key, obj)
            if kind == "Pod":
                self._pod_logs.pop(key[1:], None)
            self._notify("Deleted", obj)  # orphaned: safe to hand out as-is
            return obj

    def try_delete(self, kind: str, namespace: str, name: str) -> Optional[Any]:
        try:
            return self.delete(kind, namespace, name)
        except NotFoundError:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Any]:
        # Clone OUTSIDE the lock: the refs are frozen versions (updates
        # replace, never mutate), and the deep copies are the expensive
        # part — holding the store lock across them would stall every
        # concurrent API request at burst scale.
        return [self._clone(obj) for obj in self.list_refs(kind, namespace, label_selector)]

    def list_refs(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Any]:
        """list() without the copies — STORED references, read-only: updates
        replace stored objects, never mutate them in place, so a returned
        reference is a consistent frozen version forever."""
        with self._lock:
            by_kind = self._by_kind.get(kind, {})
            if label_selector:
                # Intersect via the inverted index: start from the smallest
                # label bucket, verify remaining pairs per object.
                buckets = [
                    self._by_label.get((kind, lk, lv), set())
                    for lk, lv in label_selector.items()
                ]
                candidates = min(buckets, key=len) if buckets else set()
                out = []
                for subkey in candidates:
                    obj = by_kind.get(subkey)
                    if obj is None:
                        continue
                    if namespace is not None and subkey[0] != namespace:
                        continue
                    labels = obj.metadata.labels
                    if all(labels.get(lk) == lv for lk, lv in label_selector.items()):
                        out.append(obj)
                return out
            return [
                obj
                for (ns, _), obj in by_kind.items()
                if namespace is None or ns == namespace
            ]

    # -- pod logs ----------------------------------------------------------

    def append_pod_log(self, namespace: str, name: str, line: str, ts: float = 0.0) -> None:
        """Kubelet-side write of one log line (lifecycle event or a line of
        container stdout) for pod namespace/name."""
        with self._lock:
            buf = self._pod_logs.setdefault(
                (namespace or "", name), {"lines": [], "base": 0}
            )
            for ln in str(line).splitlines() or [""]:
                buf["lines"].append((ts, ln))
            overflow = len(buf["lines"]) - self._pod_log_max
            if overflow > 0:
                del buf["lines"][:overflow]
                buf["base"] += overflow

    def read_pod_log(
        self,
        namespace: str,
        name: str,
        since: int = 0,
        tail: Optional[int] = None,
    ) -> Tuple[List[str], int]:
        """(formatted lines, next cursor). `since` is a cursor from a prior
        call (0 = start of retained log); pass it back to tail a running
        pod. `tail` limits to the last N retained lines."""
        with self._lock:
            buf = self._pod_logs.get((namespace or "", name))
            if buf is None:
                return [], since
            base, lines = buf["base"], buf["lines"]
            idx = max(0, since - base)
            out = lines[idx:]
            if tail is not None and len(out) > tail:
                out = out[-tail:]
            return [f"{ts:.3f} {ln}" for ts, ln in out], base + len(lines)

    # -- events ------------------------------------------------------------

    def _merge_event_locked(self, event: Event) -> None:
        """Append-or-aggregate one event (k8s Events parity): an identical
        repeat (same aggregation_key) becomes a count bump + last-timestamp
        move on a REPLACED record — stored events stay frozen versions (the
        snapshot/compaction path encodes captured references outside the
        lock), so aggregation replaces, never mutates in place."""
        import dataclasses as _dc

        key = event.aggregation_key()
        idx = self._event_index.get(key)
        if idx is not None:
            old = self._events[idx]
            self._events[idx] = _dc.replace(
                old,
                count=old.count + max(1, event.count),
                timestamp=event.timestamp or old.timestamp,
            )
            return
        if not event.first_timestamp:
            event.first_timestamp = event.timestamp
        event.count = max(1, event.count)
        self._event_index[key] = len(self._events)
        self._events_by_name.setdefault(event.object_name, []).append(
            len(self._events))
        self._events.append(event)
        if len(self._events) > self._event_cap:
            drop = len(self._events) - (self._event_cap * 3) // 4
            self._events = self._events[drop:]
            self._event_index = {
                e.aggregation_key(): i for i, e in enumerate(self._events)
            }
            self._events_by_name = {}
            for i, e in enumerate(self._events):
                self._events_by_name.setdefault(e.object_name, []).append(i)
            metrics.events_trimmed.inc(amount=drop)

    def record_event(self, event: Event) -> None:
        with self._lock:
            self._merge_event_locked(event)

    def set_event_cap(self, cap: int) -> None:
        """Override the event-retention bound (>=1)."""
        with self._lock:
            self._event_cap = max(1, int(cap))

    def event_cap(self) -> int:
        return self._event_cap

    def events(
        self, object_name: Optional[str] = None, reason: Optional[str] = None
    ) -> List[Event]:
        with self._lock:
            if object_name is not None:
                pool = [self._events[i]
                        for i in self._events_by_name.get(object_name, ())]
            else:
                pool = self._events
            return [
                e for e in pool
                if reason is None or e.reason == reason
            ]


