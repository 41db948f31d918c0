"""Prometheus-style counter/gauge registry.

Parity target: reference pkg/common/metrics.go:25-61 (jobs created/deleted/
successful/failed/restarted by namespace+framework) plus the pod/service/
podgroup counters in common/pod.go:57-70 and common/job_controller.go:51-58.
Metric names are kept compatible where sensible so dashboards translate.

Implemented standalone (no prometheus_client dependency); `render()` emits
text exposition format for scraping/export.

Counterpart of training_operator_tpu/utils/metrics.py: the metric types and
the registry whole, and the series the operator's scheduling path writes,
with the same names and labels. Locks are plain `threading` locks here.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _label_str(label_names: Tuple[str, ...], labels: Tuple[str, ...]) -> str:
    """THE label rendering — render() and MetricsRegistry.snapshot() must
    agree on it or scrape text and the /metrics JSON silently diverge."""
    return ",".join(f'{n}="{val}"' for n, val in zip(label_names, labels))


class Counter:
    # Prometheus TYPE line — the ONLY thing Gauge.render used to differ in;
    # subclasses override the attribute instead of copying the renderer.
    METRIC_TYPE = "counter"

    def __init__(self, name: str, help_text: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._values: Dict[Tuple[str, ...], float] = defaultdict(float)
        # One order class for every leaf metric: metrics are read from the
        # HTTP scrape thread while written from all others, and the only
        # legal nesting is registry -> metric (never metric -> metric).
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}")
        with self._lock:
            self._values[tuple(label_values)] += amount

    def value(self, *label_values: str) -> float:
        # Locked like items(): a read racing a first-seen-label insert must
        # observe either the pre- or post-insert dict, consistently.
        with self._lock:
            return self._values.get(tuple(label_values), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def items(self) -> List[Tuple[Tuple[str, ...], float]]:
        """Stable copy for iteration: a concurrent inc() inserting a
        first-seen label tuple would otherwise blow up a reader mid-walk
        (render/snapshot run on scrape/network threads)."""
        with self._lock:
            return list(self._values.items())

    def render(self) -> List[str]:
        """Text exposition from the SAME items() view snapshot() reads, so
        the two surfaces cannot disagree (Histogram-style one-view rule)."""
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.METRIC_TYPE}",
        ]
        for labels, v in sorted(self.items()):
            lines.append(f"{self.name}{{{_label_str(self.label_names, labels)}}} {v}")
        return lines


class Gauge(Counter):
    METRIC_TYPE = "gauge"

    def set(self, *label_values: str, value: float = 0.0) -> None:
        with self._lock:
            self._values[tuple(label_values)] = value


# controller-runtime's reconcile_time_seconds convention, stretched to the
# minutes-long tail a queued gang can legitimately spend waiting.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)


class Histogram:
    """Cumulative-bucket observation metric (Prometheus histogram shape:
    `le`-labeled buckets + sum/count), extended with tracked min/max so the
    envelope survives without a quantile sketch."""

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        # Per-bucket (non-cumulative) counts; index len(buckets) = +Inf.
        self._bucket_counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            self._bucket_counts[bisect.bisect_left(self.buckets, value)] += 1

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @staticmethod
    def _le(bound: float) -> str:
        return "+Inf" if bound == math.inf else repr(bound)

    @staticmethod
    def _cumulate(buckets: Tuple[float, ...], counts: List[int]) -> List[Tuple[float, int]]:
        out = []
        running = 0
        for bound, c in zip(buckets, counts):
            running += c
            out.append((bound, running))
        out.append((math.inf, running + counts[-1]))
        return out

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, ending at (+Inf, count) —
        THE bucket view both render() and snapshot_items() derive from, so
        the text and JSON expositions cannot disagree."""
        with self._lock:
            counts = list(self._bucket_counts)
        return self._cumulate(self.buckets, counts)

    def snapshot_items(self) -> Dict[str, float]:
        """Flat JSON form — same numbers render() prints. One lock
        acquisition captures buckets AND envelope together, so the +Inf
        bucket always equals _count even under concurrent observes."""
        with self._lock:
            counts = list(self._bucket_counts)
            count, total = self.count, self.sum
            lo = self.min if count else 0.0
            hi = self.max if count else 0.0
        out: Dict[str, float] = {}
        for bound, cum in self._cumulate(self.buckets, counts):
            out[f'{self.name}_bucket{{le="{self._le(bound)}"}}'] = float(cum)
        out[f"{self.name}_count"] = float(count)
        out[f"{self.name}_sum"] = total
        out[f"{self.name}_min"] = lo
        out[f"{self.name}_max"] = hi
        return out

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        for key, v in self.snapshot_items().items():
            lines.append(f"{key} {v}")
        return lines


class LabeledHistogram:
    """Histogram family with label dimensions (controller-runtime's
    `controller_runtime_reconcile_time_seconds{controller=...}` shape): one
    child Histogram per label tuple, sharing a name/help/bucket layout.

    Exposition derives from each child's `snapshot_items()` — the one-view
    rule — with the family labels spliced into every sample's label set, so
    text and JSON stay in lockstep exactly as for the unlabeled Histogram.
    """

    METRIC_TYPE = "histogram"

    def __init__(self, name: str, help_text: str, label_names: Tuple[str, ...],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self._children: Dict[Tuple[str, ...], Histogram] = {}
        # Family lock is its OWN order class: labels() releases it before
        # the caller touches the child (`return` exits the with block), so
        # family -> metric never nests; keeping the classes distinct means
        # the witness would see it immediately if that ever changed.
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def labels(self, *label_values: str) -> Histogram:
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}")
        key = tuple(label_values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Histogram(
                    self.name, self.help, self.buckets
                )
            return child

    def observe(self, value: float, *label_values: str) -> None:
        self.labels(*label_values).observe(value)

    def _child_items(self) -> List[Tuple[Tuple[str, ...], Histogram]]:
        with self._lock:
            return sorted(self._children.items())

    @staticmethod
    def _splice(key: str, label_str: str) -> str:
        """Insert the family labels into one child sample key:
        `name_bucket{le="x"}` -> `name_bucket{kind="j",le="x"}` and the
        brace-less `name_count` -> `name_count{kind="j"}`."""
        brace = key.find("{")
        if brace < 0:
            return f"{key}{{{label_str}}}"
        return f"{key[:brace]}{{{label_str},{key[brace + 1:]}"

    def snapshot_items(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for labels, child in self._child_items():
            label_str = _label_str(self.label_names, labels)
            for key, v in child.snapshot_items().items():
                out[self._splice(key, label_str)] = v
        return out

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.METRIC_TYPE}",
        ]
        for key, v in self.snapshot_items().items():
            lines.append(f"{key} {v}")
        return lines


class SlidingWindowHistogram:
    """Histogram over a bounded ring of per-window bucket snapshots.

    The plain Histogram accumulates forever — fine for lifetime p50/p99,
    useless for burn-rate math, which asks "what fraction of the LAST five
    minutes breached the threshold". This variant partitions observations
    into fixed-width, clock-aligned windows (index = floor(now / width)),
    retains the most recent `num_windows` of them, and merges any suffix of
    the ring on demand via `cumulative_buckets(window_seconds, now)` — the
    same one-view rule as Histogram: render() and snapshot_items() both
    derive from the full-retention merge, so text and JSON exposition
    cannot disagree.

    Time is always the caller's (the cluster's virtual clock) — the metric
    itself never reads a wall clock, so soak/bench time compression works
    unchanged. Observations with a stale `now` fold into the newest
    retained window rather than resurrecting an evicted one.
    """

    METRIC_TYPE = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window_seconds: float = 60.0, num_windows: int = 240):
        self.name = name
        self.help = help_text
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.window_seconds = float(window_seconds)
        self.num_windows = max(1, int(num_windows))
        # window index -> [per-bucket counts (+Inf last), count, sum, min, max]
        self._windows: Dict[int, list] = {}
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def _idx(self, now: float) -> int:
        return int(now // self.window_seconds)

    def _evict(self, idx: int) -> None:
        """Drop windows older than the retention ring. Caller holds lock."""
        floor_idx = idx - self.num_windows + 1
        for k in [k for k in self._windows if k < floor_idx]:
            del self._windows[k]

    def observe(self, value: float, now: float = 0.0) -> None:
        idx = self._idx(now)
        with self._lock:
            if self._windows:
                newest = max(self._windows)
                if idx < newest:
                    # Out-of-order observation: fold into the newest window
                    # instead of resurrecting (or re-creating) an older one.
                    idx = newest
            win = self._windows.get(idx)
            if win is None:
                win = self._windows[idx] = [
                    [0] * (len(self.buckets) + 1), 0, 0.0, math.inf, -math.inf,
                ]
                self._evict(idx)
            win[0][bisect.bisect_left(self.buckets, value)] += 1
            win[1] += 1
            win[2] += value
            if value < win[3]:
                win[3] = value
            if value > win[4]:
                win[4] = value

    def advance(self, now: float) -> None:
        """Rotate the ring forward without observing — lets a periodic
        evaluator expire idle windows so a quiet queue's old breaches age
        out on schedule rather than on the next observation."""
        with self._lock:
            self._evict(self._idx(now))

    def _merged(self, min_idx=None):
        """Merge retained windows (>= min_idx when given) into one
        (counts, count, sum, min, max) tuple. Caller holds lock."""
        counts = [0] * (len(self.buckets) + 1)
        count, total = 0, 0.0
        lo, hi = math.inf, -math.inf
        for k, win in self._windows.items():
            if min_idx is not None and k < min_idx:
                continue
            for i, c in enumerate(win[0]):
                counts[i] += c
            count += win[1]
            total += win[2]
            if win[3] < lo:
                lo = win[3]
            if win[4] > hi:
                hi = win[4]
        return counts, count, total, lo, hi

    def cumulative_buckets(self, window_seconds=None, now=None) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs over the trailing
        `window_seconds` ending at `now` (both required together), else
        over the full retention — THE bucket view burn-rate evaluation,
        render(), and snapshot_items() all derive from."""
        min_idx = None
        if window_seconds is not None and now is not None:
            span = max(1, int(math.ceil(window_seconds / self.window_seconds)))
            min_idx = self._idx(now) - span + 1
        with self._lock:
            counts, _, _, _, _ = self._merged(min_idx)
        return Histogram._cumulate(self.buckets, counts)

    def snapshot_items(self) -> Dict[str, float]:
        with self._lock:
            counts, count, total, lo, hi = self._merged()
        out: Dict[str, float] = {}
        for bound, cum in Histogram._cumulate(self.buckets, counts):
            out[f'{self.name}_bucket{{le="{Histogram._le(bound)}"}}'] = float(cum)
        out[f"{self.name}_count"] = float(count)
        out[f"{self.name}_sum"] = total
        out[f"{self.name}_min"] = lo if count else 0.0
        out[f"{self.name}_max"] = hi if count else 0.0
        return out

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.METRIC_TYPE}",
        ]
        for key, v in self.snapshot_items().items():
            lines.append(f"{key} {v}")
        return lines


class LabeledSlidingWindowHistogram:
    """SlidingWindowHistogram family with label dimensions — the windowed
    analogue of LabeledHistogram, sharing its splice/one-view exposition
    discipline. `children()` hands the evaluator the live (labels, child)
    pairs so per-policy selectors can merge matching children's windows."""

    METRIC_TYPE = "histogram"

    def __init__(self, name: str, help_text: str, label_names: Tuple[str, ...],
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window_seconds: float = 60.0, num_windows: int = 240):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.window_seconds = float(window_seconds)
        self.num_windows = max(1, int(num_windows))
        self._children: Dict[Tuple[str, ...], SlidingWindowHistogram] = {}
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def labels(self, *label_values: str) -> SlidingWindowHistogram:
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}")
        key = tuple(label_values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = SlidingWindowHistogram(
                    self.name, self.help, self.buckets,
                    window_seconds=self.window_seconds,
                    num_windows=self.num_windows,
                )
            return child

    def observe(self, value: float, *label_values: str, now: float = 0.0) -> None:
        self.labels(*label_values).observe(value, now=now)

    def children(self) -> List[Tuple[Tuple[str, ...], SlidingWindowHistogram]]:
        with self._lock:
            return sorted(self._children.items())

    def snapshot_items(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for labels, child in self.children():
            label_str = _label_str(self.label_names, labels)
            for key, v in child.snapshot_items().items():
                out[LabeledHistogram._splice(key, label_str)] = v
        return out

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.METRIC_TYPE}",
        ]
        for key, v in self.snapshot_items().items():
            lines.append(f"{key} {v}")
        return lines


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: Dict[str, Counter] = {}
        # Guards the family dict itself (registration vs the scrape-thread
        # walk). snapshot()/render() COPY the family list under this lock
        # and only then take each metric's own lock — registry -> metric
        # never nests, which keeps the order graph acyclic by construction.
        # lockcheck: allow CL008 — leaf lock; the port keeps plain threading locks until utils/locks.py is ported
        self._lock = threading.Lock()

    def _families(self) -> List[Counter]:
        with self._lock:
            return list(self._metrics.values())

    def _existing(self, name: str, cls, labels=None, buckets=None):
        """Re-registration guard: the same name must come back as the SAME
        metric — a second registration with a different type, label tuple,
        or bucket layout silently splitting/aliasing a family is exactly
        the drift the registry exists to prevent."""
        m = self._metrics.get(name)
        if m is None:
            return None
        if type(m) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"not {cls.__name__}"
            )
        if labels is not None and m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{m.label_names}, not {tuple(labels)}"
            )
        if buckets is not None and m.buckets != tuple(sorted(buckets)):
            raise ValueError(
                f"metric {name!r} already registered with buckets "
                f"{m.buckets}, not {tuple(sorted(buckets))}"
            )
        return m

    def counter(self, name: str, help_text: str = "", labels: Tuple[str, ...] = ()) -> Counter:
        with self._lock:
            existing = self._existing(name, Counter, labels=labels)
            if existing is None:
                existing = self._metrics[name] = Counter(name, help_text, tuple(labels))
            return existing

    def gauge(self, name: str, help_text: str = "", labels: Tuple[str, ...] = ()) -> Gauge:
        with self._lock:
            existing = self._existing(name, Gauge, labels=labels)
            if existing is None:
                existing = self._metrics[name] = Gauge(name, help_text, tuple(labels))
            return existing

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  labels: Tuple[str, ...] = ()) -> Histogram:
        with self._lock:
            if labels:
                existing = self._existing(
                    name, LabeledHistogram, labels=labels, buckets=buckets
                )
                if existing is None:
                    existing = self._metrics[name] = LabeledHistogram(
                        name, help_text, tuple(labels), buckets
                    )
                return existing
            existing = self._existing(name, Histogram, buckets=buckets)
            if existing is None:
                existing = self._metrics[name] = Histogram(name, help_text, buckets)
            return existing

    def sliding_histogram(self, name: str, help_text: str = "",
                          buckets: Sequence[float] = DEFAULT_BUCKETS,
                          labels: Tuple[str, ...] = (),
                          window_seconds: float = 60.0,
                          num_windows: int = 240):
        with self._lock:
            cls = LabeledSlidingWindowHistogram if labels else SlidingWindowHistogram
            existing = self._existing(
                name, cls, labels=tuple(labels) if labels else None,
                buckets=buckets,
            )
            if existing is not None:
                if (existing.window_seconds != float(window_seconds)
                        or existing.num_windows != int(num_windows)):
                    raise ValueError(
                        f"metric {name!r} already registered with window "
                        f"{existing.window_seconds}s x {existing.num_windows}, "
                        f"not {float(window_seconds)}s x {int(num_windows)}"
                    )
                return existing
            if labels:
                existing = self._metrics[name] = LabeledSlidingWindowHistogram(
                    name, help_text, tuple(labels), buckets,
                    window_seconds=window_seconds, num_windows=num_windows,
                )
            else:
                existing = self._metrics[name] = SlidingWindowHistogram(
                    name, help_text, buckets,
                    window_seconds=window_seconds, num_windows=num_windows,
                )
            return existing

    def render(self) -> str:
        out: List[str] = []
        for m in self._families():
            out.extend(m.render())
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, float]:
        """Flat {name or name{labels}: value} view of every metric — the
        JSON analogue of render(), for the wire API's GET /metrics (a remote
        bench/test can assert counter deltas without text parsing)."""
        out: Dict[str, float] = {}
        for m in self._families():
            if isinstance(m, (Histogram, LabeledHistogram,
                              SlidingWindowHistogram,
                              LabeledSlidingWindowHistogram)):
                out.update(m.snapshot_items())
                continue
            for labels, v in m.items():
                if labels:
                    out[f"{m.name}{{{_label_str(m.label_names, labels)}}}"] = v
                else:
                    out[m.name] = v
        return out


# Global registry + the reference's counter families.
registry = MetricsRegistry()
jobs_created = registry.counter(
    "training_operator_jobs_created_total",
    "Counts number of jobs created",
    ("job_namespace", "framework"),
)
jobs_deleted = registry.counter(
    "training_operator_jobs_deleted_total",
    "Counts number of jobs deleted",
    ("job_namespace", "framework"),
)
jobs_successful = registry.counter(
    "training_operator_jobs_successful_total",
    "Counts number of jobs successful",
    ("job_namespace", "framework"),
)
jobs_failed = registry.counter(
    "training_operator_jobs_failed_total",
    "Counts number of jobs failed",
    ("job_namespace", "framework", "reason"),
)
jobs_restarted = registry.counter(
    "training_operator_jobs_restarted_total",
    "Counts number of jobs restarted",
    ("job_namespace", "framework"),
)
created_pods = registry.counter(
    "training_operator_created_pods_total", "The number of created pods", ()
)
deleted_pods = registry.counter(
    "training_operator_deleted_pods_total", "The number of deleted pods", ()
)
restarted_pods = registry.counter(
    "training_operator_restarted_pods_total", "The number of restarted pods", ()
)
created_services = registry.counter(
    "training_operator_created_services_total", "The number of created services", ()
)
deleted_services = registry.counter(
    "training_operator_deleted_services_total", "The number of deleted services", ()
)
created_podgroups = registry.counter(
    "training_operator_created_podgroups_total", "The number of created podgroups", ()
)
deleted_podgroups = registry.counter(
    "training_operator_deleted_podgroups_total", "The number of deleted podgroups", ()
)
podgroups_admitted = registry.counter(
    "training_operator_podgroups_admitted_total",
    "The number of podgroups admitted by the gang scheduler", (),
)
pods_bound = registry.counter(
    "training_operator_pods_bound_total",
    "The number of pods bound by the gang scheduler", (),
)
scheduler_solve_seconds = registry.histogram(
    "training_operator_scheduler_solve_seconds",
    "Wall time of gang-scheduler placement solves",
)
# controller-runtime parity: per-reconcile latency + outcome and live
# workqueue depth (controller_runtime_reconcile_time_seconds /
# controller_runtime_reconcile_total / workqueue_depth).
reconcile_seconds = registry.histogram(
    "training_operator_reconcile_seconds",
    "Wall time of one reconcile pass (all kinds)",
)
reconcile_total = registry.counter(
    "training_operator_reconcile_total",
    "Reconcile passes by kind and result",
    ("kind", "result"),  # result: success | error
)
workqueue_depth = registry.gauge(
    "training_operator_workqueue_depth",
    "Keys pending in the manager workqueue after the current tick",
    (),
)
# Job-lifecycle tracing (observe/timeline.py): queue wait and admission use
# sub-second-heavy buckets (they are control-plane costs); time-to-running
# keeps the default long tail (it includes gang queueing and container start).
_FAST_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
job_queue_wait_seconds = registry.histogram(
    "training_job_queue_wait_seconds",
    "Wall time a job key spent in the manager workqueue (enqueue -> pop)",
    buckets=_FAST_BUCKETS,
)
job_admission_seconds = registry.histogram(
    "training_job_admission_seconds",
    "Wall time of admission hooks (defaulting + validation + speclint) per job create",
    buckets=_FAST_BUCKETS,
)
job_time_to_running_seconds = registry.histogram(
    "training_job_time_to_running_seconds",
    "Cluster-clock time from job creation to the Running condition",
)
node_evictions = registry.counter(
    "training_node_evictions_total",
    "Pods evicted (failed) off dead, drained, or vanished nodes",
    ("node",),
)
# Controller-runtime metric parity: per-KIND reconcile latency
# (controller_runtime_reconcile_time_seconds{controller=...}) and the
# workqueue add/retry families next to the existing depth gauge — the
# aggregate training_operator_reconcile_seconds histogram predates this and
# stays as the all-kinds view.
reconcile_duration = registry.histogram(
    "training_reconcile_duration_seconds",
    "Wall time of one reconcile pass, by job kind",
    labels=("kind",),
)
workqueue_adds = registry.counter(
    "training_workqueue_adds_total",
    "Keys enqueued into the manager workqueue (dedup'd adds not counted)", (),
)
workqueue_retries = registry.counter(
    "training_workqueue_retries_total",
    "Failed reconciles re-enqueued with backoff, by job kind",
    ("kind",),
)
# Incremental gang solver (scheduler/gang.py + scheduler/snapshot.py
# SnapshotMaintainer): the O(changed) solve-cycle plane. cycles_total counts
# every solver invocation; incremental_cycles_total the subset that solved
# only dirty groups (the ratio is the warm-start hit rate);
# groups_resolved_total the gangs actually handed to the placer (vs
# pending x cycles under the legacy full re-solve); snapshot_rebuilds_total
# the full walks the incremental snapshot performed (initial prime +
# selfcheck-mismatch adoptions — steady state is the prime alone). The
# solver wall histogram is training_operator_scheduler_solve_seconds above.
solver_cycles = registry.counter(
    "training_solver_cycles_total",
    "Gang solve cycles executed (any mode)", (),
)
solver_incremental_cycles = registry.counter(
    "training_solver_incremental_cycles_total",
    "Gang solve cycles that re-solved only the dirty-group subset", (),
)
solver_groups_resolved = registry.counter(
    "training_solver_groups_resolved_total",
    "GangRequests handed to the placer across all solve cycles", (),
)
solver_snapshot_rebuilds = registry.counter(
    "training_solver_snapshot_rebuilds_total",
    "Full from-scratch rebuilds of the incremental cluster snapshot "
    "(initial prime + selfcheck-mismatch adoptions)", (),
)
# Event retention (cluster/apiserver.py): the store's Event list is bounded
# (the k8s events-TTL analogue); oldest records dropped past the cap.
events_trimmed = registry.counter(
    "training_events_trimmed_total",
    "Event records dropped by the store's retention cap", (),
)
# SLO engine (observe/slo.py): the windowed observation feeds the burn-rate
# evaluator slices, plus the attainment/budget/burn gauges it republishes.
# The windowed families duplicate the lifetime histograms above on purpose:
# burn-rate math needs "the last N minutes", the lifetime families keep the
# run-wide envelope — merging them would force one view to lie. Retention is
# 240 x 60s = 4h of cluster-clock history, enough for a 1h slow window with
# room for soak's compressed days.
slo_time_to_running_window = registry.sliding_histogram(
    "training_slo_time_to_running_window_seconds",
    "Cluster-clock time from job creation to the Running condition, "
    "windowed for SLO burn-rate evaluation, by queue and kind",
    labels=("queue", "kind"),
)
slo_queue_wait_window = registry.sliding_histogram(
    "training_slo_queue_wait_window_seconds",
    "Manager workqueue wait (enqueue -> pop), windowed for SLO burn-rate "
    "evaluation, by queue and kind",
    buckets=_FAST_BUCKETS,
    labels=("queue", "kind"),
)
