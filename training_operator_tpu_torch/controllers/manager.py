"""OperatorManager: the controller-runtime equivalent.

Wires watch streams -> expectations observation -> rate-limited workqueue ->
per-kind reconcilers, as a cluster ticker. Parity target: the manager setup in
cmd/training-operator.v1/main.go:134-223 plus the watch predicates in
pkg/common/util/reconciler.go:67 (OnDependentFuncs: pod/service events observe
expectations and enqueue the owning job).

Counterpart of training_operator_tpu/controllers/manager.py for one operator
replica: leader election and reconcile shards (controllers/leader.py) come
with the wire and HA, and v2 TrainJobs with runtime v2, both still to be
ported.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Dict, Optional, Tuple

from training_operator_tpu_torch import observe

from training_operator_tpu_torch.api.common import (
    JOB_KIND_LABEL,
    JOB_NAME_LABEL,
    REPLICA_TYPE_LABEL,
)
from training_operator_tpu_torch.api.defaults import default_job
from training_operator_tpu_torch.api.jobs import Job
from training_operator_tpu_torch.api.validation import validate_job
from training_operator_tpu_torch.cluster.runtime import Cluster
from training_operator_tpu_torch.engine.controller import JobController
from training_operator_tpu_torch.engine.expectations import gen_expectation_key
from training_operator_tpu_torch.engine.workqueue import RateLimitingQueue
from training_operator_tpu_torch.utils import metrics

log = logging.getLogger(__name__)


class OperatorManager:
    """Runs all registered job-kind controllers against one cluster."""

    def __init__(
        self,
        cluster: Cluster,
        gang_enabled: bool = False,
        reconciles_per_tick: int = 256,
        namespace: Optional[str] = None,
        resync_period: Optional[float] = 300.0,
        gang_requeue_seconds: float = 30.0,
    ):
        self.cluster = cluster
        self.api = cluster.api
        self.gang_enabled = gang_enabled
        self.gang_requeue_seconds = gang_requeue_seconds
        self.reconciles_per_tick = reconciles_per_tick
        # Namespace scope (reference --namespace / cache.Options.Namespaces):
        # events outside the scope are ignored entirely.
        self.namespace = namespace or None
        # Periodic full resync (controller-runtime's SyncPeriod): every job
        # re-enqueued on a timer, so a DROPPED watch event (flaky informer
        # connection) delays convergence instead of wedging it. None
        # disables (tests that count reconciles exactly).
        self.resync_period = resync_period
        # None => the first tick performs the informer INITIAL LIST: without
        # it, a manager attached to a store with pre-existing jobs would
        # ignore them for a full resync_period.
        self._last_resync: Optional[float] = None
        self.queue = RateLimitingQueue()
        self.controllers: Dict[str, Tuple[object, JobController]] = {}
        self._watch = self.api.watch()
        cluster.add_ticker(self.tick)

    # ------------------------------------------------------------------

    def stop(self) -> None:
        """Detach this manager from the cluster — the process-death half of
        the restart story (reference: losing leader election / SIGTERM). A
        replacement manager built on the same APIServer re-lists state,
        rebuilds expectations from scratch, and adopts existing pods via
        the claim path; convergence is asserted by the restart test.

        Everything this manager registered is torn down: its ticker, its
        watch queue (or every later event accumulates in a dead deque), and
        its admission hooks (or each dead generation re-validates every
        submit)."""
        self.cluster.remove_ticker(self.tick)
        self.api.unwatch(self._watch)
        for kind in self.controllers:
            self.api.unregister_admission(kind, validate_job)

    def register(self, controller) -> None:
        kind = controller.kind
        jc = JobController(
            self.api,
            controller,
            now_fn=self.cluster.clock.now,
            gang_enabled=self.gang_enabled,
            gang_requeue_seconds=self.gang_requeue_seconds,
            # The engine passes bare "ns/name"; prefix the kind so requeues
            # land in the same key space as event enqueues.
            requeue_after=lambda job_key, delay: self._requeue_after(
                f"{kind}|{job_key}", delay
            ),
            delete_job=self._delete_job,
        )
        self.controllers[controller.kind] = (controller, jc)
        self.api.register_admission(controller.kind, validate_job)

    def submit(self, job: Job) -> Job:
        """Client entry: default + validate + create (the admission path)."""
        default_job(job, now=self.cluster.clock.now())
        return self.api.create(job)

    # ------------------------------------------------------------------

    @staticmethod
    def _key(kind: str, namespace: str, name: str) -> str:
        return f"{kind}|{namespace}/{name}"

    def _requeue_after(self, key: str, delay: float) -> None:
        self.cluster.schedule_after(delay, lambda: self.queue.add(key))

    def _delete_job(self, job: Job) -> None:
        """TTL garbage collection (reference CleanupJob)."""
        self.api.try_delete(job.kind, job.namespace, job.name)

    # Kinds swept when their owning job is deleted — the substrate has no
    # ownerReference cascade GC like Kubernetes, so the manager provides it.
    OWNED_KINDS = ("Pod", "Service", "PodGroup", "ConfigMap", "HorizontalPodAutoscaler")

    def _cascade_delete(self, job: Job) -> None:
        # list_refs where available: this walk only READS owner_uid/name off
        # the stored references — clone-on-read here cost more than the
        # deletes under sustained job churn (every TTL GC paid five
        # full-kind deep copies). Best-effort per item: a wire fault here
        # must not abort the remaining deletes (or the rest of this tick's
        # drained events); whatever is missed, the resync orphan sweep
        # retries.
        list_fn = getattr(self.api, "list_refs", None) or self.api.list
        for kind in self.OWNED_KINDS:
            try:
                objs = list_fn(kind, job.namespace)
            except Exception:  # noqa: BLE001 — the orphan sweep retries
                continue
            for obj in objs:
                if obj.metadata.owner_uid == job.uid:
                    try:
                        self.api.try_delete(
                            kind, obj.metadata.namespace, obj.metadata.name)
                    except Exception:  # noqa: BLE001
                        pass

    # ------------------------------------------------------------------

    def _list_light(self, kind: str):
        """Clone-free list when the API offers it (in-process list_refs);
        the remote client's list() already hands over fresh decoded objects
        nobody else aliases. These walks only READ metadata."""
        fn = getattr(self.api, "list_refs", None)
        if fn is None:
            fn = self.api.list
        return fn(kind, self.namespace)

    def _resync_all(self) -> None:
        """Enqueue every in-scope job of every registered kind (the informer
        initial-list a newly elected leader needs). The resync is also the
        self-healing pass for bookkeeping that one-shot event handling can
        leak under sustained faults (both surfaced by the soak harness):
        expired expectations whose echoes were lost with a dropped watch
        batch, and owned objects whose cascade delete failed in flight."""
        for kind in self.controllers:
            try:
                jobs = self._list_light(kind)
            except Exception:  # noqa: BLE001 — transport fault; next resync
                log.debug("resync list of %s failed; retried next period", kind)
                continue
            for job in jobs:
                self.queue.add(self._key(
                    kind, job.metadata.namespace, job.metadata.name))
        for _, jc in self.controllers.values():
            jc.expectations.forget_expired()
        self._sweep_orphans()

    def _sweep_orphans(self) -> None:
        """Cascade-GC retry (the k8s garbage collector's periodic role):
        `_cascade_delete` runs once, on the owner's Deleted event — a wire
        fault mid-cascade would otherwise strand the remaining owned
        objects forever (an INV001 violation no later event can heal).
        Sweep anything whose recorded owner uid no longer resolves to a
        live job of any kind this control plane knows about.

        Best-effort PER ITEM with bounded per-call retries, like the k8s
        garbage collector behind client-go: one transient wire fault must
        skip at most one attempt, not abort the whole pass — the soak
        showed a wholesale abort leaves orphans standing for several resync
        periods under sustained transport chaos (an INV001 violation the
        machinery was supposed to heal), and unretried calls still missed
        often enough to trip the auditor's grace."""

        def attempt(fn, *args):
            last = None
            for _ in range(3):
                try:
                    return fn(*args)
                except Exception as e:  # noqa: BLE001 — transport fault
                    last = e
            raise last

        # Candidates FIRST, live-owner set SECOND — the order is the
        # correctness argument: an owner always exists before anything it
        # owns is created, and owner uids are never reused (uid floor), so
        # an owner uid absent from a live set captured AFTER its owned
        # object was listed is PERMANENTLY dead. The reverse order would
        # race a concurrent writer (live set at T0, owner+owned both
        # created at T1, owned walk at T2 reads the new object against the
        # stale set and deletes a healthy one).
        candidates = []
        for kind in self.OWNED_KINDS + tuple(self.controllers):
            try:
                objs = attempt(self._list_light, kind)
            except Exception:  # noqa: BLE001
                continue
            for obj in objs:
                if obj.metadata.owner_uid:
                    candidates.append((
                        kind, obj.metadata.namespace, obj.metadata.name,
                        obj.metadata.owner_uid,
                    ))
        if not candidates:
            return
        live = set()
        try:
            for kind in self.controllers:
                for job in attempt(self._list_light, kind):
                    live.add(job.metadata.uid)
        except Exception:  # noqa: BLE001 — transport fault mid-walk
            # An INCOMPLETE live set must abort the sweep: missing uids
            # would read as dead owners and delete healthy pods.
            log.debug("orphan sweep skipped: live-owner walk failed")
            return
        for kind, namespace, name, uid in candidates:
            if uid not in live:
                try:
                    attempt(self.api.try_delete, kind, namespace, name)
                except Exception:  # noqa: BLE001 — next sweep retries
                    pass

    def tick(self) -> None:
        if self.resync_period is not None and (
            self._last_resync is None
            or self.cluster.clock.now() - self._last_resync >= self.resync_period
        ):
            self._last_resync = self.cluster.clock.now()
            self._resync_all()
        for ev in self._watch.drain():
            self._handle_event(ev)
        for key in self.queue.drain(limit=self.reconciles_per_tick):
            self._process(key)
        metrics.workqueue_depth.set(value=float(len(self.queue)))

    def _handle_event(self, ev) -> None:
        kind = ev.kind
        obj = ev.obj
        if (
            self.namespace is not None
            and getattr(obj.metadata, "namespace", None) not in (None, "", self.namespace)
        ):
            return  # out of scope
        if kind in self.controllers:
            if ev.status_only:
                return  # our own status write echoing back; no work to do
            key = self._key(kind, obj.namespace, obj.name)
            if ev.type == "Deleted":
                metrics.jobs_deleted.inc(obj.namespace, kind)
                _, jc = self.controllers[kind]
                for rtype in obj.replica_specs:
                    jc.expectations.delete_expectations(
                        gen_expectation_key(obj.key(), rtype, "pods")
                    )
                    jc.expectations.delete_expectations(
                        gen_expectation_key(obj.key(), rtype, "services")
                    )
                self._cascade_delete(obj)
            else:
                self.queue.add(key)
        elif kind in ("Pod", "Service"):
            labels = obj.metadata.labels
            job_kind = labels.get(JOB_KIND_LABEL)
            job_name = labels.get(JOB_NAME_LABEL)
            if not job_kind or not job_name or job_kind not in self.controllers:
                return
            job_key = f"{obj.namespace}/{job_name}"
            rtype = labels.get(REPLICA_TYPE_LABEL, "")
            _, jc = self.controllers[job_kind]
            exp_key = gen_expectation_key(job_key, rtype, "pods" if kind == "Pod" else "services")
            if ev.type == "Added":
                jc.expectations.creation_observed(exp_key)
            elif ev.type == "Deleted":
                jc.expectations.deletion_observed(exp_key)
            self.queue.add(self._key(job_kind, obj.namespace, job_name))
        elif kind == "PodGroup":
            job_kind = obj.metadata.labels.get("job-kind")
            if job_kind in self.controllers:
                self.queue.add(self._key(job_kind, obj.namespace, obj.name))

    def _process(self, key: str) -> None:
        kind, nsname = key.split("|", 1)
        ns, name = nsname.split("/", 1)
        entry = self.controllers.get(kind)
        if entry is None:
            return
        _, jc = entry
        # Queue wait is attributed BEFORE the reconcile so a slow pass does
        # not inflate it; the timeline span sits at the pop instant with the
        # wall wait carried in `wall` (workqueue stamps are wall-monotonic).
        wait = self.queue.waited(key)
        metrics.job_queue_wait_seconds.observe(wait)
        # Windowed twin for the SLO burn-rate evaluator. Queue label is ""
        # (the workqueue predates tenancy resolution); per-kind objectives
        # still slice, and "*" objectives score the union.
        metrics.slo_queue_wait_window.observe(
            wait, "", kind, now=self.cluster.clock.now(),
        )
        tracing = observe.enabled()
        now = self.cluster.clock.now() if tracing else 0.0
        if tracing:
            self.api.timelines.record_span(
                ns, name, "", "queue_wait",
                start=now, end=now, wall=wait, kind=kind,
            )
        t0 = _time.perf_counter()
        result = "error"
        try:
            jc.reconcile(ns, name)
        except Exception:
            log.exception("reconcile failed for %s", key)
            metrics.reconcile_total.inc(kind, "error")
            # controller-runtime workqueue_retries_total parity: a failed
            # reconcile re-enqueued with backoff is one retry.
            metrics.workqueue_retries.inc(kind)
            delay = self.queue.failure_delay(key)
            self.cluster.schedule_after(delay, lambda: self.queue.add(key))
        else:
            metrics.reconcile_total.inc(kind, "success")
            self.queue.forget(key)
            result = "success"
        finally:
            wall = _time.perf_counter() - t0
            metrics.reconcile_seconds.observe(wall)
            # Per-kind latency (controller_runtime_reconcile_time_seconds
            # {controller=...}); the unlabeled histogram above stays as the
            # all-kinds aggregate.
            metrics.reconcile_duration.observe(wall, kind)
            if tracing:
                self.api.timelines.record_span(
                    ns, name, "", "reconcile",
                    start=now, end=self.cluster.clock.now(), wall=wall,
                    kind=kind, result=result,
                )
