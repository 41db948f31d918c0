"""Elasticity: the HPA controller and incremental gang re-pack.

Parity target: the reference delegates scaling to the Kubernetes HPA
controller (it only creates/deletes the HPA object, pytorch/hpa.go:33-80) and
torchrun handles membership changes in-process. Here both halves are
first-class:

- `HorizontalAutoscaler` — the HPA control loop: reads a metric source,
  applies the k8s HPA formula (desired = ceil(current * actual/target),
  clamped to [min,max], stabilized by a cooldown), and resizes the target
  job's Worker replica count. The engine then creates/deletes pods
  (scale-in removes the highest indices, matching torchrun's contract).

- Incremental re-pack (BASELINE.md config 4): when an admitted gang grows,
  `repack_grown_gangs` places ONLY the missing pods against the current
  snapshot — existing members keep their nodes (no full re-schedule, no
  job restart); placement entries of removed members are pruned so their
  reservations release.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from training_operator_tpu_torch.api.jobs import REPLICA_WORKER
from training_operator_tpu_torch.cluster.apiserver import ConflictError, NotFoundError
from training_operator_tpu_torch.cluster.objects import PodGroupPhase
from training_operator_tpu_torch.cluster.runtime import Cluster
from training_operator_tpu_torch.scheduler.snapshot import (
    ClusterSnapshot,
    GangRequest,
    build_gang_request,
    resolve_owner_job,
)


class MetricsSource(Protocol):
    def get(self, namespace: str, target: str, metric: str) -> Optional[float]: ...


class StaticMetricsSource:
    """Settable metric values (tests/sim drive utilization signals)."""

    def __init__(self) -> None:
        self._values: Dict[tuple, float] = {}

    def set(self, namespace: str, target: str, metric: str, value: float) -> None:
        self._values[(namespace, target, metric)] = value

    def get(self, namespace: str, target: str, metric: str) -> Optional[float]:
        return self._values.get((namespace, target, metric))


# Pods publish custom metrics via annotations; the live source averages them
# over the target job's running pods:
#   metrics.tpu.dev/<metric>            — a static current value, or
#   sim.tpu.dev/load-profile-<metric>   — JSON [[t, v], ...] relative to pod
#                                         start, step-interpolated at read
#                                         time (the signal evolves with the
#                                         clock — nothing pokes the source).
ANNOTATION_METRIC_PREFIX = "metrics.tpu.dev/"
ANNOTATION_LOAD_PROFILE_PREFIX = "sim.tpu.dev/load-profile-"


class ClusterMetricsSource:
    """Live custom-metrics feed (the role the reference delegates to a
    metrics adapter between training pods and the HPA controller,
    pytorch/hpa.go consuming autoscaling/v2 custom metrics)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        # Parsed load profiles memoized by pod uid (annotations are
        # immutable post-create; re-parsing JSON every HPA sync is waste).
        # Bounded FIFO so elastic pod churn can't grow it without limit.
        from collections import OrderedDict

        self._profiles: "OrderedDict[tuple, Optional[list]]" = OrderedDict()
        self._profiles_max = 4096

    def _profile(self, pod, metric: str) -> Optional[list]:
        import json

        key = (pod.metadata.uid, metric)
        if key not in self._profiles:
            raw = pod.spec.annotations.get(ANNOTATION_LOAD_PROFILE_PREFIX + metric)
            self._profiles[key] = json.loads(raw) if raw is not None else None
            while len(self._profiles) > self._profiles_max:
                self._profiles.popitem(last=False)
        return self._profiles[key]

    def get(self, namespace: str, target: str, metric: str) -> Optional[float]:
        from training_operator_tpu_torch.api.common import JOB_NAME_LABEL
        from training_operator_tpu_torch.cluster.objects import PodPhase

        now = self.cluster.clock.now()
        values = []
        # Index-backed list: only the target job's pods, not the cluster.
        pods = self.cluster.api.list("Pod", namespace, {JOB_NAME_LABEL: target})
        for pod in pods:
            # RUNNING pods only (k8s HPA semantics): a Pending replica does
            # no work and must not count toward the average.
            if pod.status.phase != PodPhase.RUNNING:
                continue
            raw = pod.spec.annotations.get(ANNOTATION_METRIC_PREFIX + metric)
            if raw is None:
                profile = self._profile(pod, metric)
                if profile is None or pod.status.start_time is None:
                    continue
                t = now - pod.status.start_time
                value = None
                for t0, v in profile:
                    if t >= t0:
                        value = v
                    else:
                        break
                if value is None:
                    continue
                values.append(float(value))
            else:
                values.append(float(raw))
        return sum(values) / len(values) if values else None


class HorizontalAutoscaler:
    """The HPA control loop (what kube-controller-manager provides upstream)."""

    def __init__(
        self,
        cluster: Cluster,
        metrics: Optional[MetricsSource] = None,
        sync_period: float = 15.0,
        stabilization_seconds: float = 60.0,
    ):
        self.cluster = cluster
        self.api = cluster.api
        # Default to the LIVE pod-annotation feed; tests that want manual
        # control pass a StaticMetricsSource explicitly.
        self.metrics = metrics or ClusterMetricsSource(cluster)
        self.sync_period = sync_period
        self.stabilization_seconds = stabilization_seconds
        self._last_scale: Dict[str, float] = {}
        self._next_sync = 0.0
        cluster.add_ticker(self.tick)

    def tick(self) -> None:
        now = self.cluster.clock.now()
        if now < self._next_sync:
            return
        self._next_sync = now + self.sync_period
        for hpa in self.api.list("HorizontalPodAutoscaler"):
            self._sync_one(hpa, now)

    def _current_replicas(self, namespace: str, job) -> Optional[int]:
        """Worker count of a v1 job (a v2 TrainJob target comes with
        runtime v2, still to be ported)."""
        spec = job.replica_specs.get(REPLICA_WORKER)
        return (spec.replicas or 0) if spec is not None else None

    @staticmethod
    def _apply_replicas(job, desired: int) -> None:
        job.replica_specs[REPLICA_WORKER].replicas = desired

    def _sync_one(self, hpa, now: float) -> None:
        job = self.api.try_get(hpa.target_kind, hpa.namespace, hpa.target_name)
        if job is None:
            return
        current = self._current_replicas(hpa.namespace, job)
        if current is None:
            return
        observed = (hpa.current_replicas, hpa.desired_replicas)
        proposals = []
        for m in hpa.metrics:
            name = m.get("name", "")
            target = float(m.get("target", 0) or 0)
            if target <= 0:
                continue
            actual = self.metrics.get(hpa.namespace, hpa.target_name, name)
            if actual is None:
                continue
            # k8s HPA core formula; max over metrics.
            proposals.append(math.ceil(current * actual / target))
        desired = max(proposals) if proposals else current
        desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))
        hpa.current_replicas = current
        hpa.desired_replicas = desired
        if desired == current:
            # Steady state: persist the observed sizes only when they
            # actually changed — an unconditional write per sync would spam
            # version bumps and watch events cluster-wide.
            if (current, desired) != observed:
                self._update_versioned(hpa)
            return
        key = f"{hpa.namespace}/{hpa.name}"
        if desired < current and now - self._last_scale.get(key, -1e9) < self.stabilization_seconds:
            return  # downscale stabilization window
        # Version-checked scale write: an HPA resize racing a reconciler's
        # status write (or a user spec edit) must not silently last-write-
        # win. On conflict, re-read and re-apply against fresh state.
        for _ in range(3):
            self._apply_replicas(job, desired)
            try:
                self.api.update(job, check_version=True)
                break
            except NotFoundError:
                return  # target deleted mid-sync
            except ConflictError:
                job = self.api.try_get(hpa.target_kind, hpa.namespace, hpa.target_name)
                if job is None or self._current_replicas(hpa.namespace, job) is None:
                    return
        else:
            return  # persistent conflicts: next sync retries
        self._last_scale[key] = now
        self._update_versioned(hpa)

    def _update_versioned(self, hpa) -> None:
        try:
            self.api.update(hpa, check_version=True)
        except (ConflictError, NotFoundError):
            pass  # stale read or deleted; next sync re-reads


def repack_grown_gangs(
    api, placer, snapshot_factory: Callable[[], ClusterSnapshot], now: float = 0.0
) -> Tuple[int, int]:
    """Incrementally place missing members of admitted gangs.

    A gang that scaled out has pods in its (current) spec that carry no
    placement entry; a gang that scaled in has stale entries whose pods are
    gone. Stale entries are pruned (releasing their capacity reservation) and
    the delta pods are solved as a mini-gang against a live snapshot;
    existing members are untouched. Returns (groups updated, groups whose
    delta could NOT be fully placed) — callers must retry the latter when
    capacity frees (the job spec still exceeds the placement size, so the
    size check below re-detects them).

    The snapshot is built lazily — a cheap size check (spec replica count vs
    placement entries) filters the common no-elastic case before any
    O(cluster) work happens.
    """
    updated = 0
    unsatisfied = 0
    snapshot: Optional[ClusterSnapshot] = None
    for pg in api.list("PodGroup"):
        if pg.phase not in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING):
            continue
        if not pg.placement:
            continue
        job = resolve_owner_job(api, pg)
        if job is None or job.total_replicas() == len(pg.placement):
            continue  # size matches: nothing grew or shrank
        req = build_gang_request(api, pg)
        if req is None:
            continue
        if req.is_tpu():
            ok, unsat = _resize_tpu_gang(api, placer, snapshot_factory, pg, job, req, now)
            updated += ok
            unsatisfied += unsat
            continue
        want = {p.name for p in req.pods}
        have = set(pg.placement)
        stale = have - want
        missing = [p for p in req.pods if p.name not in have]
        if not stale and not missing:
            continue
        if snapshot is None:
            snapshot = snapshot_factory()
        for name in stale:
            pg.placement.pop(name, None)
        if missing:
            # Generic (CPU/GPU) elastic membership: place ONLY the delta.
            # topology=None routes it through the generic best-fit path
            # (NVLink-locality bonus pulls new members toward the gang's
            # existing domain).
            delta = GangRequest(group=pg, pods=missing, topology=None, num_slices=1)
            placements = placer.place([delta], snapshot)
            placement = placements.get(delta.key)
            if placement is not None:
                pg.placement.update(placement.assignments)
            else:
                unsatisfied += 1
        pg.min_member = len(pg.placement)
        try:
            # Version-checked: `pg` was listed this pass; a conflict means a
            # concurrent writer (admission, engine) won — the size check
            # re-detects the gang next cycle against fresh state.
            api.update(pg, check_version=True)
        except NotFoundError:
            continue  # group deleted mid-pass
        except ConflictError:
            unsatisfied += 1
            continue
        updated += 1
    return updated, unsatisfied


_REJECTED_SIZE_ANNOTATION = "elastic.tpu.dev/rejected-size"


def _resize_tpu_gang(
    api, placer, snapshot_factory, pg, job, req, now: float
) -> Tuple[int, int]:
    """TPU mesh resize = ADMIT-THEN-RESTART (BASELINE.md config 4's TPU arm).

    Membership defines the ICI mesh, so a resized TPU gang cannot be patched
    member-by-member the way torchrun handles GPU elasticity. The contract:
    the per-slice worker count is fixed by the topology, and elastic scaling
    moves in whole-slice units (data parallelism across slices).

    The new shape is solved FIRST, against a trial snapshot with this gang's
    own capacity released — only a feasible resize tears the running gang
    down (a grow that cannot fit must not take N running workers to zero;
    it stays as-is, counted unsatisfied, retried when capacity frees). On a
    feasible resize, every pod of the job is deleted (not just placed ones —
    the engine may have pre-created delta pods with stale world-size env)
    and the group is re-admitted atomically with the precomputed placement;
    the engine recreates the full pod set with fresh env, and the trainer
    resumes from its latest checkpoint via restore_into_mesh.

    Non-whole-slice sizes are rejected with a Warning event (deduped via an
    annotation) — there is no placeable shape to retry.

    Returns (updated, unsatisfied).
    """
    from training_operator_tpu_torch.api.common import JOB_NAME_LABEL
    from training_operator_tpu_torch.cluster.inventory import TPU_RESOURCE
    from training_operator_tpu_torch.cluster.objects import Event

    old_total = len(pg.placement)
    new_total = job.total_replicas()
    per_slice = old_total // max(1, pg.num_slices)
    if per_slice <= 0 or new_total % per_slice:
        if pg.metadata.annotations.get(_REJECTED_SIZE_ANNOTATION) != str(new_total):
            pg.metadata.annotations[_REJECTED_SIZE_ANNOTATION] = str(new_total)
            try:
                api.update(pg, check_version=True)
            except (ConflictError, NotFoundError):
                return 0, 0  # re-detected next cycle; event dedup re-checks
            api.record_event(Event(
                object_kind="PodGroup", object_name=pg.name, namespace=pg.namespace,
                event_type="Warning", reason="InvalidResize",
                message=f"TPU gang resize to {new_total} is not a whole number "
                        f"of {per_slice}-worker slices; keeping {old_total}",
                timestamp=now,
            ))
        return 0, 0
    new_slices = new_total // per_slice

    # Trial solve: release this gang's own capacity in a throwaway snapshot,
    # then place the new shape.
    snapshot = snapshot_factory()
    own_pods = api.list("Pod", pg.namespace, {JOB_NAME_LABEL: pg.name})
    for pod in own_pods:
        if pod.node_name and not pod.is_terminal():
            avail = snapshot.free.get(pod.node_name)
            if avail is not None:
                for k, v in pod.resources().items():
                    avail[k] = avail.get(k, 0.0) + v
    for node_name in pg.reserved_nodes:
        node = snapshot.nodes.get(node_name)
        avail = snapshot.free.get(node_name)
        if node is not None and avail is not None:
            chips = node.capacity.get(TPU_RESOURCE, 0.0)
            if chips:
                avail[TPU_RESOURCE] = avail.get(TPU_RESOURCE, 0.0) + chips
    req.num_slices = new_slices
    placement = placer.place([req], snapshot, now=now).get(req.key)
    if placement is None:
        return 0, 1  # keep running at the old size; retry when capacity frees

    # Commit order: job spec, then group, then pod teardown — all version-
    # checked, and pods are only deleted once both writes landed (a conflict
    # must never take a running gang down without its replacement admitted).
    try:
        if job.tpu_policy is not None and job.tpu_policy.num_slices != new_slices:
            job.tpu_policy.num_slices = new_slices
            api.update(job, check_version=True)
        pg.metadata.annotations.pop(_REJECTED_SIZE_ANNOTATION, None)
        pg.placement = dict(placement.assignments)
        pg.reserved_nodes = list(placement.reserved_nodes)
        pg.num_slices = new_slices
        pg.min_member = new_total
        pg.phase = PodGroupPhase.INQUEUE  # pre-admitted with the trial placement
        api.update(pg, check_version=True)
    except NotFoundError:
        return 0, 0  # job or group deleted mid-resize; nothing to do
    except ConflictError:
        return 0, 1  # concurrent writer won; retry against fresh state
    for pod in own_pods:
        api.try_delete("Pod", pod.namespace, pod.name)
    return 1, 0
