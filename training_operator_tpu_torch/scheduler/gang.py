"""GangScheduler: the cluster component that admits PodGroups and binds pods.

Fills the role of the external Volcano / scheduler-plugins deployment in the
reference (SURVEY.md §2.3 "Gang scheduling" row): the engine creates PodGroups
and holds pod creation until admission (PodGroupControl.delay_pod_creation);
this ticker admits gangs through a pluggable placer (the port's TPUPacker,
whose solve runs on the card), records placements on the PodGroup, and binds
the pods the engine subsequently creates to their placed nodes.

Lifecycle (mirrors Volcano's PodGroup phases):
  Pending --(placer finds a full placement)--> Inqueue --(all pods running)-->
  Running; Pending past schedule_timeout_seconds -> Unschedulable (still
  retried each cycle — Volcano does the same — the phase is a signal surface).
Admitted placements reserve capacity via the snapshot until their pods bind;
if a placed node vanishes before binding, the group is reset to Pending and
re-solved against the new inventory.

Counterpart of training_operator_tpu/scheduler/gang.py, first come first
served: the fair-share arbiter in front of the placer, its priority tiers
and checkpoint-aware preemption come with tenancy, still to be ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from training_operator_tpu_torch.cluster.objects import (
    Event,
    Pod,
    PodGroup,
    PodGroupPhase,
    PodPhase,
    node_ready,
)
from training_operator_tpu_torch.cluster.runtime import Cluster, VirtualClock, bind_pod
from training_operator_tpu_torch.engine.control import PodGroupControl
from training_operator_tpu_torch.engine.core import (
    NODE_LOST_MESSAGE_PREFIX,
    pod_failed_node_lost,
)

# Reason this scheduler stamps on the members it evicts during a gang
# re-placement. _observe_pod filters these out of the lost-gang trigger:
# without the filter, the gang's own re-placement evictions would re-flag
# it and a second invalidation would discard the freshly re-solved
# placement (an extra evict->solve cycle on every node loss).
GANG_REPLACEMENT_REASON = "gang re-placement"
_GANG_EVICT_MESSAGE_PREFIX = f"{NODE_LOST_MESSAGE_PREFIX}: {GANG_REPLACEMENT_REASON}"
from training_operator_tpu_torch.scheduler.snapshot import (
    ClusterSnapshot,
    SnapshotMaintainer,
    build_gang_request,
    prime_scheduler_caches,
)
from training_operator_tpu_torch.utils import metrics


class GangScheduler:
    """Ticker: one scheduling cycle per cluster tick."""

    def __init__(
        self,
        cluster: Cluster,
        placer,
        charge_solve_time: bool = False,
        prewarm: bool = False,
        resolve_period: float = 15.0,
        min_solve_interval: float = 0.0,
        incremental: bool = True,
        snapshot_selfcheck_every: int = 0,
    ):
        self.cluster = cluster
        self.api = cluster.api
        self.placer = placer
        # Compile the placer for this pool before the first cycle (one-time
        # XLA compile; belongs to operator startup, not to job latency).
        self._needs_prewarm = prewarm and hasattr(placer, "prewarm")
        # When benching on a VirtualClock, advance sim time by the real wall
        # time each solve took, so "p50 schedule-to-running" includes the
        # scheduler's own latency, not just queueing (BASELINE.md configs 2/5).
        self.charge_solve_time = charge_solve_time
        self.solve_walltime_total = 0.0
        self.cycles = 0
        # Event-driven solving: a gang that didn't fit cannot fit until an
        # event that frees capacity (pod terminal/deleted, node change) or
        # changes demand (PodGroup created/reset, job spec resized) — status
        # churn alone never does. A periodic re-solve bounds the staleness of
        # anything the event rules miss. Informer-style, like the reference's
        # event-triggered reconciles vs. Volcano's fixed period.
        self.resolve_period = resolve_period
        # Coalescing: a dirty event within min_solve_interval of the last
        # solve defers (a wakeup timer guarantees the deferred solve runs),
        # so a burst of pod completions is admitted against one snapshot by
        # one solve instead of one per completion instant. Trades a bounded
        # admission delay for fewer, larger solves.
        self.min_solve_interval = min_solve_interval
        self._wakeup_armed = False
        self._watch = cluster.api.watch()
        # Incremental solving (the solver_incremental knob): per-group +
        # per-node dirty tracking instead of the one global bit. A cycle
        # triggered only by demand-side events (gang created / reset /
        # resized) re-solves just those groups — placements and verdicts of
        # untouched gangs are invariant while free capacity can only have
        # shrunk. Any capacity-freeing event, a write conflict, or the
        # periodic resolve falls back to a full solve, so a freed window
        # re-opens every gang.
        self.incremental = incremental
        self._dirty_groups: set = set()
        self._solve_all = True  # first solve is always a full one
        # Full-rebuild parity probe for the incremental snapshot: every N
        # solve cycles, diff the delta-maintained view against a cold walk
        # and adopt the rebuild on mismatch. 0 disables.
        self.snapshot_selfcheck_every = snapshot_selfcheck_every
        self._solves_since_selfcheck = 0
        self._solve_dirty = True
        self._bind_dirty = True
        self._advance_dirty = True
        self._repack_dirty = False
        self._repack_unsatisfied = False
        self._capacity_freed = False
        self._last_solve_at = -float("inf")
        # Informer caches maintained from watch events (initial LIST below):
        # unbound gang pods awaiting binding, pods grouped by PodGroup, bound
        # non-terminal pods (the snapshot's capacity view), plus PodGroups
        # and Nodes themselves — with copy-on-read these caches are what
        # keeps the per-cycle solve path allocation-free.
        self._unbound: Dict[tuple, Pod] = {}
        self._group_pods: Dict[str, Dict[str, Pod]] = {}
        self._bound_active: Dict[tuple, Pod] = {}
        self._groups: Dict[str, PodGroup] = {}
        self._nodes: Dict[str, object] = {}
        # Failed-admission attempt counts, keyed by PodGroup uid. Tracked
        # scheduler-side (NOT by mutating the read copy, which copy-on-read
        # would silently discard) and persisted onto the group only on the
        # Unschedulable transition.
        self._attempts: Dict[str, int] = {}
        # Gangs whose placement lost a node (member evicted NodeLost, or a
        # placed node deleted): gkey -> reason. Processed each tick by
        # _process_invalidations — the gang re-admission arm of node-loss
        # recovery: evict surviving members, reset to PENDING, re-solve.
        self._lost_groups: Dict[str, str] = {}
        # Structured per-cycle solve trace (SURVEY §5: the solve path is the
        # subsystem worth observing; the reference has nothing comparable).
        # Ring buffer of dicts — one per solve cycle; see _record_trace.
        from collections import deque

        self.trace = deque(maxlen=2048)
        # Cross-cycle memos: expanded GangRequests keyed by PodGroup uid and
        # the snapshot's per-gang pod-request cache (both invalidated by the
        # owning job's resourceVersion).
        self._req_cache: Dict[str, tuple] = {}
        self._pod_req_cache: Dict[str, tuple] = {}
        # Informer prime (the one legal full walk, served from snapshot.py —
        # codelint CL007 keeps store walks out of the solve path).
        pods, pgs, nodes = prime_scheduler_caches(self.api)
        for pod in pods:
            self._observe_pod("Added", pod)
        for pg in pgs:
            self._groups[f"{pg.namespace}/{pg.name}"] = pg
        for node in nodes:
            self._nodes[node.name] = node
        # The long-lived incremental snapshot view, fed from the same watch
        # stream the informer caches consume. Compat mode (incremental=False)
        # keeps the per-cycle construction from the informer caches.
        self._maintainer: Optional[SnapshotMaintainer] = None
        if incremental:
            self._maintainer = SnapshotMaintainer(self.api, self._pod_req_cache)
            self._maintainer.rebuild()
        cluster.add_ticker(self.tick)

    # ------------------------------------------------------------------

    def _snapshot(self) -> ClusterSnapshot:
        if self._maintainer is not None:
            return self._maintainer.snapshot()
        return ClusterSnapshot(
            self.api,
            self._pod_req_cache,
            bound_pods=self._bound_active.values(),
            podgroups=self._groups.values(),
            nodes=self._nodes.values(),
        )

    def _observe_pod(self, ev_type: str, pod: Pod) -> None:
        key = (pod.namespace, pod.name)
        if ev_type != "Deleted" and pod.node_name and not pod.is_terminal():
            self._bound_active[key] = pod
        else:
            self._bound_active.pop(key, None)
        gname = pod.spec.annotations.get(PodGroupControl.POD_GROUP_ANNOTATION)
        if gname:
            gkey = f"{pod.namespace}/{gname}"
            if ev_type == "Deleted":
                self._group_pods.get(gkey, {}).pop(pod.name, None)
            else:
                self._group_pods.setdefault(gkey, {})[pod.name] = pod
                if pod_failed_node_lost(pod) and not pod.status.message.startswith(
                    _GANG_EVICT_MESSAGE_PREFIX
                ):
                    # A member died WITH its node (lifecycle eviction/drain):
                    # the gang's placement is stale hardware — re-solve it
                    # whole rather than re-pinning pods to a dead host. Our
                    # OWN re-placement evictions are excluded (see
                    # GANG_REPLACEMENT_REASON) or they would re-trigger this.
                    self._lost_groups.setdefault(gkey, pod.status.message)
            self._advance_dirty = True
        if (
            ev_type != "Deleted"
            and not pod.node_name
            and pod.status.phase == PodPhase.PENDING
            and pod.spec.scheduler_name == PodGroupControl.SCHEDULER_NAME
        ):
            self._unbound[key] = pod
            self._bind_dirty = True
        else:
            self._unbound.pop(key, None)

    def _drain_events(self) -> None:
        for ev in self._watch.drain():
            kind, obj = ev.kind, ev.obj
            if self._maintainer is not None and kind in ("Pod", "PodGroup", "Node"):
                self._maintainer.observe(ev)
            if kind == "Pod":
                self._observe_pod(ev.type, obj)
                # Capacity is freed when a pod terminates or disappears.
                if ev.type == "Deleted" or obj.is_terminal():
                    self._solve_dirty = True
                    self._solve_all = True
                    self._capacity_freed = True
            elif kind == "PodGroup":
                gkey = f"{obj.namespace}/{obj.name}"
                if ev.type == "Added" or (
                    ev.type != "Deleted" and obj.phase == PodGroupPhase.PENDING
                ):
                    # Demand-side event: only THIS gang's verdict changed —
                    # the incremental cycle re-solves it alone (capacity can
                    # only have shrunk for everyone else).
                    self._solve_dirty = True
                    self._dirty_groups.add(gkey)
                self._bind_dirty = True
                self._advance_dirty = True
                if ev.type == "Deleted":
                    self._groups.pop(gkey, None)
                    self._group_pods.pop(gkey, None)
                    self._req_cache.pop(obj.metadata.uid, None)
                    self._pod_req_cache.pop(obj.metadata.uid, None)
                    self._attempts.pop(obj.metadata.uid, None)
                    self._solve_dirty = True  # reservations released
                    self._solve_all = True
                    self._capacity_freed = True
                else:
                    self._groups[gkey] = obj
            elif kind == "Node":
                name = obj.metadata.name
                if ev.type == "Deleted":
                    self._nodes.pop(name, None)
                    # Admitted gangs placed on the vanished node can never
                    # bind there; queue their re-solve now (running members
                    # are flagged separately by their NodeLost evictions).
                    for gkey, pg in self._groups.items():
                        if pg.phase in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING) and (
                            name in pg.placement.values() or name in pg.reserved_nodes
                        ):
                            self._lost_groups.setdefault(
                                gkey, f"node {name} deleted"
                            )
                else:
                    self._nodes[name] = obj
                self._solve_dirty = True
                self._solve_all = True
                self._bind_dirty = True
                self._capacity_freed = True
            elif (
                ev.type == "Modified"
                and not ev.status_only
                and hasattr(obj, "replica_specs")
            ):
                # A job spec change (elastic resize) can grow an admitted
                # gang (re-pack) or resize a still-pending one (re-solve).
                # PodGroup name == owning job name (PodGroupControl).
                self._repack_dirty = True
                self._solve_dirty = True
                self._dirty_groups.add(
                    f"{obj.metadata.namespace}/{obj.metadata.name}"
                )
            elif ev.type == "Deleted" and hasattr(obj, "replica_specs"):
                # Owner gone: the memoized request must not be trusted past
                # this instant (the group itself is cascade-GC'd shortly).
                self._dirty_groups.add(
                    f"{obj.metadata.namespace}/{obj.metadata.name}"
                )

    def tick(self) -> None:
        if self._needs_prewarm:
            self._needs_prewarm = False
            self.placer.prewarm(self._snapshot())
        self._drain_events()
        if self._process_invalidations():
            # The invalidation just wrote evictions + placement clears;
            # absorb their watch echoes NOW so this tick's solve (and the
            # incremental snapshot) sees the post-invalidation state rather
            # than lagging it by one tick.
            self._drain_events()
        self._admit_pending()
        # Repack runs on job-spec resizes AND retries unsatisfied deltas
        # whenever capacity frees — a grown gang whose delta didn't fit must
        # not stall until the next spec write (the HPA writes nothing once
        # desired == spec).
        if self._repack_dirty or (self._repack_unsatisfied and self._capacity_freed):
            from training_operator_tpu_torch.scheduler.elastic import repack_grown_gangs

            self._repack_dirty = False
            updated, unsatisfied = repack_grown_gangs(
                self.api, self.placer, self._snapshot, now=self.cluster.clock.now()
            )
            self._repack_unsatisfied = unsatisfied > 0
            if updated:
                self._bind_dirty = True
        self._capacity_freed = False
        if self._bind_dirty:
            self._bind_dirty = False
            self._bind_pods()
        if self._advance_dirty:
            self._advance_dirty = False
            self._advance_running()

    # ------------------------------------------------------------------

    def _maybe_selfcheck(self) -> None:
        """Every snapshot_selfcheck_every solve cycles, diff the incremental
        snapshot against a cold rebuild (SnapshotMaintainer.selfcheck). A
        mismatch adopts the rebuild and surfaces as an Event — a missed
        delta must not silently compound into wrong placements."""
        if self._maintainer is None or self.snapshot_selfcheck_every <= 0:
            return
        self._solves_since_selfcheck += 1
        if self._solves_since_selfcheck < self.snapshot_selfcheck_every:
            return
        self._solves_since_selfcheck = 0
        problems = self._maintainer.selfcheck()
        if problems:
            self.api.record_event(Event(
                object_kind="Node", object_name="*", namespace="",
                event_type="Warning", reason="SnapshotDrift",
                message=f"incremental snapshot diverged ({len(problems)} "
                        f"mismatch(es)); rebuilt: {problems[0]}",
                timestamp=self.cluster.clock.now(),
            ))

    def _record_trace(self, now, wall, requests, placements, snapshot,
                      mode: str = "full") -> None:
        """One structured record per solve cycle: queue shape, solver work,
        admissions, and free-capacity/fragmentation state (post-admission:
        place() commits into the snapshot) — enough to replay WHY a gang
        waited (queue depth? no candidates? fragmented pool?) without
        re-running the solve. O(requests) bookkeeping per cycle."""
        from training_operator_tpu_torch.cluster.inventory import TPU_RESOURCE

        admitted = sum(1 for p in placements.values() if p is not None)
        tpu_reqs = sum(1 for r in requests if r.is_tpu())
        if self._maintainer is not None and hasattr(snapshot, "_overlay"):
            # O(committed): maintained tallies + this cycle's COW overlay.
            free_hosts, whole_free_slices = self._maintainer.free_host_stats(
                snapshot._overlay
            )
        else:
            free_hosts = 0
            whole_free_slices = 0
            free_map = snapshot.free
            for sl in snapshot.slices.values():
                chips = sl.chips_per_host
                free = sum(
                    1
                    for n in sl.host_nodes
                    if (a := free_map.get(n)) is not None
                    and a.get(TPU_RESOURCE, 0.0) >= chips
                )
                free_hosts += free
                if free == sl.num_hosts:
                    whole_free_slices += 1
        record = {
            "t": round(now, 3),
            "solve_wall_s": round(wall, 6),
            "mode": mode,
            "pending": len(requests),
            "pending_tpu": tpu_reqs,
            "pending_generic": len(requests) - tpu_reqs,
            "admitted": admitted,
            "free_tpu_hosts": free_hosts,
            "whole_free_slices": whole_free_slices,
        }
        # The packer publishes its batch geometry; other placers don't.
        stats = getattr(self.placer, "last_solve_stats", None)
        if stats:
            record["solver"] = {k: v for k, v in stats.items()}
        self.trace.append(record)

    def dump_trace(self) -> List[dict]:
        """The solve trace as a list (oldest first) — feed to json.dumps."""
        return list(self.trace)

    def _wakeup(self) -> None:
        # No-op timer body: existing so the virtual clock has a reason to
        # stop at the deferred-solve instant; the tick that follows solves.
        self._wakeup_armed = False

    def _gang_request(self, pg: PodGroup, trust_cache: bool = False):
        """build_gang_request with a (job rv, group shape)-keyed memo — the
        replica expansion is pure given those inputs. The version probe
        avoids cloning the owning job on every cycle (copy-on-read makes
        get() allocate); the job is only fetched on a cache miss.

        `trust_cache` (incremental mode, non-dirty groups): skip even the
        version probe — every spec change that could invalidate the memo
        arrives as a watch event that marks the group dirty, so an
        untouched group's memo is current by construction."""
        if trust_cache:
            hit = self._req_cache.get(pg.metadata.uid)
            if hit is not None:
                req = hit[1]
                req.group = pg  # rebind to the current object
                return req
        kind = pg.metadata.labels.get("job-kind")
        if not kind:
            return None
        rv = self.api.resource_version(kind, pg.namespace, pg.name)
        if rv is None:
            return None  # owner gone; group awaits cascade GC
        ck = (kind, rv, pg.topology_request, pg.num_slices, pg.min_member)
        hit = self._req_cache.get(pg.metadata.uid)
        if hit is not None and hit[0] == ck:
            req = hit[1]
            req.group = pg  # rebind to the current object
            return req
        req = build_gang_request(self.api, pg)
        if req is not None:
            self._req_cache[pg.metadata.uid] = (ck, req)
        return req

    def _admit_pending(self) -> None:
        groups = [
            pg
            for pg in self._groups.values()
            if pg.phase in (PodGroupPhase.PENDING, PodGroupPhase.UNSCHEDULABLE)
        ]
        if not groups:
            return
        self._check_timeouts(groups)
        now = self.cluster.clock.now()
        since_last = now - self._last_solve_at
        if not self._solve_dirty and since_last < self.resolve_period:
            return
        # Tolerance on the deferral window: without it, a wakeup that fires
        # at (last_solve + min_interval) can leave `min_interval -
        # since_last` a float hair above zero — the re-armed timer then
        # lands at an instant where now + delta == now, and the tick/timer
        # pair busy-steps the virtual clock forever at one instant (the
        # week-long soak surfaced this as a wall-clock stall).
        remaining = self.min_solve_interval - since_last
        if self._solve_dirty and remaining > 1e-9:
            if not self._wakeup_armed:
                self._wakeup_armed = True
                self.cluster.schedule_after(remaining, self._wakeup)
            return
        t0 = time.perf_counter()
        solve_at = now  # cluster-clock solve start, for the timeline spans
        # Incremental cycle: a solve triggered purely by demand-side dirt
        # re-solves only the dirty gangs. Capacity events, write conflicts, and the periodic staleness bound (resolve_period, which
        # reaches here with _solve_dirty False) all force the full set.
        incremental_cycle = (
            self.incremental
            and self._solve_dirty
            and not self._solve_all
        )
        if incremental_cycle:
            # Starvation controls (drain reservations, aging promotion) are
            # computed WITHIN a solve from the gangs it sees: once any
            # pending gang has aged past those thresholds, a subset solve
            # could hand a newly-arrived gang capacity the full solve
            # withholds for the starved one. Escalate to the full set.
            bound = min(
                (t for t in (
                    getattr(self.placer, "drain_reserve_seconds", 0.0),
                    getattr(self.placer, "aging_seconds", 0.0),
                ) if t and t > 0),
                default=0.0,
            )
            if bound > 0:
                threshold = now - bound
                if any(
                    (pg.metadata.creation_time or 0.0) <= threshold
                    for pg in groups
                ):
                    incremental_cycle = False
        dirty = self._dirty_groups
        if incremental_cycle:
            solve_groups = [
                pg for pg in groups if f"{pg.namespace}/{pg.name}" in dirty
            ]
        else:
            solve_groups = groups
        self._solve_dirty = False
        self._solve_all = False
        self._dirty_groups = set()
        self._last_solve_at = now
        self._maybe_selfcheck()
        snapshot = self._snapshot()
        requests = []
        req_cache = self._req_cache
        trust = self.incremental
        no_dirty = not dirty
        for pg in solve_groups:
            # Inlined trust-cache fast path (see _gang_request): with a few
            # hundred pending gangs re-listed every cycle, even one probe
            # per gang is measurable solve wall. Capacity-triggered cycles
            # usually carry an empty dirty set, skipping even the key build.
            if trust and (no_dirty or f"{pg.namespace}/{pg.name}" not in dirty):
                hit = req_cache.get(pg.metadata.uid)
                if hit is not None:
                    req = hit[1]
                    req.group = pg
                    requests.append(req)
                    continue
            req = self._gang_request(pg)
            if req is not None:
                requests.append(req)
        if not requests:
            return
        metrics.solver_cycles.inc()
        if incremental_cycle:
            metrics.solver_incremental_cycles.inc()
        metrics.solver_groups_resolved.inc(amount=len(requests))
        solved = requests
        placements = self.placer.place(requests, snapshot, now=now)
        wall = time.perf_counter() - t0
        self.solve_walltime_total += wall
        self.cycles += 1
        mode = "incremental" if incremental_cycle else "full"
        metrics.scheduler_solve_seconds.observe(wall)
        self._record_trace(now, wall, solved, placements, snapshot, mode)
        if self.charge_solve_time and isinstance(self.cluster.clock, VirtualClock):
            self.cluster.clock.advance(wall)

        now = self.cluster.clock.now()
        for req in solved:
            pg = req.group
            placement = placements.get(req.key)
            if placement is not None:
                live = self._fresh_for_write(pg)
                if live is None:
                    continue
                live.placement = dict(placement.assignments)
                live.reserved_nodes = list(placement.reserved_nodes)
                live.placement_score = placement.score
                live.phase = PodGroupPhase.INQUEUE
                if self._persist(live):
                    metrics.podgroups_admitted.inc()
                    self._event(live, "Normal", "GangAdmitted",
                                f"placed on {len(set(placement.assignments.values()))} nodes")
                    # Timeline: the solve cycle that admitted this gang.
                    # PodGroup name == owning job name (PodGroupControl),
                    # so the span lands on the job's timeline; the batch
                    # solve's wall time is attributed to each gang it
                    # admitted (they shared the cycle).
                    self.api.timelines.record_span(
                        live.namespace, live.name, live.metadata.owner_uid or "",
                        "gang_solve", start=solve_at, end=now, wall=wall,
                        pending=len(requests),
                        nodes=len(set(placement.assignments.values())),
                        mode=mode, dirty_groups=len(requests),
                    )
            else:
                # Track attempts scheduler-side without an API write per
                # cycle — persisting every failed attempt would look like
                # cluster activity and (on a virtual clock) starve time
                # advancement; mutating the read copy would be silently
                # discarded under copy-on-read. Counts are persisted onto
                # the group by _check_timeouts at the phase transition.
                self._attempts[pg.metadata.uid] = self._attempts.get(pg.metadata.uid, 0) + 1
        # Our own admission writes (phase -> INQUEUE) echo back through the
        # watch but do not match any dirty rule, so they don't force a
        # redundant re-solve next tick.

    def _process_invalidations(self) -> bool:
        if not self._lost_groups:
            return False
        lost, self._lost_groups = self._lost_groups, {}
        for gkey, reason in lost.items():
            self._invalidate_group(gkey, reason)
        return True

    def _invalidate_group(self, gkey: str, reason: str) -> None:
        """Gang re-admission after node loss: evict the surviving members
        (their hosts' capacity must be free for the re-solve — a one-host
        loss breaks the whole slice's ICI mesh, so recovery is re-solving
        the GANG's placement, not restarting one pod), clear the placement,
        and reset the group to Pending. The placer then re-admits it against
        the surviving inventory — preferring a whole intact slice when the
        dead host broke contiguity — and the engine recreates pods pinned
        to the fresh assignments."""
        pg = self._groups.get(gkey)
        if pg is None or pg.phase not in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING):
            return
        live = self._fresh_for_write(pg)
        if live is None or live.phase not in (
            PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING
        ):
            return
        from training_operator_tpu_torch.controllers.nodelifecycle import evict_pod

        now = self.cluster.clock.now()
        for pod in list(self._group_pods.get(gkey, {}).values()):
            evict_pod(
                self.api, pod, f"{GANG_REPLACEMENT_REASON}: {reason}", now,
                node_name=pod.node_name,
            )
        live.placement = {}
        live.reserved_nodes = []
        live.phase = PodGroupPhase.PENDING
        if self._persist(live):
            self._event(live, "Warning", "PlacementInvalidated",
                        f"{reason}; re-solving gang")
        self._solve_dirty = True
        self._dirty_groups.add(gkey)
        # The released reservation freed capacity others may want too.
        self._solve_all = True
        self._bind_dirty = True

    def _fresh_for_write(self, pg: PodGroup) -> Optional[PodGroup]:
        """Re-read a cached PodGroup before mutating it for a write. Watch-
        event caches lag writes made earlier in the same tick (e.g. a repack
        extending `placement`); a full-object write from the stale copy would
        silently revert them. Within the single-threaded tick nothing races
        the fresh copy, so the follow-up update is version-check safe."""
        return self.api.try_get("PodGroup", pg.namespace, pg.name)

    def _persist(self, pg: PodGroup) -> bool:
        """Version-checked write + write-through of this component's cache
        so same-tick readers see the new state before the watch echo.

        A conflict (concurrent writer won between our fresh read and this
        write, or an injected control-plane fault) is absorbed, not raised:
        the cached copy is dropped and every phase is re-marked dirty so
        the next tick re-reads and re-derives against the winner's state —
        retrying unversioned here could silently revert their write."""
        from training_operator_tpu_torch.cluster.apiserver import ConflictError

        try:
            self.api.update(pg, check_version=True)
        except ConflictError:
            # Replace the cached copy with the WINNER's live state (not a
            # pop: this cache is the scheduler's only view of the group —
            # dropping it with no future watch event would make the gang
            # invisible forever) and re-derive every phase next tick.
            key = f"{pg.namespace}/{pg.name}"
            live = self.api.try_get("PodGroup", pg.namespace, pg.name)
            if live is not None:
                self._groups[key] = live
            else:
                self._groups.pop(key, None)
            self._solve_dirty = True
            self._solve_all = True
            self._bind_dirty = True
            self._advance_dirty = True
            return False
        self._groups[f"{pg.namespace}/{pg.name}"] = pg
        return True

    def _check_timeouts(self, groups: List[PodGroup]) -> None:
        now = self.cluster.clock.now()
        for pg in groups:
            timeout = pg.schedule_timeout_seconds
            created = pg.metadata.creation_time or now
            if (
                pg.phase == PodGroupPhase.PENDING
                and self._attempts.get(pg.metadata.uid, 0) > 0
                and timeout is not None
                and now - created > timeout
            ):
                live = self._fresh_for_write(pg)
                if live is None or live.phase != PodGroupPhase.PENDING:
                    continue
                live.phase = PodGroupPhase.UNSCHEDULABLE
                live.creation_attempts = self._attempts.get(pg.metadata.uid, 0)
                if self._persist(live):
                    # Event only when the transition actually landed — a
                    # conflict retries next tick, and an unconditional
                    # event would duplicate every cycle until it does.
                    self._event(live, "Warning", "Unschedulable",
                                f"no feasible placement after {timeout}s")

    # ------------------------------------------------------------------

    def _bind_pods(self) -> None:
        if not self._unbound:
            return
        groups = self._groups
        cached_nodes = self._nodes

        # NotReady nodes are as unusable as cordoned ones: a bind onto a
        # dead host would start nothing and re-evict later. Checked per
        # TARGET node — materializing the usable set up front walked all
        # 10k nodes on every tick that had an unbound pod (a soak-surfaced
        # hot loop; binds touch a handful of nodes each).
        def usable(name: str) -> bool:
            n = cached_nodes.get(name)
            return n is not None and not n.unschedulable and node_ready(n)

        for key, pod in list(self._unbound.items()):
            pg_name = pod.spec.annotations.get(PodGroupControl.POD_GROUP_ANNOTATION)
            if not pg_name:
                self._unbound.pop(key, None)
                continue
            pg = groups.get(f"{pod.namespace}/{pg_name}")
            if pg is None or pg.phase == PodGroupPhase.PENDING:
                continue
            target = pg.placement.get(pod.name)
            if target is None:
                continue
            if not usable(target):
                # Placed node vanished/died before binding: re-solve the
                # whole gang (evicts any members already running, so the
                # solve sees the gang's full demand against live capacity).
                self._invalidate_group(
                    f"{pod.namespace}/{pg_name}",
                    f"node {target} is gone",
                )
                continue
            bind_now = self.cluster.clock.now()
            bind_pod(self.api, pod, target, now=bind_now)
            self._unbound.pop(key, None)
            metrics.pods_bound.inc()
            # Timeline: one bind instant per gang pod (pg name == job name).
            self.api.timelines.record_span(
                pod.namespace, pg_name, pg.metadata.owner_uid or "",
                "bind", start=bind_now, end=bind_now,
                pod=pod.name, node=target,
            )

    def _advance_running(self) -> None:
        inqueue = [
            pg for pg in self._groups.values()
            if pg.phase == PodGroupPhase.INQUEUE and pg.placement
        ]
        if not inqueue:
            return
        for pg in inqueue:
            pods = list(self._group_pods.get(f"{pg.namespace}/{pg.name}", {}).values())
            if len(pods) >= pg.min_member and all(
                p.status.phase == PodPhase.RUNNING for p in pods
            ):
                live = self._fresh_for_write(pg)
                if (
                    live is None
                    or live.phase != PodGroupPhase.INQUEUE
                    or len(pods) < live.min_member  # grew since our cache
                ):
                    continue
                live.phase = PodGroupPhase.RUNNING
                self._persist(live)

    def _event(self, pg: PodGroup, etype: str, reason: str, message: str) -> None:
        self.api.record_event(
            Event(
                object_kind="PodGroup",
                object_name=pg.name,
                namespace=pg.namespace,
                event_type=etype,
                reason=reason,
                message=message,
                timestamp=self.cluster.clock.now(),
            )
        )
