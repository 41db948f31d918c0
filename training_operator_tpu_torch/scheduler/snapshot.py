"""Cluster snapshot: the (jobs x nodes x devices) view both placers solve over.

The reference's gang path hands Volcano an opaque PodGroup and lets the
external scheduler see the cluster through the API server. Here the batched
solve needs an explicit immutable snapshot: free capacity per node (bound pods
AND admitted-but-not-yet-bound placements both count), the physical TPU slice
structure, and the pending gangs expanded to per-pod resource requests.

Counterpart of training_operator_tpu/scheduler/snapshot.py, whole: the cold
`ClusterSnapshot` built from an API server (or from the informer views the
gang scheduler keeps), the delta-maintained `SnapshotMaintainer` and its
`IncrementalSnapshot`, and the request expansion the placer solves over.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from training_operator_tpu_torch.api.jobs import Job
from training_operator_tpu_torch.cluster.apiserver import APIServer
from training_operator_tpu_torch.cluster.inventory import TPU_RESOURCE, parse_topology
from training_operator_tpu_torch.cluster.objects import (
    Node,
    PodGroup,
    PodGroupPhase,
    node_ready,
    toleration_key,
    tolerates,
)
from training_operator_tpu_torch.engine.core import gen_general_name

# User-declared expected runtime (seconds) on the pod template. Purely a
# scheduling hint: the packer's weighted-SJF discipline orders contested
# admissions by total work (chips x expected seconds), the way Borg-style
# schedulers consume user runtime estimates. Absent or wrong estimates
# cost ordering quality, never correctness — and aging still bounds wait.
ANNOTATION_EXPECTED_DURATION = "scheduling.tpu.dev/expected-duration-seconds"

# Process-wide source for SnapshotMaintainer.inventory_gen (see its comment).
_inventory_gen_source = itertools.count(1)


@dataclass
class SliceInfo:
    """One physical TPU slice: its geometry and member hosts in host-index
    order (host i owns the i-th contiguous chip block of the slice grid)."""

    slice_id: str
    tpu_type: str
    topology: str  # chip grid, e.g. "4x4"
    chips_per_host: int
    host_nodes: List[str]  # node names ordered by host index

    @property
    def num_hosts(self) -> int:
        return len(self.host_nodes)

    def geometry_class(self) -> Tuple[str, str, int]:
        """Slices with equal geometry share candidate enumerations."""
        return (self.tpu_type, self.topology, self.chips_per_host)


@dataclass
class PodRequest:
    name: str
    replica_type: str
    index: int
    resources: Dict[str, float]
    tolerations: List[Dict[str, object]] = field(default_factory=list)


@dataclass
class GangRequest:
    """A pending PodGroup expanded to the granularity the solver needs."""

    group: PodGroup
    pods: List[PodRequest]
    # TPU gang: requested ICI topology per slice + slice count; None = generic.
    topology: Optional[str] = None
    num_slices: int = 1
    tpu_type: str = ""
    # INTERSECTION of the member pods' tolerations — TPU gang placement
    # zips pods across a sub-mesh's hosts with no per-pod choice, so a host
    # is only usable if EVERY member tolerates its taints (k8s would leave
    # an untolerated member Pending). The generic path gates per pod via
    # PodRequest.tolerations.
    tolerations: List[Dict[str, object]] = field(default_factory=list)
    # Declared expected runtime in seconds (ANNOTATION_EXPECTED_DURATION),
    # None when the job declares nothing. Max across replica templates: the
    # gang holds its hosts until the slowest member finishes.
    expected_duration: Optional[float] = None
    _sorted_pods: Optional[List[PodRequest]] = None
    _total_chips: Optional[float] = None
    # Warm-start memos the packer stamps: (candidate-cache epoch, class id
    # or None) for TPU gangs, and (pool-layout key, per-resource max
    # single-pod demand) for generic ones. Requests are memoized across
    # cycles (GangScheduler._req_cache); with a valid hint a steady-state
    # cycle resolves a gang in one compare instead of rebuilding keys.
    _class_hint: Optional[Tuple] = None
    _generic_hint: Optional[Tuple] = None
    _key: Optional[str] = None

    def toleration_sig(self) -> Tuple:
        """Canonical hashable form — part of the solver's class identity."""
        return tuple(sorted(toleration_key(t) for t in self.tolerations))

    @property
    def key(self) -> str:
        # Memoized: requests are long-lived across cycles and the key is
        # read several times per solve; ns/name never change for a group.
        k = self._key
        if k is None:
            k = self._key = f"{self.group.namespace}/{self.group.name}"
        return k

    def sorted_pods(self) -> List[PodRequest]:
        """Pods in (replica_type, index) order — the per-slice assignment
        order. Memoized: requests are re-solved every cycle but immutable."""
        if self._sorted_pods is None:
            self._sorted_pods = sorted(self.pods, key=lambda p: (p.replica_type, p.index))
        return self._sorted_pods

    def total_chips(self) -> float:
        if self._total_chips is None:
            self._total_chips = sum(
                p.resources.get(TPU_RESOURCE, 0.0) for p in self.pods
            )
        return self._total_chips

    def is_tpu(self) -> bool:
        return self.topology is not None


@dataclass
class Placement:
    """Solver output for one gang: pod name -> node name, plus the score the
    solver assigned (higher = more contiguous / less fragmenting).
    `reserved_nodes` dedicates extra nodes to the gang (whole-slice mode)."""

    assignments: Dict[str, str]
    score: float = 0.0
    slices_used: List[str] = field(default_factory=list)
    reserved_nodes: List[str] = field(default_factory=list)


class ClusterSnapshot:
    """Immutable free-capacity view at solve time.

    Free capacity subtracts (a) resources of bound, non-terminal pods and
    (b) reservations of admitted PodGroups whose placed pods do not yet exist
    or are not yet bound — without (b) two scheduling cycles could hand the
    same hosts to two gangs (the same race the reference's expectations cache
    guards on the pod-creation side).
    """

    def __init__(
        self,
        api: APIServer,
        pod_requests_cache: Optional[Dict[str, Tuple[int, Dict[str, Dict[str, float]]]]] = None,
        bound_pods: Optional[Iterable] = None,
        podgroups: Optional[Iterable[PodGroup]] = None,
        nodes: Optional[Iterable[Node]] = None,
    ):
        self.api = api
        # Optional cross-snapshot memo for per-gang pod requests, keyed by
        # PodGroup uid -> (owning job resourceVersion, per-pod requests).
        # Snapshots are rebuilt every scheduling cycle but job specs rarely
        # change; the owner resolve + replica expansion dominates build time
        # at 1k-gang scale without it.
        self._requests_cache = pod_requests_cache
        # `bound_pods`/`podgroups`/`nodes`: informer-maintained views
        # (GangScheduler keeps them from watch events). Without them every
        # snapshot clones the full store — including the terminal-pod
        # population that accumulates until TTL cleanup.
        node_iter = nodes if nodes is not None else api.list("Node")
        self.nodes: Dict[str, Node] = {n.name: n for n in node_iter}
        # NotReady nodes (lapsed heartbeat; see controllers/nodelifecycle)
        # contribute NO free capacity, same as cordoned ones: a dead TPU
        # host must be absent from every new placement, so a gang re-solve
        # routes around it (whole-slice migration when the loss breaks ICI
        # contiguity of the remaining hosts).
        self.free: Dict[str, Dict[str, float]] = {
            name: dict(n.capacity)
            for name, n in self.nodes.items()
            if not n.unschedulable and node_ready(n)
        }
        self._podgroups = list(podgroups) if podgroups is not None else api.list("PodGroup")
        bound = self._subtract_bound_pods(bound_pods)
        self._subtract_admitted_reservations(bound)
        self.slices = self._build_slices()

    # -- construction ------------------------------------------------------

    def _subtract_bound_pods(self, bound_pods: Optional[Iterable]) -> set:
        bound = set()
        pods = bound_pods if bound_pods is not None else self.api.list("Pod")
        for pod in pods:
            if not pod.node_name or pod.is_terminal():
                continue
            bound.add((pod.namespace, pod.name))
            avail = self.free.get(pod.node_name)
            if avail is None:
                continue
            for k, v in pod.resources().items():
                avail[k] = avail.get(k, 0.0) - v
        return bound

    def _pod_requests_for(self, pg: PodGroup) -> Dict[str, Dict[str, float]]:
        if self._requests_cache is not None:
            # Version-probe fast path: skip the owner GET (a clone under
            # copy-on-read) when the cached expansion is still current.
            kind = pg.metadata.labels.get("job-kind")
            rv = self.api.resource_version(kind, pg.namespace, pg.name) if kind else None
            hit = self._requests_cache.get(pg.metadata.uid)
            if hit is not None and rv is not None and hit[0] == rv:
                return hit[1]
            job = resolve_owner_job(self.api, pg)
            if job is None:
                return {}
            per_pod = job_pod_requests(job)
            self._requests_cache[pg.metadata.uid] = (job.metadata.resource_version, per_pod)
            return per_pod
        job = resolve_owner_job(self.api, pg)
        return job_pod_requests(job) if job is not None else {}

    def _subtract_admitted_reservations(self, bound: set) -> None:
        for pg in self._podgroups:
            if pg.phase not in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING):
                continue
            if not pg.placement:
                continue
            per_pod = self._pod_requests_for(pg)
            for pod_name, node_name in pg.placement.items():
                if (pg.namespace, pod_name) in bound:
                    continue  # already accounted as a bound pod
                avail = self.free.get(node_name)
                if avail is None:
                    continue
                for k, v in per_pod.get(pod_name, {}).items():
                    avail[k] = avail.get(k, 0.0) - v
            # Whole-slice dedication: reserved nodes without a placed pod
            # hold their full accelerator capacity for this gang.
            placed_nodes = set(pg.placement.values())
            for node_name in pg.reserved_nodes:
                if node_name in placed_nodes:
                    continue
                node = self.nodes.get(node_name)
                avail = self.free.get(node_name)
                if node is None or avail is None:
                    continue
                chips = node.capacity.get(TPU_RESOURCE, 0.0)
                if chips:
                    avail[TPU_RESOURCE] = avail.get(TPU_RESOURCE, 0.0) - chips

    def _build_slices(self) -> Dict[str, SliceInfo]:
        by_slice: Dict[str, List[Node]] = {}
        for node in self.nodes.values():
            acc = node.accelerator
            if acc.kind == "tpu" and acc.tpu_slice:
                by_slice.setdefault(acc.tpu_slice, []).append(node)
        slices: Dict[str, SliceInfo] = {}
        for sid, members in by_slice.items():
            members.sort(key=lambda n: _host_index(n))
            first = members[0].accelerator
            slices[sid] = SliceInfo(
                slice_id=sid,
                tpu_type=first.tpu_type,
                topology=first.slice_topology,
                chips_per_host=first.chips,
                host_nodes=[n.name for n in members],
            )
        return slices

    # -- queries -----------------------------------------------------------

    def host_free(self, node_name: str, chips: float) -> bool:
        """A TPU host is usable by a gang only if its full chip block is free
        (gang pods own whole hosts; fractional-host TPU pods are not a thing
        on multi-host slices)."""
        avail = self.free.get(node_name)
        return avail is not None and avail.get(TPU_RESOURCE, 0.0) >= chips

    def fits(self, node_name: str, req: Dict[str, float]) -> bool:
        avail = self.free.get(node_name)
        if avail is None:
            return False
        return all(avail.get(k, 0.0) >= v for k, v in req.items())

    def tolerated(self, node_name: str, tolerations) -> bool:
        """Taint gate (k8s semantics; see objects.tolerates)."""
        node = self.nodes.get(node_name)
        if node is None or not node.taints:
            return True
        return tolerates(node.taints, tolerations)

    def commit(self, req: Dict[str, float], node_name: str) -> None:
        """Consume capacity inside a solve so later gangs in the same batch
        see it taken."""
        avail = self.free.get(node_name)
        if avail is None:
            return
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) - v


class _CowFree:
    """Read-through free-capacity mapping: overlay (per-node dicts copied on
    first commit) over the maintainer's long-lived base. The solve mutates
    its working snapshot via `commit()`; the base only ever changes through
    watch-event deltas — so one cycle's speculative commits can never leak
    into the next cycle's view."""

    __slots__ = ("_base", "_overlay")

    def __init__(self, base: Dict[str, Dict[str, float]],
                 overlay: Dict[str, Dict[str, float]]):
        self._base = base
        self._overlay = overlay

    def __getitem__(self, node: str) -> Dict[str, float]:
        got = self._overlay.get(node)
        if got is not None:
            return got
        return self._base[node]

    def get(self, node: str, default=None):
        got = self._overlay.get(node)
        if got is not None:
            return got
        return self._base.get(node, default)

    def __contains__(self, node: str) -> bool:
        return node in self._base

    def __iter__(self):
        return iter(self._base)

    def __len__(self) -> int:
        return len(self._base)

    def keys(self):
        return self._base.keys()

    def values(self):
        return (self.get(n) for n in self._base)

    def items(self):
        return ((n, self.get(n)) for n in self._base)


class IncrementalSnapshot(ClusterSnapshot):
    """A ClusterSnapshot served from the SnapshotMaintainer's live state in
    O(1) instead of a full store walk. `nodes`/`slices` are shared references
    (read-only by the CL002 discipline); `free` is copy-on-write so in-cycle
    `commit()`s stay private to this snapshot."""

    def __init__(self, api: APIServer, nodes, base_free, slices,
                 pod_requests_cache=None):
        self.api = api
        self._requests_cache = pod_requests_cache
        self.nodes = nodes
        self.slices = slices
        self._base_free = base_free
        self._overlay: Dict[str, Dict[str, float]] = {}
        self.free = _CowFree(base_free, self._overlay)

    def commit(self, req: Dict[str, float], node_name: str) -> None:
        avail = self._overlay.get(node_name)
        if avail is None:
            base = self._base_free.get(node_name)
            if base is None:
                return
            avail = self._overlay[node_name] = dict(base)
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) - v


def prime_scheduler_caches(api: APIServer):
    """The gang scheduler's one legal full walk: the informer prime at
    construction (pods, podgroups, nodes), served from snapshot.py so
    scheduler/ stays free of store walks outside this module (codelint
    CL007 — the seam that keeps the solve cycle O(changed))."""
    return api.list("Pod"), api.list("PodGroup"), api.list("Node")


class SnapshotMaintainer:
    """Label-indexed incremental ClusterSnapshot: the free-capacity /
    host-index structures as a long-lived view updated from the watch event
    stream, instead of a per-cycle full store walk.

    Accounting invariant (identical to the cold ClusterSnapshot build):

        free[n] = capacity[n]
                  - sum(resources of bound non-terminal pods on n)
                  - sum(per-pod requests of admitted placements onto n whose
                        pod is not yet bound)
                  - full chip blocks of reserved_nodes without a placed pod

    maintained by delta under pod bind/terminal/delete, node ready/taint/
    cordon/add/delete, and PodGroup placement transitions. `selfcheck()`
    compares against a from-scratch rebuild (the parity oracle behind the
    `snapshot_selfcheck_every` knob) and adopts the rebuild on mismatch.
    """

    def __init__(self, api: APIServer, pod_requests_cache=None):
        self.api = api
        self._requests_cache = (
            pod_requests_cache if pod_requests_cache is not None else {}
        )
        self.nodes: Dict[str, Node] = {}
        self.free: Dict[str, Dict[str, float]] = {}
        self.slices: Dict[str, SliceInfo] = {}
        # Indexes that make per-event deltas and per-node recomputes cheap:
        #   _bound:        (ns, pod) -> (node, resources) for bound active pods
        #   _pods_by_node: node -> {(ns, pod): resources}
        #   _res_claims:   (pg uid, tag) -> (node, req); tag is the pod name
        #                  for placement reservations, ("#slice", node) for
        #                  whole-slice holds
        #   _res_by_node:  node -> {(uid, tag): req}
        #   _group_place:  pg uid -> (namespace, placement dict, per-pod reqs,
        #                  reserved nodes) of the version last applied
        self._bound: Dict[Tuple[str, str], Tuple[str, Dict[str, float]]] = {}
        self._pods_by_node: Dict[str, Dict[Tuple[str, str], Dict[str, float]]] = {}
        self._res_claims: Dict[Tuple[str, object], Tuple[str, Dict[str, float]]] = {}
        self._res_by_node: Dict[str, Dict[Tuple[str, object], Dict[str, float]]] = {}
        self._group_place: Dict[str, Tuple[str, Dict[str, str], Dict[str, Dict[str, float]], Tuple[str, ...]]] = {}
        # (ns, pod name) -> pg uid for placed pods, so a bind/unbind event
        # finds the reservation it toggles without scanning every group.
        self._placed_index: Dict[Tuple[str, str], str] = {}
        self._slice_members: Dict[str, Dict[str, Node]] = {}
        # Monotonic inventory generation: bumped by any STRUCTURAL node
        # change (membership, capacity, taints, labels, accelerator,
        # schedulability) — the signature the packer keys its candidate
        # tensors and generic-pool indexes on, so steady-state cycles skip
        # signature recomputation entirely. Heartbeat-only writes do not
        # bump it. Values come from a PROCESS-WIDE counter (not a local
        # +=1): a packer handed snapshots from two different maintainers
        # (tests, A/B benches) must never see two clusters collide on the
        # same generation value.
        self.inventory_gen = next(_inventory_gen_source)
        # Label-indexed free-host tallies for TPU slice hosts, maintained
        # with the free map: the per-cycle trace/fleet "free hosts / whole
        # free slices" numbers become O(changed this cycle), not a walk.
        self._host_full_free: Dict[str, bool] = {}
        self._slice_free_counts: Dict[str, int] = {}
        self._whole_free_ids: set = set()
        self.free_tpu_hosts = 0
        self.whole_free_slices = 0
        self.rebuilds = 0
        self.selfcheck_mismatches = 0

    # -- free-map deltas ---------------------------------------------------

    def _sub(self, node: str, req: Dict[str, float]) -> None:
        avail = self.free.get(node)
        if avail is None:
            return
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) - v
        if TPU_RESOURCE in req:
            self._update_host_flag(node)

    def _add(self, node: str, req: Dict[str, float]) -> None:
        avail = self.free.get(node)
        if avail is None:
            return
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) + v
        if TPU_RESOURCE in req:
            self._update_host_flag(node)

    def _update_host_flag(self, node: str) -> None:
        """Refresh one TPU host's full-block-free flag and the slice/fleet
        tallies derived from it (schedulable + whole chip block free)."""
        n = self.nodes.get(node)
        if n is None or n.accelerator.kind != "tpu" or not n.accelerator.tpu_slice:
            return
        avail = self.free.get(node)
        chips = n.accelerator.chips
        now_free = (
            avail is not None and avail.get(TPU_RESOURCE, 0.0) >= chips > 0
        )
        was_free = self._host_full_free.get(node, False)
        if now_free == was_free:
            return
        self._host_full_free[node] = now_free
        self.free_tpu_hosts += 1 if now_free else -1
        sid = n.accelerator.tpu_slice
        self._slice_free_counts[sid] = (
            self._slice_free_counts.get(sid, 0) + (1 if now_free else -1)
        )
        self._set_whole_free(sid)

    def _set_whole_free(self, sid: str) -> None:
        sl = self.slices.get(sid)
        whole = (
            sl is not None
            and sl.num_hosts > 0
            and self._slice_free_counts.get(sid, 0) == sl.num_hosts
        )
        if whole and sid not in self._whole_free_ids:
            self._whole_free_ids.add(sid)
            self.whole_free_slices += 1
        elif not whole and sid in self._whole_free_ids:
            self._whole_free_ids.discard(sid)
            self.whole_free_slices -= 1

    def _refresh_slice_tally(self, sid: str) -> None:
        """Re-derive one slice's free-host count from member flags after a
        membership change (node add/delete/move)."""
        members = self._slice_members.get(sid, {})
        self._slice_free_counts[sid] = sum(
            1 for n in members if self._host_full_free.get(n, False)
        )
        self._set_whole_free(sid)
        if not members:
            self._slice_free_counts.pop(sid, None)

    # -- reservations ------------------------------------------------------

    def _claim(self, uid: str, tag: object, node: str,
               req: Dict[str, float], active: bool) -> None:
        self._res_claims[(uid, tag)] = (node, req)
        self._res_by_node.setdefault(node, {})[(uid, tag)] = req
        if active:
            self._sub(node, req)

    def _release(self, uid: str, tag: object, active: bool) -> None:
        got = self._res_claims.pop((uid, tag), None)
        if got is None:
            return
        node, req = got
        per_node = self._res_by_node.get(node)
        if per_node is not None:
            per_node.pop((uid, tag), None)
            if not per_node:
                self._res_by_node.pop(node, None)
        if active:
            self._add(node, req)

    def _reservation_active(self, ns: str, tag: object) -> bool:
        """A placement reservation counts only while its pod is not bound;
        whole-slice holds always count (mirrors the cold snapshot's `bound`
        exclusion set)."""
        if isinstance(tag, tuple):  # ("#slice", node)
            return True
        return (ns, tag) not in self._bound

    def _apply_group(self, pg: PodGroup) -> None:
        """Diff one PodGroup's reservation contribution against what was
        last applied for its uid, and apply the delta."""
        uid = pg.metadata.uid
        admitted = pg.phase in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING)
        want_place: Dict[str, str] = dict(pg.placement) if admitted else {}
        per_pod: Dict[str, Dict[str, float]] = {}
        if want_place:
            per_pod = self._pod_requests_for(pg)
        placed_nodes = set(want_place.values())
        want_reserved: Tuple[str, ...] = tuple(
            n for n in pg.reserved_nodes if n not in placed_nodes
        ) if admitted and pg.placement else ()

        old = self._group_place.get(uid)
        if old is not None:
            old_ns, old_place, old_reqs, old_reserved = old
            for pod_name in old_place:
                if want_place.get(pod_name) != old_place[pod_name] or \
                        per_pod.get(pod_name) != old_reqs.get(pod_name):
                    self._release(
                        uid, pod_name,
                        self._reservation_active(old_ns, pod_name),
                    )
            for node in old_reserved:
                if node not in want_reserved:
                    self._release(uid, ("#slice", node), True)
        if not want_place and not want_reserved:
            self._group_place.pop(uid, None)
            for pod_name in (old[1] if old else ()):
                self._placed_index.pop((old[0], pod_name), None)
            return

        ns = pg.namespace
        for pod_name, node in want_place.items():
            self._placed_index[(ns, pod_name)] = uid
            if (uid, pod_name) in self._res_claims:
                continue  # unchanged (survived the diff above)
            req = per_pod.get(pod_name, {})
            self._claim(uid, pod_name, node, req,
                        self._reservation_active(ns, pod_name))
        for node in want_reserved:
            if (uid, ("#slice", node)) in self._res_claims:
                continue
            n = self.nodes.get(node)
            chips = n.capacity.get(TPU_RESOURCE, 0.0) if n is not None else 0.0
            if chips:
                self._claim(uid, ("#slice", node), node,
                            {TPU_RESOURCE: chips}, True)
        if old is not None:
            for pod_name in old[1]:
                if pod_name not in want_place:
                    self._placed_index.pop((old[0], pod_name), None)
        self._group_place[uid] = (ns, want_place, per_pod, want_reserved)

    def _drop_group(self, pg: PodGroup) -> None:
        uid = pg.metadata.uid
        old = self._group_place.pop(uid, None)
        if old is None:
            return
        old_ns, old_place, _old_reqs, old_reserved = old
        for pod_name in old_place:
            self._release(uid, pod_name,
                          self._reservation_active(old_ns, pod_name))
            self._placed_index.pop((old_ns, pod_name), None)
        for node in old_reserved:
            self._release(uid, ("#slice", node), True)

    def _pod_requests_for(self, pg: PodGroup) -> Dict[str, Dict[str, float]]:
        kind = pg.metadata.labels.get("job-kind")
        rv = self.api.resource_version(kind, pg.namespace, pg.name) if kind else None
        hit = self._requests_cache.get(pg.metadata.uid)
        if hit is not None and rv is not None and hit[0] == rv:
            return hit[1]
        job = resolve_owner_job(self.api, pg)
        if job is None:
            return {}
        per_pod = job_pod_requests(job)
        self._requests_cache[pg.metadata.uid] = (job.metadata.resource_version, per_pod)
        return per_pod

    # -- pod / node deltas -------------------------------------------------

    def _observe_pod(self, ev_type: str, pod) -> None:
        key = (pod.namespace, pod.name)
        new_bound = (
            ev_type != "Deleted" and pod.node_name and not pod.is_terminal()
        )
        old = self._bound.get(key)
        if old is not None and (not new_bound or old[0] != pod.node_name):
            node, res = old
            del self._bound[key]
            per_node = self._pods_by_node.get(node)
            if per_node is not None:
                per_node.pop(key, None)
                if not per_node:
                    self._pods_by_node.pop(node, None)
            self._add(node, res)
            self._toggle_reservation(key)
        if new_bound and key not in self._bound:
            res = pod.resources()
            self._bound[key] = (pod.node_name, res)
            self._pods_by_node.setdefault(pod.node_name, {})[key] = res
            self._sub(pod.node_name, res)
            self._toggle_reservation(key)

    def _toggle_reservation(self, key: Tuple[str, str]) -> None:
        """A pod flipped bound<->unbound: its group's placement reservation
        (if any) flips inactive<->active. Re-derive the claim's charge from
        the CURRENT bound state rather than tracking a bit per claim."""
        uid = self._placed_index.get(key)
        if uid is None:
            return
        got = self._res_claims.get((uid, key[1]))
        if got is None:
            return
        node, req = got
        if key in self._bound:
            self._add(node, req)  # reservation superseded by the bound pod
        else:
            self._sub(node, req)  # pod gone; the slot is held again

    def _recompute_node(self, name: str) -> None:
        node = self.nodes.get(name)
        if node is None or node.unschedulable or not node_ready(node):
            self.free.pop(name, None)
            if node is not None:
                self._update_host_flag(name)
            return
        avail = dict(node.capacity)
        for key, res in self._pods_by_node.get(name, {}).items():
            for k, v in res.items():
                avail[k] = avail.get(k, 0.0) - v
        for (uid, tag), req in self._res_by_node.get(name, {}).items():
            ns = self._group_place.get(uid, ("",))[0]
            if self._reservation_active(ns, tag):
                for k, v in req.items():
                    avail[k] = avail.get(k, 0.0) - v
        self.free[name] = avail
        self._update_host_flag(name)

    def _rebuild_slice(self, sid: str) -> None:
        members = self._slice_members.get(sid)
        if not members:
            self._slice_members.pop(sid, None)
            self.slices.pop(sid, None)
            return
        ordered = sorted(members.values(), key=_host_index)
        first = ordered[0].accelerator
        self.slices[sid] = SliceInfo(
            slice_id=sid,
            tpu_type=first.tpu_type,
            topology=first.slice_topology,
            chips_per_host=first.chips,
            host_nodes=[n.name for n in ordered],
        )

    def _observe_node(self, ev_type: str, node: Node) -> None:
        name = node.metadata.name
        old = self.nodes.get(name)
        old_sid = old.accelerator.tpu_slice if (
            old is not None and old.accelerator.kind == "tpu"
        ) else None
        if ev_type == "Deleted":
            self.inventory_gen = next(_inventory_gen_source)
            self.nodes.pop(name, None)
            self.free.pop(name, None)
            if self._host_full_free.pop(name, False):
                self.free_tpu_hosts -= 1
            if old_sid:
                self._slice_members.get(old_sid, {}).pop(name, None)
                self._rebuild_slice(old_sid)
                self._refresh_slice_tally(old_sid)
            return
        if (
            old is None
            or old.unschedulable != node.unschedulable
            or node_ready(old) != node_ready(node)
            or old.capacity != node.capacity
            or old.taints != node.taints
            or old.accelerator != node.accelerator
            or old.metadata.labels != node.metadata.labels
        ):
            self.inventory_gen = next(_inventory_gen_source)
        self.nodes[name] = node
        # Heartbeat writes modify conditions every few seconds per node; only
        # transitions that change SCHEDULABILITY or capacity touch the free
        # map, and only accelerator/index changes touch the slice index — a
        # 10k-node fleet's steady heartbeat stream must cost ~nothing here.
        if (
            old is None
            or old.unschedulable != node.unschedulable
            or node_ready(old) != node_ready(node)
            or old.capacity != node.capacity
        ):
            self._recompute_node(name)
        sid = node.accelerator.tpu_slice if node.accelerator.kind == "tpu" else None
        if old_sid and old_sid != sid:
            self._slice_members.get(old_sid, {}).pop(name, None)
            self._rebuild_slice(old_sid)
            self._refresh_slice_tally(old_sid)
        if sid:
            self._slice_members.setdefault(sid, {})[name] = node
            if (
                old is None
                or old_sid != sid
                or old.accelerator != node.accelerator
                or old.metadata.labels != node.metadata.labels
            ):
                self._rebuild_slice(sid)
                self._update_host_flag(name)
                self._refresh_slice_tally(sid)

    # -- public surface ----------------------------------------------------

    def observe(self, ev) -> None:
        """Apply one watch event. Only Pod/PodGroup/Node events touch the
        view; everything else is free."""
        kind = ev.kind
        if kind == "Pod":
            self._observe_pod(ev.type, ev.obj)
        elif kind == "PodGroup":
            if ev.type == "Deleted":
                self._drop_group(ev.obj)
            else:
                self._apply_group(ev.obj)
        elif kind == "Node":
            self._observe_node(ev.type, ev.obj)

    def snapshot(self) -> IncrementalSnapshot:
        snap = IncrementalSnapshot(
            self.api, self.nodes, self.free, self.slices,
            pod_requests_cache=self._requests_cache,
        )
        snap.inventory_gen = self.inventory_gen
        snap.host_full_free = self._host_full_free
        return snap

    def free_host_stats(
        self, overlay: Dict[str, Dict[str, float]]
    ) -> Tuple[int, int]:
        """(free TPU hosts, whole-free slices) with one working snapshot's
        copy-on-write overlay applied on top of the maintained tallies —
        the post-admission trace numbers in O(committed this cycle)."""
        free_hosts = self.free_tpu_hosts
        touched: Dict[str, int] = {}
        for node, avail in overlay.items():
            n = self.nodes.get(node)
            if n is None or n.accelerator.kind != "tpu" or not n.accelerator.tpu_slice:
                continue
            was = self._host_full_free.get(node, False)
            now = avail.get(TPU_RESOURCE, 0.0) >= n.accelerator.chips > 0
            if was != now:
                d = 1 if now else -1
                free_hosts += d
                sid = n.accelerator.tpu_slice
                touched[sid] = touched.get(sid, 0) + d
        whole = self.whole_free_slices
        for sid, delta in touched.items():
            sl = self.slices.get(sid)
            if sl is None or not sl.num_hosts:
                continue
            base = self._slice_free_counts.get(sid, 0)
            if (base == sl.num_hosts) and (base + delta != sl.num_hosts):
                whole -= 1
            elif (base != sl.num_hosts) and (base + delta == sl.num_hosts):
                whole += 1
        return free_hosts, whole

    def rebuild(self) -> None:
        """From-scratch reconstruction (the one full walk this module owns):
        the initial prime, and the recovery arm when a self-check disagrees."""
        from training_operator_tpu_torch.utils import metrics

        self.rebuilds += 1
        self.inventory_gen = next(_inventory_gen_source)
        metrics.solver_snapshot_rebuilds.inc()
        cold = ClusterSnapshot(self.api, self._requests_cache)
        self.nodes = cold.nodes
        self.free = cold.free
        self.slices = cold.slices
        self._bound.clear()
        self._pods_by_node.clear()
        self._res_claims.clear()
        self._res_by_node.clear()
        self._group_place.clear()
        self._placed_index.clear()
        self._slice_members = {
            sid: {
                n: self.nodes[n]
                for n in sl.host_nodes
                if n in self.nodes
            }
            for sid, sl in self.slices.items()
        }
        self._host_full_free = {}
        self._slice_free_counts = {}
        self._whole_free_ids = set()
        self.free_tpu_hosts = 0
        self.whole_free_slices = 0
        for sid, members in self._slice_members.items():
            cnt = 0
            for n, node in members.items():
                avail = self.free.get(n)
                chips = node.accelerator.chips
                f = (
                    avail is not None
                    and avail.get(TPU_RESOURCE, 0.0) >= chips > 0
                )
                self._host_full_free[n] = f
                if f:
                    cnt += 1
                    self.free_tpu_hosts += 1
            self._slice_free_counts[sid] = cnt
            sl = self.slices.get(sid)
            if sl is not None and sl.num_hosts and cnt == sl.num_hosts:
                self._whole_free_ids.add(sid)
                self.whole_free_slices += 1
        # Re-derive the indexes WITHOUT touching self.free (cold already
        # accounted everything): record bound pods and reservation claims.
        for pod in self.api.list("Pod"):
            if pod.node_name and not pod.is_terminal():
                key = (pod.namespace, pod.name)
                res = pod.resources()
                self._bound[key] = (pod.node_name, res)
                self._pods_by_node.setdefault(pod.node_name, {})[key] = res
        for pg in self.api.list("PodGroup"):
            if pg.phase not in (PodGroupPhase.INQUEUE, PodGroupPhase.RUNNING):
                continue
            if not pg.placement:
                continue
            uid = pg.metadata.uid
            ns = pg.namespace
            per_pod = self._pod_requests_for(pg)
            placed_nodes = set(pg.placement.values())
            reserved = tuple(
                n for n in pg.reserved_nodes if n not in placed_nodes
            )
            for pod_name, node in pg.placement.items():
                self._placed_index[(ns, pod_name)] = uid
                req = per_pod.get(pod_name, {})
                self._res_claims[(uid, pod_name)] = (node, req)
                self._res_by_node.setdefault(node, {})[(uid, pod_name)] = req
            for node in reserved:
                n = self.nodes.get(node)
                chips = n.capacity.get(TPU_RESOURCE, 0.0) if n is not None else 0.0
                if chips:
                    self._res_claims[(uid, ("#slice", node))] = (
                        node, {TPU_RESOURCE: chips}
                    )
                    self._res_by_node.setdefault(node, {})[
                        (uid, ("#slice", node))
                    ] = {TPU_RESOURCE: chips}
            self._group_place[uid] = (ns, dict(pg.placement), per_pod, reserved)

    def selfcheck(self, tol: float = 1e-9) -> List[str]:
        """Compare the incremental view against a from-scratch rebuild.
        Returns a list of human-readable mismatches (empty = parity); on
        mismatch the rebuilt state is adopted so one missed delta cannot
        compound forever."""
        cold = ClusterSnapshot(self.api, dict(self._requests_cache))
        problems: List[str] = []
        if set(cold.nodes) != set(self.nodes):
            problems.append(
                f"node set: incremental {sorted(set(self.nodes) - set(cold.nodes))} "
                f"extra, {sorted(set(cold.nodes) - set(self.nodes))} missing"
            )
        if set(cold.free) != set(self.free):
            problems.append(
                f"schedulable set: incremental-only "
                f"{sorted(set(self.free) - set(cold.free))}, cold-only "
                f"{sorted(set(cold.free) - set(self.free))}"
            )
        for n in set(cold.free) & set(self.free):
            a, b = cold.free[n], self.free[n]
            for k in set(a) | set(b):
                if abs(a.get(k, 0.0) - b.get(k, 0.0)) > tol:
                    problems.append(
                        f"free[{n}][{k}]: cold {a.get(k, 0.0)} != "
                        f"incremental {b.get(k, 0.0)}"
                    )
        if cold.slices != self.slices:
            problems.append("slice index diverged")
        cold_free_hosts = 0
        cold_whole = 0
        for sl in cold.slices.values():
            cnt = sum(
                1 for n in sl.host_nodes
                if (a := cold.free.get(n)) is not None
                and a.get(TPU_RESOURCE, 0.0) >= sl.chips_per_host > 0
            )
            cold_free_hosts += cnt
            if sl.num_hosts and cnt == sl.num_hosts:
                cold_whole += 1
        if (cold_free_hosts, cold_whole) != (
            self.free_tpu_hosts, self.whole_free_slices
        ):
            problems.append(
                f"free-host tallies: cold ({cold_free_hosts}, {cold_whole}) "
                f"!= incremental ({self.free_tpu_hosts}, "
                f"{self.whole_free_slices})"
            )
        if problems:
            self.selfcheck_mismatches += 1
            self.rebuild()
        return problems


def _host_index(node: Node) -> int:
    from training_operator_tpu_torch.cluster.inventory import LABEL_TPU_HOST_INDEX

    try:
        return int(node.metadata.labels.get(LABEL_TPU_HOST_INDEX, "0"))
    except ValueError:
        return 0


def host_index(node: Node) -> int:
    """Public spelling of the slice host index (the node's position along
    the slice's host axis) — placement introspection (the fleet auditor's
    INV002 contiguity check) must read the SAME index the packer placed by,
    or audit and placement could disagree about what contiguous means."""
    return _host_index(node)


def contiguous_host_block(indices) -> bool:
    """True when the host indices form one gapless run — the only shape a
    sub-slice placement can take on an ICI mesh (hosts own contiguous chip
    blocks along the minor axis, so a gap in host indices is a hole in the
    chip grid). The auditor checks admitted placements against this; the
    packer allocates by it."""
    s = sorted(set(int(i) for i in indices))
    return not s or s[-1] - s[0] + 1 == len(s)


def resolve_owner_job(api: APIServer, pg: PodGroup) -> Optional[Job]:
    """PodGroups are named after and owned by their job; `job-kind` label says
    which kind to fetch (set by PodGroupControl.create_podgroup)."""
    kind = pg.metadata.labels.get("job-kind")
    if not kind:
        return None
    return api.try_get(kind, pg.namespace, pg.name)


def job_pod_requests(job: Job) -> Dict[str, Dict[str, float]]:
    """Per-pod resource requests keyed by the pod name the engine will use."""
    out: Dict[str, Dict[str, float]] = {}
    for rtype, spec in job.replica_specs.items():
        per_pod = spec.template.resources()
        for i in range(spec.replicas or 0):
            out[gen_general_name(job.name, rtype, i)] = dict(per_pod)
    return out


def build_gang_request(api: APIServer, pg: PodGroup) -> Optional[GangRequest]:
    """Expand a PodGroup to a GangRequest. Returns None if the owning job is
    gone (group will be GC'd by the cascade delete)."""
    job = resolve_owner_job(api, pg)
    if job is None:
        return None
    pods: List[PodRequest] = []
    # Gang tolerations = intersection across replica templates (see
    # GangRequest.tolerations): a toleration only counts if every member
    # pod carries it.
    tol_sets = []
    by_key: Dict[tuple, Dict[str, object]] = {}
    for rtype, spec in sorted(job.replica_specs.items()):
        if not (spec.replicas or 0):
            continue  # contributes no pods; must not strip the intersection
        keys = set()
        for t in spec.template.tolerations:
            k = toleration_key(t)
            keys.add(k)
            by_key[k] = dict(t)
        tol_sets.append(keys)
    common = set.intersection(*tol_sets) if tol_sets else set()
    gang_tolerations = [by_key[k] for k in sorted(common)]
    for rtype, spec in sorted(job.replica_specs.items()):
        per_pod = spec.template.resources()
        tols = [dict(t) for t in spec.template.tolerations]
        for i in range(spec.replicas or 0):
            pods.append(
                PodRequest(
                    name=gen_general_name(job.name, rtype, i),
                    replica_type=rtype,
                    index=i,
                    resources=dict(per_pod),
                    tolerations=tols,
                )
            )
    topology = pg.topology_request
    tpu_type = ""
    if job.tpu_policy is not None:
        tpu_type = _accel_family(job.tpu_policy.accelerator)
        if topology is None:
            topology = job.tpu_policy.topology
    expected = None
    for rtype, spec in job.replica_specs.items():
        if not (spec.replicas or 0):
            continue
        raw = spec.template.annotations.get(ANNOTATION_EXPECTED_DURATION)
        if raw is None:
            continue
        try:
            val = float(raw)
        except ValueError:
            continue  # a malformed hint must not break admission
        if val > 0:
            expected = val if expected is None else max(expected, val)
    return GangRequest(
        group=pg,
        pods=pods,
        topology=topology,
        num_slices=max(1, pg.num_slices),
        tpu_type=tpu_type,
        tolerations=gang_tolerations,
        expected_duration=expected,
    )


def _accel_family(accelerator: str) -> str:
    from training_operator_tpu_torch.cluster.inventory import accel_family

    return accel_family(accelerator)


@lru_cache(maxsize=4096)
def topology_hosts_per_slice(topology: str, chips_per_host: int) -> int:
    """Whole hosts one slice's share of a `topology` chip ask occupies, -1
    when not host-aligned. Pure in its arguments and called once per
    (gang x slice) pair on hot paths — memoized so a 10k-node solve does
    not re-parse the same handful of topology strings millions of times."""
    chips = 1
    for d in parse_topology(topology):
        chips *= d
    if chips % chips_per_host:
        return -1  # request not host-aligned for this slice class
    return chips // chips_per_host


def request_hosts_per_slice(req: GangRequest, chips_per_host: int) -> int:
    """How many whole hosts one slice's share of the gang occupies."""
    if req.topology is None:
        return 0
    return topology_hosts_per_slice(req.topology, chips_per_host)
