"""The view the placer solves over: slices, free capacity, pending gangs.

Counterpart of training_operator_tpu/scheduler/snapshot.py: `SliceInfo`,
`PodRequest`, `GangRequest`, `Placement` with the same fields, the
free-capacity queries of `ClusterSnapshot` (`host_free`, `fits`,
`tolerated`, `commit`) and `topology_hosts_per_slice` /
`request_hosts_per_slice`.

The JAX snapshot is built from an API server (bound pods plus the
reservations of admitted PodGroups); this one from node records plus the
usage of admitted gangs, given as (resources, node name) pairs
(`gang_usage`). A gang's group is a `Group` record with the three fields the
placer reads: `metadata.creation_time`, `namespace` and `name`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

from training_operator_tpu_torch.scheduler.inventory import (
    TPU_RESOURCE,
    Node,
    node_ready,
    toleration_sig,
    tolerates,
    topology_chips,
)


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


@dataclass
class PodRequest:
    name: str
    replica_type: str
    index: int
    resources: Dict[str, float]
    tolerations: List[Dict[str, object]] = field(default_factory=list)


@dataclass
class GroupMeta:
    name: str
    namespace: str = "default"
    creation_time: float = 0.0


@dataclass
class Group:
    """A pending gang's group record: what the placer reads of a PodGroup."""

    metadata: GroupMeta

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class GangRequest:
    """A pending gang expanded to the granularity the solver needs."""

    group: Group
    pods: List[PodRequest]
    # TPU gang: requested ICI topology per slice + slice count; None = generic.
    topology: Optional[str] = None
    num_slices: int = 1
    tpu_type: str = ""
    # The intersection of the members' tolerations: a TPU gang's pods are
    # zipped across a sub-mesh's hosts, so a host is usable only if every
    # member tolerates its taints.
    tolerations: List[Dict[str, object]] = field(default_factory=list)
    # Declared expected runtime in seconds, None when the job declares none.
    expected_duration: Optional[float] = None
    _sorted_pods: Optional[List[PodRequest]] = None
    _total_chips: Optional[float] = None
    # Memos the placer stamps, valid across cycles: (candidate-cache epoch,
    # class id or None) for TPU gangs, (pool-layout key, per-resource max
    # and total demand) for generic ones.
    _class_hint: Optional[Tuple] = None
    _generic_hint: Optional[Tuple] = None
    _key: Optional[str] = None

    def toleration_sig(self) -> Tuple:
        """Canonical hashable form: part of the solver's class identity."""
        return toleration_sig(self.tolerations)

    @property
    def key(self) -> str:
        k = self._key
        if k is None:
            k = self._key = f"{self.group.namespace}/{self.group.name}"
        return k

    def sorted_pods(self) -> List[PodRequest]:
        """Pods in (replica_type, index) order: the per-slice assignment order."""
        if self._sorted_pods is None:
            self._sorted_pods = sorted(self.pods, key=lambda p: (p.replica_type, p.index))
        return self._sorted_pods

    def total_chips(self) -> float:
        if self._total_chips is None:
            self._total_chips = sum(p.resources.get(TPU_RESOURCE, 0.0) for p in self.pods)
        return self._total_chips


@dataclass
class Placement:
    """Solver output for one gang: pod name -> node name, the score, the
    slices used and `reserved_nodes` (nodes held whole for the gang)."""

    assignments: Dict[str, str]
    score: float = 0.0
    slices_used: List[str] = field(default_factory=list)
    reserved_nodes: List[str] = field(default_factory=list)


def gang_usage(req: GangRequest, placement: Placement) -> List[Tuple[Dict[str, float], str]]:
    """What an admitted gang holds, as (resources, node) pairs: each pod's
    resources on its node."""
    return [(pod.resources, placement.assignments[pod.name]) for pod in req.pods
            if pod.name in placement.assignments]


class ClusterSnapshot:
    """Free capacity at solve time: every ready, schedulable node's capacity
    less `usage`, the (resources, node) pairs of admitted gangs
    (`gang_usage`), and the
    TPU slices of all nodes. `inventory_gen` names the structural inventory
    (membership, capacity, taints, accelerators, schedulability): the placer
    keeps its candidate tensors and pool indexes while it does not move, so
    a caller that changes any of those must pass a new one (None = check
    the inventory every cycle). `commit` takes capacity inside a solve so
    later gangs of the same batch see it taken."""

    def __init__(self, nodes: Iterable[Node],
                 usage: Iterable[Tuple[Dict[str, float], str]] = (),
                 inventory_gen: Optional[object] = None):
        self.nodes: Dict[str, Node] = {n.name: n for n in nodes}
        self.free: Dict[str, Dict[str, float]] = {
            name: dict(n.capacity)
            for name, n in self.nodes.items()
            if not n.unschedulable and node_ready(n)
        }
        for req, node_name in usage:
            self.commit(req, node_name)
        self.inventory_gen = inventory_gen
        self.slices = self._build_slices()

    def _build_slices(self) -> Dict[str, SliceInfo]:
        by_slice: Dict[str, List[Node]] = {}
        for node in self.nodes.values():
            acc = node.accelerator
            if acc.kind == "tpu" and acc.tpu_slice:
                by_slice.setdefault(acc.tpu_slice, []).append(node)
        slices: Dict[str, SliceInfo] = {}
        for sid, members in by_slice.items():
            members.sort(key=lambda n: n.accelerator.host_index)
            first = members[0].accelerator
            slices[sid] = SliceInfo(slice_id=sid, tpu_type=first.tpu_type,
                                    topology=first.slice_topology, chips_per_host=first.chips,
                                    host_nodes=[n.name for n in members])
        return slices

    def host_free(self, node_name: str, chips: float) -> bool:
        """A TPU host is usable by a gang only if its full chip block is free."""
        avail = self.free.get(node_name)
        return avail is not None and avail.get(TPU_RESOURCE, 0.0) >= chips

    def fits(self, node_name: str, req: Dict[str, float]) -> bool:
        avail = self.free.get(node_name)
        if avail is None:
            return False
        return all(avail.get(k, 0.0) >= v for k, v in req.items())

    def tolerated(self, node_name: str, tolerations) -> bool:
        node = self.nodes.get(node_name)
        if node is None or not node.taints:
            return True
        return tolerates(node.taints, tolerations)

    def commit(self, req: Dict[str, float], node_name: str) -> None:
        avail = self.free.get(node_name)
        if avail is None:
            return
        for k, v in req.items():
            avail[k] = avail.get(k, 0.0) - v


@lru_cache(maxsize=4096)
def topology_hosts_per_slice(topology: str, chips_per_host: int) -> int:
    """Whole hosts one slice's share of a `topology` chip ask occupies, -1
    when not host-aligned."""
    chips = topology_chips(topology)
    if chips % chips_per_host:
        return -1
    return chips // chips_per_host


def request_hosts_per_slice(req: GangRequest, chips_per_host: int) -> int:
    """How many whole hosts one slice's share of the gang occupies."""
    if req.topology is None:
        return 0
    return topology_hosts_per_slice(req.topology, chips_per_host)
