"""Substrate object model: Pod, Service, Node, PodGroup, ConfigMap, Event.

These mirror the Kubernetes objects the reference's engine manipulates
(pods/services via pkg/controller.v1/control, PodGroups via
control/podgroup_control.go, ConfigMaps in the MPI controller), reduced to the
fields the reconcile engine and placement engine actually consume.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from training_operator_tpu_torch.api.common import PodTemplateSpec, RestartPolicy
from training_operator_tpu_torch.api.jobs import ObjectMeta


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class ContainerStatus:
    name: str
    restart_count: int = 0
    exit_code: Optional[int] = None
    running: bool = False


@dataclass
class PodStatus:
    phase: PodPhase = PodPhase.PENDING
    container_statuses: List[ContainerStatus] = field(default_factory=list)
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    scheduled_time: Optional[float] = None
    message: str = ""

    def restart_count(self) -> int:
        return sum(cs.restart_count for cs in self.container_statuses)

    def exit_code(self, container: str) -> Optional[int]:
        for cs in self.container_statuses:
            if cs.name == container:
                return cs.exit_code
        return None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    status: PodStatus = field(default_factory=PodStatus)
    node_name: str = ""  # set by a scheduler binding

    KIND = "Pod"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def is_terminal(self) -> bool:
        return self.status.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)

    def resources(self) -> Dict[str, float]:
        # Memoized: pod resource requests are immutable after creation (k8s
        # semantics), and the placement snapshot sums them for every bound
        # pod on every scheduling cycle.
        memo = self.__dict__.get("_resources_memo")
        if memo is None:
            memo = self.spec.resources()
            self.__dict__["_resources_memo"] = memo
        return memo

    def __deepcopy__(self, memo):
        # Copies (API-server clones, watch snapshots, templates) must not
        # inherit the resources() memo: a template-derived pod may mutate
        # container resources before create, and a stale total would leak
        # into scheduler capacity accounting.
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k == "_resources_memo":
                continue
            new.__dict__[k] = copy.deepcopy(v, memo)
        return new

    def effective_restart_policy(self) -> RestartPolicy:
        return self.spec.restart_policy or RestartPolicy.ON_FAILURE


@dataclass
class Service:
    """Headless service: one per replica, named <job>-<type>-<index>, giving the
    stable DNS identity used for rendezvous (reference pkg/core/service.go)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)
    ports: Dict[str, int] = field(default_factory=dict)

    KIND = "Service"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def dns_name(self, cluster_domain: str = "cluster.local") -> str:
        return f"{self.metadata.name}.{self.metadata.namespace}.svc.{cluster_domain}"


@dataclass
class AcceleratorInfo:
    """Physical accelerator topology of a node.

    TPU nodes: `tpu_slice` names the slice this node's chips belong to;
    `ici_coords` gives the node's position in the slice's chip grid as the
    coordinates of its first chip; `chips` counts chips on this node.
    GPU nodes: `nvlink_domain` identifies the NVLink island.
    """

    kind: str = ""  # "tpu" | "gpu" | ""
    chips: int = 0
    tpu_type: str = ""  # e.g. "v5e"
    tpu_slice: str = ""  # slice id, e.g. "slice-0"
    slice_topology: str = ""  # full slice chip grid, e.g. "4x4"
    ici_coords: Optional[List[int]] = None  # node origin within slice grid
    nvlink_domain: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# Node-lifecycle constants (the kube-node-lease / taint-manager analogue):
# heartbeat Leases live in their own namespace, keyed by node name; a node
# whose heartbeat lapses gets Ready=False plus the NoExecute unreachable
# taint (reference: node.kubernetes.io/unreachable via the k8s node
# lifecycle controller), which evicts pods after their toleration window.
NODE_LEASE_NAMESPACE = "node-leases"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
NODE_CONDITION_READY = "Ready"


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: Dict[str, float] = field(default_factory=dict)
    accelerator: AcceleratorInfo = field(default_factory=AcceleratorInfo)
    unschedulable: bool = False
    # Taints, k8s-shaped dicts: {"key", "value", "effect"} with effect
    # "NoSchedule" | "NoExecute" | "PreferNoSchedule". Placement (default
    # scheduler, gang placers) refuses NoSchedule/NoExecute taints a pod's
    # tolerations don't cover.
    taints: List[Dict[str, Any]] = field(default_factory=list)
    # Node conditions, k8s-shaped dicts: {"type", "status" ("True"/"False"/
    # "Unknown"), "reason", "message", "last_transition_time"}. Written by
    # the node lifecycle controller from heartbeat observations; a node
    # with NO Ready condition is treated as Ready (static inventory records
    # predate the heartbeat machinery and must stay schedulable).
    conditions: List[Dict[str, Any]] = field(default_factory=list)

    KIND = "Node"

    @property
    def name(self) -> str:
        return self.metadata.name

    def allocatable(self) -> Dict[str, float]:
        return dict(self.capacity)

    def matches_selector(self, selector: Dict[str, str]) -> bool:
        return all(self.metadata.labels.get(k) == v for k, v in selector.items())


def get_node_condition(node: Node, cond_type: str) -> Optional[Dict[str, Any]]:
    for c in node.conditions:
        if c.get("type") == cond_type:
            return c
    return None


def node_ready(node: Node) -> bool:
    """Ready unless an explicit Ready condition says otherwise — every
    placement surface (snapshot, default scheduler, gang binder) and the
    exec channel must agree on this one predicate."""
    cond = get_node_condition(node, NODE_CONDITION_READY)
    return cond is None or cond.get("status") == "True"


def set_node_condition(
    node: Node, cond_type: str, status: str, reason: str, message: str, now: float
) -> bool:
    """Set/replace one condition; returns True when the status actually
    transitioned (callers write + emit events only on transitions)."""
    cond = get_node_condition(node, cond_type)
    if cond is not None and cond.get("status") == status:
        return False
    fresh = {
        "type": cond_type,
        "status": status,
        "reason": reason,
        "message": message,
        "last_transition_time": now,
    }
    node.conditions = [c for c in node.conditions if c.get("type") != cond_type]
    node.conditions.append(fresh)
    return True


def has_taint(node: Node, key: str) -> bool:
    return any(t.get("key") == key for t in node.taints)


def add_taint(node: Node, key: str, effect: str = "NoExecute") -> bool:
    if has_taint(node, key):
        return False
    node.taints.append({"key": key, "effect": effect})
    return True


def remove_taint(node: Node, key: str) -> bool:
    before = len(node.taints)
    node.taints = [t for t in node.taints if t.get("key") != key]
    return len(node.taints) != before


def toleration_key(t: Dict[str, Any]) -> tuple:
    """Canonical hashable form of one toleration/taint dict — THE form used
    for dedup, cache signatures, and solver class identity (all three must
    agree or cache invalidation breaks)."""
    return tuple(sorted(t.items()))


def tolerates(taints: List[Dict[str, Any]], tolerations: List[Dict[str, Any]]) -> bool:
    """k8s taint/toleration matching: every NoSchedule/NoExecute taint must
    be covered by some toleration (Exists matches any value; Equal requires
    the value; empty toleration key + Exists tolerates everything; empty
    toleration effect matches all effects)."""

    def covered(taint: Dict[str, Any]) -> bool:
        for tol in tolerations:
            op = tol.get("operator", "Equal")
            if tol.get("effect") and tol.get("effect") != taint.get("effect"):
                continue
            if not tol.get("key"):
                if op == "Exists":
                    return True
                continue
            if tol.get("key") != taint.get("key"):
                continue
            if op == "Exists" or tol.get("value") == taint.get("value"):
                return True
        return False

    return all(
        covered(t)
        for t in taints
        if t.get("effect") in ("NoSchedule", "NoExecute")
    )


class PodGroupPhase(str, enum.Enum):
    """Gang-scheduling lifecycle, modeled on Volcano's PodGroup phases
    (reference control/podgroup_control.go:81 gates pod creation on Inqueue)."""

    PENDING = "Pending"
    INQUEUE = "Inqueue"
    RUNNING = "Running"
    UNSCHEDULABLE = "Unschedulable"


@dataclass
class PodGroup:
    """Gang-scheduling unit: min_member pods admitted all-or-nothing.

    `placement` is the tpu-packer output: pod-name -> node-name assignments
    plus the chosen slice/topology, which the engine turns into per-pod
    node_selector patches (the north-star seam).
    """

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 0
    min_resources: Dict[str, float] = field(default_factory=dict)
    queue: str = ""
    priority_class: str = ""
    schedule_timeout_seconds: Optional[int] = None
    topology_request: Optional[str] = None  # e.g. "2x4" ICI mesh ask
    num_slices: int = 1
    phase: PodGroupPhase = PodGroupPhase.PENDING
    placement: Dict[str, str] = field(default_factory=dict)  # pod name -> node name
    # Nodes dedicated to this gang beyond its pod assignments (whole-slice
    # allocation mode): their accelerator capacity is held until the gang's
    # PodGroup is deleted.
    reserved_nodes: List[str] = field(default_factory=list)
    placement_score: float = 0.0
    creation_attempts: int = 0
    # Tenancy/preemption bookkeeping (tenancy/arbiter.py): how many times
    # this gang was displaced, when last (fair-share debt: displaced gangs
    # re-enter their queue's line first), and how much simulated progress
    # was checkpointed before eviction — the engine subtracts it from the
    # recreated pods' run time, the resume-from-step analogue of the
    # trainer's own save/auto-resume.
    preemption_count: int = 0
    last_preempted_at: float = 0.0
    checkpointed_seconds: float = 0.0
    # True once the gang was admitted through the starvation guard (aged
    # past tenancy_starvation_seconds while pending). Borg-style aging is
    # a priority BOOST, so the promotion must also shield the gang from
    # being preempted right back by the very tier it was promoted past.
    starvation_promoted: bool = False

    KIND = "PodGroup"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    KIND = "ConfigMap"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class HorizontalPodAutoscaler:
    """HPA analogue driving elastic replica counts (reference pytorch/hpa.go:33
    creates autoscaling/v2 HPAs for elastic PyTorchJobs)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    target_kind: str = ""
    target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 1
    metrics: List[Dict[str, Any]] = field(default_factory=list)
    current_replicas: int = 0
    desired_replicas: int = 0

    KIND = "HorizontalPodAutoscaler"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


@dataclass
class Event:
    """Lifecycle event (reference emits k8s Events for every action,
    e.g. common/pod.go:346,364).

    k8s Events parity: repeated identical events (same object, type,
    reason, message) are AGGREGATED on append by the API server — `count`
    climbs, `timestamp` tracks the last occurrence, `first_timestamp` the
    first — so an eviction storm or a persisting invariant violation is one
    record with a count, not an unbounded store append stream."""

    object_kind: str = ""
    object_name: str = ""
    namespace: str = ""
    event_type: str = "Normal"  # Normal | Warning
    reason: str = ""
    message: str = ""
    timestamp: float = 0.0  # last occurrence
    first_timestamp: float = 0.0
    count: int = 1

    KIND = "Event"

    def aggregation_key(self) -> tuple:
        """THE dedup identity (k8s events keys aggregation the same way):
        everything but the timestamps and the count."""
        return (
            self.object_kind, self.object_name, self.namespace,
            self.event_type, self.reason, self.message,
        )


@dataclass
class Lease:
    """Coordination lease for operator leader election (the analogue of the
    coordination.k8s.io/v1 Lease that controller-runtime's leader election
    writes; reference enables it in cmd/training-operator.v1/main.go via
    LeaderElection/LeaderElectionID). Acquire/renew go through the API
    server's version-checked update, so two candidates racing for an
    expired lease resolve to exactly one winner."""

    KIND = "Lease"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    lease_duration: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    transitions: int = 0

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def expired(self, now: float) -> bool:
        return not self.holder or now >= self.renew_time + self.lease_duration
