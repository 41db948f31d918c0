"""Common job API types shared by every job kind.

Parity target: reference pkg/apis/kubeflow.org/v1/common_types.go:24-251 —
JobStatus / ReplicaSpec / ReplicaStatus / JobCondition / RunPolicy /
RestartPolicy / CleanPodPolicy / SchedulingPolicy — re-designed as Python
dataclasses. Serialization (`to_dict` / `from_dict`) replaces the reference's
generated deepcopy/openapi machinery.

Label keys mirror reference common_types.go:24-44 under our own API group.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Well-known labels (reference common_types.go:24-44)
# ---------------------------------------------------------------------------
LABEL_PREFIX = "training.tpu.dev/"
REPLICA_INDEX_LABEL = LABEL_PREFIX + "replica-index"
REPLICA_TYPE_LABEL = LABEL_PREFIX + "replica-type"
JOB_NAME_LABEL = LABEL_PREFIX + "job-name"
JOB_KIND_LABEL = LABEL_PREFIX + "job-kind"
JOB_ROLE_LABEL = LABEL_PREFIX + "job-role"
OPERATOR_NAME_LABEL = LABEL_PREFIX + "operator-name"
JOB_ROLE_MASTER = "master"


class RestartPolicy(str, enum.Enum):
    """Restart policy for replicas (reference common_types.go:183-189).

    EXIT_CODE: exit codes 1-127 are permanent failures; >=128 (signal-killed,
    e.g. SIGKILL from preemption) are retryable (reference
    pkg/util/train/train_util.go:14).
    """

    ALWAYS = "Always"
    ON_FAILURE = "OnFailure"
    NEVER = "Never"
    EXIT_CODE = "ExitCode"


def is_retryable_exit_code(code: int) -> bool:
    """Reference pkg/util/train/train_util.go:14 — >=128 means killed by signal."""
    return code >= 128


class CleanPodPolicy(str, enum.Enum):
    """What to clean up when the job finishes (reference common_types.go)."""

    ALL = "All"
    RUNNING = "Running"
    NONE = "None"


class JobConditionType(str, enum.Enum):
    """Job condition types (reference common_types.go:47-76)."""

    CREATED = "Created"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUCCEEDED = "Succeeded"
    SUSPENDED = "Suspended"
    FAILED = "Failed"


@dataclass
class JobCondition:
    type: JobConditionType
    status: bool
    reason: str = ""
    message: str = ""
    last_update_time: float = 0.0
    last_transition_time: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type.value,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastUpdateTime": self.last_update_time,
            "lastTransitionTime": self.last_transition_time,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobCondition":
        return cls(
            type=JobConditionType(d["type"]),
            status=bool(d["status"]),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            last_update_time=d.get("lastUpdateTime", 0.0),
            last_transition_time=d.get("lastTransitionTime", 0.0),
        )


@dataclass
class ReplicaStatus:
    """Per-replica-type tallies (reference common_types.go ReplicaStatus)."""

    active: int = 0
    succeeded: int = 0
    failed: int = 0
    label_selector: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "active": self.active,
            "succeeded": self.succeeded,
            "failed": self.failed,
            "labelSelector": self.label_selector,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ReplicaStatus":
        return cls(
            active=d.get("active", 0),
            succeeded=d.get("succeeded", 0),
            failed=d.get("failed", 0),
            label_selector=d.get("labelSelector", ""),
        )


@dataclass
class JobStatus:
    """Observed job state (reference common_types.go JobStatus)."""

    conditions: List[JobCondition] = field(default_factory=list)
    replica_statuses: Dict[str, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    last_reconcile_time: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "conditions": [c.to_dict() for c in self.conditions],
            "replicaStatuses": {k: v.to_dict() for k, v in self.replica_statuses.items()},
            "startTime": self.start_time,
            "completionTime": self.completion_time,
            "lastReconcileTime": self.last_reconcile_time,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobStatus":
        return cls(
            conditions=[JobCondition.from_dict(c) for c in d.get("conditions", [])],
            replica_statuses={
                k: ReplicaStatus.from_dict(v) for k, v in d.get("replicaStatuses", {}).items()
            },
            start_time=d.get("startTime"),
            completion_time=d.get("completionTime"),
            last_reconcile_time=d.get("lastReconcileTime"),
        )


# ---------------------------------------------------------------------------
# Condition helpers (reference pkg/util/status.go, pkg/core/status.go:25-50)
# ---------------------------------------------------------------------------


def get_condition(status: JobStatus, cond_type: JobConditionType) -> Optional[JobCondition]:
    for c in status.conditions:
        if c.type == cond_type:
            return c
    return None


def has_condition(status: JobStatus, cond_type: JobConditionType) -> bool:
    c = get_condition(status, cond_type)
    return c is not None and c.status


def is_finished(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.SUCCEEDED) or has_condition(
        status, JobConditionType.FAILED
    )

def is_succeeded(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.SUCCEEDED)


def is_failed(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.FAILED)


def is_suspended(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.SUSPENDED)


def is_running(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.RUNNING)


def update_job_conditions(
    status: JobStatus,
    cond_type: JobConditionType,
    cond_status: bool,
    reason: str,
    message: str,
    now: Optional[float] = None,
) -> None:
    """Set/append a condition, keeping mutual exclusion between phase conditions.

    Mirrors reference pkg/util/status.go UpdateJobConditions semantics: setting
    Running clears Restarting; setting a terminal/Restarting condition clears
    Running; duplicate updates only bump lastUpdateTime.
    """
    now = time.time() if now is None else now
    new_cond = JobCondition(
        type=cond_type,
        status=cond_status,
        reason=reason,
        message=message,
        last_update_time=now,
        last_transition_time=now,
    )
    if cond_status and cond_type in (
        JobConditionType.RUNNING,
        JobConditionType.SUCCEEDED,
        JobConditionType.FAILED,
    ):
        # Phase conditions are mutually exclusive with Restarting/Suspended.
        _filter_out(status, JobConditionType.RESTARTING)
        _filter_out(status, JobConditionType.SUSPENDED)
        if cond_type != JobConditionType.RUNNING:
            _filter_out(status, JobConditionType.RUNNING)
    if cond_status and cond_type in (
        JobConditionType.RESTARTING,
        JobConditionType.SUSPENDED,
    ):
        _filter_out(status, JobConditionType.RUNNING)

    existing = get_condition(status, cond_type)
    if existing is not None:
        if existing.status == new_cond.status and existing.reason == new_cond.reason:
            # True no-op updates leave the condition untouched so reconcile
            # passes that change nothing produce byte-identical status (the
            # engine skips the API write in that case).
            if existing.message != message:
                existing.message = message
                existing.last_update_time = now
            return
        new_cond.last_transition_time = now
        status.conditions = [c for c in status.conditions if c.type != cond_type]
    status.conditions.append(new_cond)


def _filter_out(status: JobStatus, cond_type: JobConditionType) -> None:
    status.conditions = [c for c in status.conditions if c.type != cond_type]


# ---------------------------------------------------------------------------
# Scheduling & run policy
# ---------------------------------------------------------------------------


@dataclass
class SchedulingPolicy:
    """Gang-scheduling knobs (reference common_types.go SchedulingPolicy).

    `topology` is the TPU-first extension: a requested ICI mesh shape, e.g.
    "2x4" for a v5e-8 slice, consumed by the tpu-packer placement engine.
    """

    min_available: Optional[int] = None
    queue: str = ""
    min_resources: Dict[str, float] = field(default_factory=dict)
    priority_class: str = ""
    schedule_timeout_seconds: Optional[int] = None
    topology: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "minAvailable": self.min_available,
            "queue": self.queue,
            "minResources": dict(self.min_resources),
            "priorityClass": self.priority_class,
            "scheduleTimeoutSeconds": self.schedule_timeout_seconds,
            "topology": self.topology,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SchedulingPolicy":
        return cls(
            min_available=d.get("minAvailable"),
            queue=d.get("queue", ""),
            min_resources=dict(d.get("minResources", {})),
            priority_class=d.get("priorityClass", ""),
            schedule_timeout_seconds=d.get("scheduleTimeoutSeconds"),
            topology=d.get("topology"),
        )


@dataclass
class RunPolicy:
    """Job-level execution policy (reference common_types.go:191-251)."""

    clean_pod_policy: Optional[CleanPodPolicy] = None
    ttl_seconds_after_finished: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    backoff_limit: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None
    suspend: bool = False
    managed_by: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "cleanPodPolicy": self.clean_pod_policy.value if self.clean_pod_policy else None,
            "ttlSecondsAfterFinished": self.ttl_seconds_after_finished,
            "activeDeadlineSeconds": self.active_deadline_seconds,
            "backoffLimit": self.backoff_limit,
            "schedulingPolicy": self.scheduling_policy.to_dict() if self.scheduling_policy else None,
            "suspend": self.suspend,
            "managedBy": self.managed_by,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunPolicy":
        sp = d.get("schedulingPolicy")
        cpp = d.get("cleanPodPolicy")
        return cls(
            clean_pod_policy=CleanPodPolicy(cpp) if cpp else None,
            ttl_seconds_after_finished=d.get("ttlSecondsAfterFinished"),
            active_deadline_seconds=d.get("activeDeadlineSeconds"),
            backoff_limit=d.get("backoffLimit"),
            scheduling_policy=SchedulingPolicy.from_dict(sp) if sp else None,
            suspend=bool(d.get("suspend", False)),
            managed_by=d.get("managedBy"),
        )


# ---------------------------------------------------------------------------
# Pod template & replica spec
# ---------------------------------------------------------------------------


@dataclass
class Container:
    """Minimal container spec for the virtual substrate and env injection."""

    name: str
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    ports: Dict[str, int] = field(default_factory=dict)
    resources: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Container":
        return cls(
            name=d["name"],
            image=d.get("image", ""),
            command=list(d.get("command", [])),
            args=list(d.get("args", [])),
            env=dict(d.get("env", {})),
            ports=dict(d.get("ports", {})),
            resources=dict(d.get("resources", {})),
        )


@dataclass
class PodTemplateSpec:
    """Pod template: containers + placement hints.

    `node_selector` / `affinity` are the surface the tpu-packer writes its
    placement decisions into (north-star: per-pod nodeSelector/affinity patches).
    """

    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    # Tolerations of node taints, k8s-shaped dicts:
    # {"key", "operator" ("Equal"|"Exists"), "value", "effect"}.
    tolerations: List[Dict[str, Any]] = field(default_factory=list)
    # Volumes, k8s-shaped dicts ({"name", ...source}); carried through to
    # pods verbatim (the substrate does not mount anything).
    volumes: List[Dict[str, Any]] = field(default_factory=list)
    scheduler_name: str = ""
    service_account: str = ""
    restart_policy: Optional[RestartPolicy] = None

    def main_container(self, name: str) -> Optional[Container]:
        for c in self.containers:
            if c.name == name:
                return c
        return None

    def resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for c in self.containers:
            for k, v in c.resources.items():
                total[k] = total.get(k, 0.0) + v
        return total

    def copy(self) -> "PodTemplateSpec":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "containers": [c.to_dict() for c in self.containers],
            "initContainers": [c.to_dict() for c in self.init_containers],
            "labels": dict(self.labels),
            "annotations": dict(self.annotations),
            "nodeSelector": dict(self.node_selector),
            "tolerations": [dict(t) for t in self.tolerations],
            "volumes": [dict(v) for v in self.volumes],
            "schedulerName": self.scheduler_name,
            "restartPolicy": self.restart_policy.value if self.restart_policy else None,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PodTemplateSpec":
        rp = d.get("restartPolicy")
        return cls(
            containers=[Container.from_dict(c) for c in d.get("containers", [])],
            init_containers=[Container.from_dict(c) for c in d.get("initContainers", [])],
            labels=dict(d.get("labels", {})),
            annotations=dict(d.get("annotations", {})),
            node_selector=dict(d.get("nodeSelector", {})),
            tolerations=[dict(t) for t in d.get("tolerations", [])],
            volumes=[dict(v) for v in d.get("volumes", [])],
            scheduler_name=d.get("schedulerName", ""),
            restart_policy=RestartPolicy(rp) if rp else None,
        )


@dataclass
class ReplicaSpec:
    """One replica group of a job (reference common_types.go ReplicaSpec)."""

    replicas: Optional[int] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    restart_policy: Optional[RestartPolicy] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "replicas": self.replicas,
            "template": self.template.to_dict(),
            "restartPolicy": self.restart_policy.value if self.restart_policy else None,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ReplicaSpec":
        rp = d.get("restartPolicy")
        return cls(
            replicas=d.get("replicas"),
            template=PodTemplateSpec.from_dict(d.get("template", {})),
            restart_policy=RestartPolicy(rp) if rp else None,
        )
