"""Pure reconcile helpers: naming, filtering, index diffing, failure policy.

Parity target: reference pkg/core/{pod.go,service.go,job.go,status.go,utils.go}
— deliberately side-effect-free so they are unit-testable in isolation
(SURVEY.md §4 tier 1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from training_operator_tpu_torch.api.common import (
    JOB_KIND_LABEL,
    JOB_NAME_LABEL,
    JOB_ROLE_LABEL,
    JOB_ROLE_MASTER,
    OPERATOR_NAME_LABEL,
    REPLICA_INDEX_LABEL,
    REPLICA_TYPE_LABEL,
    RestartPolicy,
)
from training_operator_tpu_torch.api.jobs import Job
from training_operator_tpu_torch.cluster.objects import Pod, PodPhase, Service


def gen_general_name(job_name: str, replica_type: str, index: int) -> str:
    """Pod/Service name `<job>-<type>-<index>` (reference core/utils.go)."""
    return f"{job_name}-{replica_type.lower()}-{index}"


def base_labels(operator_kind: str, job: Job) -> Dict[str, str]:
    """Selector labels every managed pod/service carries
    (reference common_types.go:24-44 + GenLabels)."""
    return {
        OPERATOR_NAME_LABEL: f"{operator_kind.lower()}-controller",
        JOB_NAME_LABEL: job.name,
        JOB_KIND_LABEL: job.kind,
    }


def filter_pods_for_replica_type(pods: Sequence[Pod], replica_type: str) -> List[Pod]:
    """Reference core/pod.go:29 FilterPodsForReplicaType."""
    return [p for p in pods if p.metadata.labels.get(REPLICA_TYPE_LABEL) == replica_type]


def filter_services_for_replica_type(
    services: Sequence[Service], replica_type: str
) -> List[Service]:
    return [s for s in services if s.metadata.labels.get(REPLICA_TYPE_LABEL) == replica_type]


def get_pod_slices(pods: Sequence[Pod], replicas: int) -> List[List[Pod]]:
    """Bucket pods by their replica-index label; index >= replicas goes to
    overflow buckets beyond `replicas` (to be deleted). Reference
    core/pod.go:48 GetPodSlices / CalculatePodSliceSize."""
    size = replicas
    indexed: List[List[Pod]] = []
    parsed = []
    for p in pods:
        idx_str = p.metadata.labels.get(REPLICA_INDEX_LABEL, "")
        try:
            idx = int(idx_str)
        except ValueError:
            continue  # reference logs and skips unparseable indices
        if idx < 0:
            continue
        parsed.append((idx, p))
        size = max(size, idx + 1)
    indexed = [[] for _ in range(size)]
    for idx, p in parsed:
        indexed[idx].append(p)
    return indexed


def get_service_slices(services: Sequence[Service], replicas: int) -> List[List[Service]]:
    """Service twin of get_pod_slices (reference core/service.go:118-171)."""
    size = replicas
    parsed = []
    for s in services:
        idx_str = s.metadata.labels.get(REPLICA_INDEX_LABEL, "")
        try:
            idx = int(idx_str)
        except ValueError:
            continue
        if idx < 0:
            continue
        parsed.append((idx, s))
        size = max(size, idx + 1)
    indexed: List[List[Service]] = [[] for _ in range(size)]
    for idx, s in parsed:
        indexed[idx].append(s)
    return indexed


def effective_pod_restart_policy(spec_policy: Optional[RestartPolicy]) -> RestartPolicy:
    """Map the replica RestartPolicy onto the pod-level policy the kubelet
    honors: ExitCode becomes Never so failures surface to the engine for
    exit-code triage (reference core/pod.go:81 SetRestartPolicy)."""
    if spec_policy is None:
        return RestartPolicy.ON_FAILURE
    if spec_policy == RestartPolicy.EXIT_CODE:
        return RestartPolicy.NEVER
    return spec_policy


def past_active_deadline(job: Job, now: float) -> bool:
    """Reference core/job.go:82 PastActiveDeadline."""
    deadline = job.run_policy.active_deadline_seconds
    if deadline is None or job.status.start_time is None:
        return False
    return (now - job.status.start_time) >= deadline


# Message prefix stamped onto pods failed by NODE loss rather than their own
# exit: the node lifecycle controller's eviction, a drain, and the gang
# scheduler's re-placement eviction all mark pods with it. Triage treats such
# pods as retryable REGARDLESS of restart policy — the reference's rule for
# deleted pods (a pod that vanished with its node is not a workload failure)
# — and does not charge them against the recreate-restart budget.
NODE_LOST_MESSAGE_PREFIX = "NodeLost"


def pod_failed_node_lost(pod: Pod) -> bool:
    return (
        pod.status.phase == PodPhase.FAILED
        and pod.status.message.startswith(NODE_LOST_MESSAGE_PREFIX)
    )


# Message prefix stamped onto pods displaced by the tenancy arbiter (the
# fair-share/priority preemption path, tenancy/arbiter.py preempt_pod).
# Same triage contract as NODE_LOST: the workload did nothing wrong — the
# fleet reclaimed its hardware — so the failure is retryable under EVERY
# restart policy and never charged against the recreate-restart budget
# (the victim resumes from its checkpoint with its budget intact).
PREEMPTED_MESSAGE_PREFIX = "Preempted"


def pod_failed_preempted(pod: Pod) -> bool:
    return (
        pod.status.phase == PodPhase.FAILED
        and pod.status.message.startswith(PREEMPTED_MESSAGE_PREFIX)
    )


def pod_failed_system(pod: Pod) -> bool:
    """Failures the SYSTEM caused (node loss, preemption), as opposed to
    the workload's own exit — the one predicate engine triage and the
    per-kind permanent-failure classifiers must agree on."""
    return pod_failed_node_lost(pod) or pod_failed_preempted(pod)


# Annotation tracking engine-driven delete+recreate restarts (ExitCode-policy
# retryable failures), which recreate pods with restart_count=0 and would
# otherwise never trip the backoff limit. The reference closes this gap with
# its exceedsBackoffLimit/jobHasNewFailure bookkeeping (common/job.go:195-201).
RESTART_COUNT_ANNOTATION = "training.tpu.dev/total-restarts"


def job_recreate_restarts(job: Job) -> int:
    try:
        return int(job.metadata.annotations.get(RESTART_COUNT_ANNOTATION, "0"))
    except ValueError:
        return 0


def past_backoff_limit(job: Job, pods: Sequence[Pod]) -> bool:
    """Reference core/job.go:95 PastBackoffLimit: sum container restart counts
    across this job's pods (in-place kubelet restarts under OnFailure/Always)
    plus engine-driven recreate restarts, against RunPolicy.backoff_limit."""
    limit = job.run_policy.backoff_limit
    if limit is None:
        return False
    restarts = job_recreate_restarts(job)
    for rtype, spec in job.replica_specs.items():
        if spec.restart_policy not in (RestartPolicy.ON_FAILURE, RestartPolicy.ALWAYS):
            continue
        for p in filter_pods_for_replica_type(pods, rtype):
            restarts += p.status.restart_count()
    return restarts > limit


def record_abnormal_pods(active_pods: Sequence[Pod]) -> List[str]:
    """Names of pods stuck pending/unschedulable, for events
    (reference core/job.go:35 RecordAbnormalPods)."""
    return [
        p.name
        for p in active_pods
        if p.status.phase == PodPhase.PENDING and not p.node_name
    ]


def replica_labels(
    operator_kind: str, job: Job, replica_type: str, index: int, is_master: bool
) -> Dict[str, str]:
    labels = base_labels(operator_kind, job)
    labels[REPLICA_TYPE_LABEL] = replica_type
    labels[REPLICA_INDEX_LABEL] = str(index)
    if is_master:
        labels[JOB_ROLE_LABEL] = JOB_ROLE_MASTER
    return labels
