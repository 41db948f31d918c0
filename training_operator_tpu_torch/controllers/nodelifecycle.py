"""Node lifecycle: the eviction primitive.

Counterpart of training_operator_tpu/controllers/nodelifecycle.py's
`fail_pod` and `evict_pod`, the calls the gang scheduler's re-placement
makes when a gang's placement loses a node. The controller that detects a
lapsed heartbeat, taints the node and evicts its pods, and the cordon,
uncordon and drain verbs, are still to be ported.
"""

from __future__ import annotations

from typing import Optional

from training_operator_tpu_torch.api.common import JOB_KIND_LABEL, JOB_NAME_LABEL
from training_operator_tpu_torch.cluster.objects import Event, Pod
from training_operator_tpu_torch.engine.core import NODE_LOST_MESSAGE_PREFIX
from training_operator_tpu_torch.utils import metrics


def fail_pod(api, pod: Pod, message_prefix: str, reason: str, now: float,
             event_reason: str, event_verb: str) -> Optional[Pod]:
    """THE fail-a-pod sequence shared by every system-caused eviction
    (node loss/drain here, tenancy preemption in tenancy/arbiter.py):
    fresh-get, terminal check, FAILED + finish_time + prefixed message —
    the marker engine triage keys retryability on — container unwind,
    unversioned status write, and the Warning Event. One function so the
    two paths can never diverge on what "this pod was taken from the
    workload" looks like. Returns the written pod, or None when it is
    already terminal or deleted."""
    fresh = api.try_get("Pod", pod.namespace, pod.name)
    if fresh is None or fresh.is_terminal():
        return None
    from training_operator_tpu_torch.cluster.objects import PodPhase

    fresh.status.phase = PodPhase.FAILED
    fresh.status.finish_time = now
    fresh.status.message = f"{message_prefix}: {reason}"
    for cs in fresh.status.container_statuses:
        cs.running = False
    api.update(fresh, check_version=False)
    job_name = fresh.metadata.labels.get(JOB_NAME_LABEL)
    api.record_event(Event(
        object_kind=fresh.metadata.labels.get(JOB_KIND_LABEL, "Pod"),
        object_name=job_name or fresh.name,
        namespace=fresh.namespace,
        event_type="Warning",
        reason=event_reason,
        message=f"pod {fresh.name} {event_verb}: {reason}",
        timestamp=now,
    ))
    return fresh


def evict_pod(api, pod: Pod, reason: str, now: float, node_name: str = "",
              detect_at: Optional[float] = None) -> bool:
    """Fail one pod because its node is gone/dead/drained — THE eviction
    primitive (lifecycle controller, drain verb, and the gang scheduler's
    re-placement all route through it so the NODE_LOST marker, the metric,
    the Event, and the timeline span can never diverge). Returns False when
    the pod is already terminal or deleted."""
    fresh = fail_pod(api, pod, NODE_LOST_MESSAGE_PREFIX, reason, now,
                     event_reason="PodEvicted", event_verb="evicted")
    if fresh is None:
        return False
    metrics.node_evictions.inc(node_name or fresh.node_name or "")
    job_name = fresh.metadata.labels.get(JOB_NAME_LABEL)
    if job_name:
        # Timeline: detect -> evict, on the owning job's lifecycle (the
        # gang_solve + bind spans that follow complete the recovery story
        # `describe` renders).
        api.timelines.record_span(
            fresh.namespace, job_name, fresh.metadata.owner_uid or "",
            "node_evict",
            start=detect_at if detect_at is not None else now, end=now,
            pod=fresh.name, node=node_name or fresh.node_name or "",
        )
    return True


