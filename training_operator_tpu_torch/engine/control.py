"""Resource control: validated create/delete wrappers emitting events+metrics.

Parity target: reference pkg/controller.v1/control/{pod_control.go,
service_control.go,podgroup_control.go} — thin layers over the API client that
attach controller owner references, emit lifecycle Events, bump counters, and
come with Fake variants that capture calls for engine tests
(FakePodControl, reference pod_control.go:195).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from training_operator_tpu_torch.api.jobs import Job, ObjectMeta
from training_operator_tpu_torch.cluster.apiserver import APIServer, NotFoundError
from training_operator_tpu_torch.cluster.objects import (
    Event,
    Pod,
    PodGroup,
    Service,
)
from training_operator_tpu_torch.utils import metrics


class PodControl:
    """Reference PodControlInterface (control/pod_control.go:53)."""

    def __init__(self, api: APIServer, now_fn=None):
        self.api = api
        self._now = now_fn or (lambda: 0.0)

    def create_pod(self, pod: Pod, owner: Job) -> Pod:
        if not pod.metadata.labels:
            raise ValueError("pod must carry selector labels")
        pod.metadata.owner_uid = owner.uid
        pod.metadata.namespace = owner.namespace
        created = self.api.create(pod)
        metrics.created_pods.inc()
        self._event(owner, "Normal", "SuccessfulCreatePod", f"Created pod: {pod.name}")
        return created

    def delete_pod(self, namespace: str, name: str, owner: Job) -> None:
        self.api.delete("Pod", namespace, name)
        metrics.deleted_pods.inc()
        self._event(owner, "Normal", "SuccessfulDeletePod", f"Deleted pod: {name}")

    def _event(self, owner: Job, etype: str, reason: str, message: str) -> None:
        self.api.record_event(
            Event(
                object_kind=owner.kind,
                object_name=owner.name,
                namespace=owner.namespace,
                event_type=etype,
                reason=reason,
                message=message,
                timestamp=self._now(),
            )
        )


class ServiceControl:
    """Reference ServiceControlInterface (control/service_control.go:51)."""

    def __init__(self, api: APIServer, now_fn=None):
        self.api = api
        self._now = now_fn or (lambda: 0.0)

    def create_service(self, service: Service, owner: Job) -> Service:
        if not service.metadata.labels:
            raise ValueError("service must carry selector labels")
        service.metadata.owner_uid = owner.uid
        service.metadata.namespace = owner.namespace
        created = self.api.create(service)
        metrics.created_services.inc()
        self._event(owner, "Normal", "SuccessfulCreateService", f"Created service: {service.name}")
        return created

    def delete_service(self, namespace: str, name: str, owner: Job) -> None:
        self.api.delete("Service", namespace, name)
        metrics.deleted_services.inc()
        self._event(owner, "Normal", "SuccessfulDeleteService", f"Deleted service: {name}")

    def _event(self, owner: Job, etype: str, reason: str, message: str) -> None:
        self.api.record_event(
            Event(
                object_kind=owner.kind,
                object_name=owner.name,
                namespace=owner.namespace,
                event_type=etype,
                reason=reason,
                message=message,
                timestamp=self._now(),
            )
        )


class PodGroupControl:
    """Gang-scheduling seam (reference PodGroupControlInterface,
    control/podgroup_control.go:36-57).

    The scheduler behind it is pluggable: the volcano-like baseline or the
    tpu-packer placement engine. `decorate_pod_template` stamps the group
    membership annotation pods are matched by (reference: volcano annotation
    `scheduling.k8s.io/group-name` / scheduler-plugins label
    `scheduling.x-k8s.io/pod-group`).
    """

    POD_GROUP_ANNOTATION = "scheduling.tpu.dev/pod-group"
    SCHEDULER_NAME = "tpu-gang-scheduler"

    def __init__(self, api: APIServer, now_fn=None):
        self.api = api
        self._now = now_fn

    def get_podgroup(self, namespace: str, name: str) -> Optional[PodGroup]:
        return self.api.try_get("PodGroup", namespace, name)

    def create_podgroup(
        self,
        owner: Job,
        min_member: int,
        min_resources: Dict[str, float],
        queue: str = "",
        priority_class: str = "",
        schedule_timeout_seconds: Optional[int] = None,
        topology_request: Optional[str] = None,
        num_slices: int = 1,
    ) -> PodGroup:
        pg = PodGroup(
            metadata=ObjectMeta(
                name=owner.name,
                namespace=owner.namespace,
                owner_uid=owner.uid,
                labels={"job-kind": owner.kind},
                # Cluster-clock birth stamp: the schedule-timeout check,
                # the packer's aging, and the tenancy starvation guard all
                # measure waiting from here — without it every wait-based
                # rule degenerates (None reads as "waiting forever").
                creation_time=self._now() if self._now is not None else None,
            ),
            min_member=min_member,
            min_resources=min_resources,
            queue=queue,
            priority_class=priority_class,
            schedule_timeout_seconds=schedule_timeout_seconds,
            topology_request=topology_request,
            num_slices=num_slices,
        )
        created = self.api.create(pg)
        metrics.created_podgroups.inc()
        return created

    def update_podgroup(self, pg: PodGroup) -> PodGroup:
        return self.api.update(pg, check_version=False)

    def delete_podgroup(self, namespace: str, name: str) -> None:
        try:
            self.api.delete("PodGroup", namespace, name)
            metrics.deleted_podgroups.inc()
        except NotFoundError:
            pass

    def decorate_pod_template(self, template, podgroup_name: str) -> None:
        template.annotations[self.POD_GROUP_ANNOTATION] = podgroup_name
        template.scheduler_name = self.SCHEDULER_NAME

    def delay_pod_creation(self, pg: Optional[PodGroup]) -> bool:
        """Volcano semantics: hold pod creation until the group is admitted
        (>= Inqueue), so pods of un-admitted gangs never camp on quota
        (reference podgroup_control.go:81 DelayPodCreationDueToPodGroup)."""
        from training_operator_tpu_torch.cluster.objects import PodGroupPhase

        if pg is None:
            return True
        return pg.phase == PodGroupPhase.PENDING


class FakePodControl(PodControl):
    """Captures creates/deletes without touching the API server
    (reference control/pod_control.go:195)."""

    def __init__(self):
        self.created: List[Pod] = []
        self.deleted: List[str] = []
        self.create_error: Optional[Exception] = None

    def create_pod(self, pod: Pod, owner: Job) -> Pod:
        if self.create_error:
            raise self.create_error
        self.created.append(pod)
        return pod

    def delete_pod(self, namespace: str, name: str, owner: Job) -> None:
        self.deleted.append(f"{namespace}/{name}")


class FakeServiceControl(ServiceControl):
    def __init__(self):
        self.created: List[Service] = []
        self.deleted: List[str] = []

    def create_service(self, service: Service, owner: Job) -> Service:
        self.created.append(service)
        return service

    def delete_service(self, namespace: str, name: str, owner: Job) -> None:
        self.deleted.append(f"{namespace}/{name}")
