"""BaseController: shared per-kind behavior + generic status semantics.

Parity target: the common shape of reference per-framework controllers'
UpdateJobStatus (e.g. pytorchjob_controller.go ~330-430, tfjob_controller.go:373):
a *leader replica* (master if present, else worker-0 / chief / launcher)
drives Running/Succeeded conditions; failed pods drive Restarting (set during
engine triage) or Failed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from training_operator_tpu_torch.api import common as capi
from training_operator_tpu_torch.api.common import (
    JobConditionType,
    update_job_conditions,
)
from training_operator_tpu_torch.api.jobs import Job
from training_operator_tpu_torch.cluster.apiserver import APIServer
from training_operator_tpu_torch.cluster.objects import Pod, PodPhase
from training_operator_tpu_torch.engine import core
from training_operator_tpu_torch.utils import metrics


class BaseController:
    """Generic ControllerInterface implementation; kinds override the knobs."""

    kind: str = "Job"
    # Replica types that count as "master role" (get the job-role=master label).
    master_types: Sequence[str] = ("Master",)
    # Priority order for choosing the leader replica type that drives
    # job-level conditions.
    leader_priority: Sequence[str] = ("Master", "Chief", "Launcher", "Worker")
    # Replica types that get headless services (MPI gets none).
    service_types: Optional[Sequence[str]] = None

    def __init__(self, api: APIServer):
        self.api = api

    # -- ControllerInterface ------------------------------------------------

    def get_job(self, namespace: str, name: str) -> Optional[Job]:
        # Prefer the watch-fed mirror when the API client has one (the
        # remote operator's CachedReadAPI): the reconcile was triggered by
        # a watch event, so the mirror is exactly as fresh as the trigger —
        # and the direct GET per reconcile was pure wire latency. Falls
        # back to the live read everywhere else (in-process, SDK).
        getter = getattr(self.api, "try_get_cached", None)
        if getter is not None:
            return getter(self.kind, namespace, name)
        return self.api.try_get(self.kind, namespace, name)

    def default_container_name(self) -> str:
        from training_operator_tpu_torch.api.defaults import DEFAULT_CONTAINER_NAME

        return DEFAULT_CONTAINER_NAME.get(self.kind, "trainer")

    def _port(self, job: Job, rtype: str) -> int:
        """Rendezvous port: first declared port of the replica's main
        container, else the kind's default (reference GetPortFromPyTorchJob
        and the per-framework twins)."""
        spec = job.replica_specs.get(rtype)
        if spec is not None:
            c = spec.template.main_container(self.default_container_name())
            if c is not None and c.ports:
                return next(iter(c.ports.values()))
        return self._default_port(job)

    def _default_port(self, job: Job) -> int:
        return getattr(type(job), "DEFAULT_PORT", 0)

    def is_master_role(self, job: Job, rtype: str, index: int) -> bool:
        return rtype in self.master_types

    def needs_service(self, job: Job, rtype: str) -> bool:
        if self.service_types is None:
            return True
        return rtype in self.service_types

    def set_cluster_spec(self, job: Job, template, rtype: str, index: int) -> None:
        raise NotImplementedError

    def reconcile_hook(self, job: Job) -> None:
        pass

    def replica_order(self, job: Job):
        return sorted(job.replica_specs)

    def allow_pod_creation(self, job: Job, rtype: str, pods) -> bool:
        return True

    # -- status semantics ---------------------------------------------------

    def leader_type(self, job: Job) -> str:
        for t in self.leader_priority:
            spec = job.replica_specs.get(t)
            if spec is not None and (spec.replicas or 0) > 0:
                return t
        return next(iter(job.replica_specs), "Worker")

    def job_succeeded(self, job: Job, pods: Sequence[Pod]) -> bool:
        """Default: every replica of the leader type succeeded."""
        lt = self.leader_type(job)
        spec = job.replica_specs.get(lt)
        if spec is None:
            return False
        expected = spec.replicas or 0
        typed = core.filter_pods_for_replica_type(pods, lt)
        succeeded = sum(1 for p in typed if p.status.phase == PodPhase.SUCCEEDED)
        return expected > 0 and succeeded >= expected

    def job_running(self, job: Job, pods: Sequence[Pod]) -> bool:
        """Default: the leader replica type has a running pod."""
        lt = self.leader_type(job)
        typed = core.filter_pods_for_replica_type(pods, lt)
        return any(p.status.phase == PodPhase.RUNNING for p in typed)

    def permanent_failure(self, job: Job, pods: Sequence[Pod]) -> List[Pod]:
        """Failed pods that will NOT be restarted (policy Never, or ExitCode
        with a permanent 1-127 code) — these fail the job. System-caused
        failures (node loss, tenancy preemption) are never permanent: the
        engine recreates them under every policy (triage's deleted-pod
        rule), so counting them here would fail a job for losing hardware
        or for being displaced by a higher-priority gang."""
        out = []
        for rtype, spec in job.replica_specs.items():
            policy = spec.restart_policy
            for p in core.filter_pods_for_replica_type(pods, rtype):
                if p.status.phase != PodPhase.FAILED:
                    continue
                if core.pod_failed_system(p):
                    continue
                code = p.status.exit_code(self.default_container_name())
                if policy == capi.RestartPolicy.NEVER:
                    out.append(p)
                elif policy == capi.RestartPolicy.EXIT_CODE and (
                    code is not None and not capi.is_retryable_exit_code(code)
                ):
                    out.append(p)
        return out

    def update_job_status(self, job: Job, pods: Sequence[Pod], now: float) -> None:
        if self.job_succeeded(job, pods):
            update_job_conditions(
                job.status, JobConditionType.SUCCEEDED, True, "JobSucceeded",
                f"{self.kind} {job.name} successfully completed.", now=now,
            )
            if job.status.completion_time is None:
                job.status.completion_time = now
            return

        permanent = self.permanent_failure(job, pods)
        if permanent:
            names = ", ".join(p.name for p in permanent)
            update_job_conditions(
                job.status, JobConditionType.FAILED, True, "JobFailed",
                f"{self.kind} {job.name} failed: pods [{names}] failed permanently.",
                now=now,
            )
            if job.status.completion_time is None:
                job.status.completion_time = now
            metrics.jobs_failed.inc(job.namespace, self.kind, "JobFailed")
            return

        if self.job_running(job, pods):
            update_job_conditions(
                job.status, JobConditionType.RUNNING, True, "JobRunning",
                f"{self.kind} {job.name} is running.", now=now,
            )
