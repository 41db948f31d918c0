"""JobController: the shared reconcile engine every job kind runs on.

Parity target: reference pkg/controller.v1/common/job.go:78-364 (ReconcileJobs),
common/pod.go:269-474 (ReconcilePods/createNewPod), common/service.go:156-273
(ReconcileServices), plus the 17-method ControllerInterface contract
(pkg/common/interface.go:28-96) that per-kind controllers implement.

Semantics preserved:
- cleanup + TTL GC on finish; suspend/resume (delete pods, reset StartTime);
- backoff-limit / active-deadline enforcement;
- gang: PodGroup sync + delayed pod creation until admission;
- per-replica pod/service diffing by replica-index label;
- exit-code restart triage (ExitCode: 1-127 permanent, >=128 retryable);
- expectations-gated mutation; optimistic-concurrency status writes.
"""

from __future__ import annotations

import copy
import logging
from typing import Callable, Dict, List, Optional, Protocol, Sequence

from training_operator_tpu_torch.api import common as capi
from training_operator_tpu_torch.api.common import (
    CleanPodPolicy,
    JOB_NAME_LABEL,
    JobConditionType,
    RestartPolicy,
    update_job_conditions,
)
from training_operator_tpu_torch.api.defaults import default_job
from training_operator_tpu_torch.api.jobs import Job, ObjectMeta
from training_operator_tpu_torch.cluster.apiserver import APIServer, ConflictError, NotFoundError
from training_operator_tpu_torch.cluster.objects import Event, Pod, PodPhase, Service
from training_operator_tpu_torch.engine import core
from training_operator_tpu_torch.engine.control import (
    PodControl,
    PodGroupControl,
    ServiceControl,
)
from training_operator_tpu_torch.engine.expectations import (
    ControllerExpectations,
    gen_expectation_key,
)
from training_operator_tpu_torch.utils import metrics

log = logging.getLogger(__name__)


class ControllerInterface(Protocol):
    """Per-kind contract (reference pkg/common/interface.go:28-96)."""

    kind: str

    def get_job(self, namespace: str, name: str) -> Optional[Job]: ...

    def set_cluster_spec(self, job: Job, template, rtype: str, index: int) -> None:
        """Inject the framework's distributed-bootstrap env into the pod
        template (MASTER_ADDR / TF_CONFIG / COORDINATOR_ADDRESS / ...)."""

    def is_master_role(self, job: Job, rtype: str, index: int) -> bool: ...

    def default_container_name(self) -> str: ...

    def needs_service(self, job: Job, rtype: str) -> bool: ...

    def update_job_status(self, job: Job, pods: Sequence[Pod], now: float) -> None:
        """Framework-specific condition logic from replica tallies."""

    def reconcile_hook(self, job: Job) -> None:
        """Kind-specific extra work each pass (e.g. HPA for elastic torch)."""

    def replica_order(self, job: Job) -> Sequence[str]:
        """Order replica types are reconciled in (MPI: workers first)."""

    def allow_pod_creation(self, job: Job, rtype: str, pods: Sequence[Pod]) -> bool:
        """Gate *creation* of new pods for a replica type (MPI: launcher waits
        for workers, reference mpijob_controller.go:391-403). Failed-pod
        triage, duplicate cleanup, and scale-in always run regardless."""


class JobController:
    """The generic engine; per-kind controllers delegate to it.

    `requeue_after(key, delay)` is provided by the manager for deadline/TTL
    driven revisits. With gang scheduling enabled, pods carry the PodGroup
    annotation and the gang scheduler binds them (possibly via tpu-packer
    placements); otherwise pods go to the default scheduler.
    """

    def __init__(
        self,
        api: APIServer,
        controller: ControllerInterface,
        now_fn: Callable[[], float],
        gang_enabled: bool = False,
        requeue_after: Optional[Callable[[str, float], None]] = None,
        delete_job: Optional[Callable[[Job], None]] = None,
        gang_requeue_seconds: float = 30.0,
    ):
        self.api = api
        self.controller = controller
        self.now = now_fn
        self.gang_enabled = gang_enabled
        # Safety-net poll for gang-gated jobs (admission itself is
        # event-driven; see reconcile). Interactive default 30s; long-wait
        # deployments (the soak's oversubscribed queues hold jobs pending
        # for hours) raise it — N pending jobs re-reconciling every 30
        # sim-seconds for hours IS the reconcile storm the inline comment
        # warns about, just accumulated over fleet time instead of burst
        # width.
        self.gang_requeue_seconds = gang_requeue_seconds
        self.requeue_after = requeue_after or (lambda key, delay: None)
        self.delete_job = delete_job
        self.expectations = ControllerExpectations(now_fn)
        self.pod_control = PodControl(api, now_fn)
        self.service_control = ServiceControl(api, now_fn)
        self.podgroup_control = PodGroupControl(api, now_fn)

    # ------------------------------------------------------------------
    # Entry point
    # ------------------------------------------------------------------

    def reconcile(self, namespace: str, name: str) -> None:
        job = self.controller.get_job(namespace, name)
        if job is None:
            return  # deleted; manager drops expectations on the Deleted event
        if job.run_policy.managed_by not in (None, "", "tpu-training-operator"):
            return  # externally managed (MultiKueue analogue), skip
        default_job(job, now=self.now())

        key = job.key()
        now = self.now()
        pods = self.get_pods_for_job(job)
        services = self.get_services_for_job(job)
        # Status is written back only if this pass changed it (reference
        # common/job.go:360 "UpdateJobStatusInApiServer iff changed") —
        # unconditional writes would re-trigger watches forever.
        prev_status = copy.deepcopy(job.status)

        if not job.status.conditions:
            update_job_conditions(
                job.status, JobConditionType.CREATED, True, "JobCreated",
                f"{job.kind} {name} is created.", now=now,
            )
            metrics.jobs_created.inc(namespace, job.kind)

        # -- finished: cleanup + TTL ------------------------------------
        if capi.is_finished(job.status):
            self._cleanup_finished(job, pods, services, now)
            self._write_status(job, prev_status)
            return

        # -- suspend / resume -------------------------------------------
        if job.run_policy.suspend:
            self._delete_all_pods_and_services(job, pods, services)
            for rs in job.status.replica_statuses.values():
                rs.active = 0
            job.status.start_time = None
            update_job_conditions(
                job.status, JobConditionType.SUSPENDED, True, "JobSuspended",
                f"{job.kind} {name} is suspended.", now=now,
            )
            self._write_status(job, prev_status)
            return
        if capi.is_suspended(job.status):
            # Resumed: reset StartTime (reference common/job.go:146-173).
            update_job_conditions(
                job.status, JobConditionType.SUSPENDED, False, "JobResumed",
                f"{job.kind} {name} is resumed.", now=now,
            )
            job.status.start_time = now
            # The JobResumed Event rides the condition-transition emitter.
            self._schedule_deadline_requeue(job, key)

        if job.status.start_time is None:
            job.status.start_time = now
            self._schedule_deadline_requeue(job, key)

        # -- failure policies -------------------------------------------
        failure_reason = ""
        failure_msg = ""
        if core.past_backoff_limit(job, pods):
            failure_reason = "BackoffLimitExceeded"
            failure_msg = f"{job.kind} {name} has failed because it has reached the specified backoff limit"
        elif core.past_active_deadline(job, now):
            failure_reason = "DeadlineExceeded"
            failure_msg = f"{job.kind} {name} has failed because it was active longer than specified deadline"
        if failure_reason:
            self._delete_all_pods_and_services(job, pods, services)
            self.podgroup_control.delete_podgroup(namespace, name)
            update_job_conditions(
                job.status, JobConditionType.FAILED, True, failure_reason, failure_msg, now=now
            )
            metrics.jobs_failed.inc(namespace, job.kind, failure_reason)
            # The Failed Event rides the uniform condition-transition
            # emitter in _write_status (same reason/message).
            self._write_status(job, prev_status)
            return

        # -- gang scheduling: sync PodGroup, maybe delay pods -----------
        delay_pods = False
        if self.gang_enabled:
            pg = self._sync_podgroup(job)
            if self.podgroup_control.delay_pod_creation(pg):
                delay_pods = True
                # Admission is event-driven — the manager re-enqueues this job
                # on the PodGroup's Modified event. The requeue is only a
                # safety net, so keep it long: a tight poll here multiplies
                # into reconcile storms under queue pressure (1k pending jobs
                # x 20 polls/s was the bench bottleneck).
                self.requeue_after(key, self.gang_requeue_seconds)

        # -- expectations gate ------------------------------------------
        if not self._satisfied_expectations(job):
            return

        # -- per-replica reconcile --------------------------------------
        if not delay_pods:
            for rtype in self.controller.replica_order(job):
                spec = job.replica_specs[rtype]
                self.reconcile_pods(
                    job, pods, rtype, spec,
                    allow_create=self.controller.allow_pod_creation(job, rtype, pods),
                )
                if self.controller.needs_service(job, rtype):
                    self.reconcile_services(job, services, rtype, spec)

        self.controller.reconcile_hook(job)

        # -- status ------------------------------------------------------
        self._update_replica_statuses(job, pods)
        self.controller.update_job_status(job, pods, now)
        if capi.is_finished(job.status):
            # Transitioned to terminal this pass: run cleanup now — status
            # writes don't re-enqueue, so there is no later pass to do it.
            if capi.is_succeeded(job.status):
                metrics.jobs_successful.inc(namespace, job.kind)
            self._cleanup_finished(
                job, self.get_pods_for_job(job), self.get_services_for_job(job), now
            )
        self._write_status(job, prev_status)

    # ------------------------------------------------------------------
    # Pod / service reconcile
    # ------------------------------------------------------------------

    def reconcile_pods(
        self, job: Job, pods: Sequence[Pod], rtype: str, spec, allow_create: bool = True
    ) -> None:
        replicas = spec.replicas or 0
        typed = core.filter_pods_for_replica_type(pods, rtype)
        slices = core.get_pod_slices(typed, replicas)
        exp_key = gen_expectation_key(job.key(), rtype, "pods")

        for idx, bucket in enumerate(slices):
            if len(bucket) > 1:
                # Duplicates: keep the first, delete the rest (reference logs
                # "duplicated pod" and kills extras).
                for extra in bucket[1:]:
                    self._delete_pod(exp_key, extra, job)
                bucket = bucket[:1]
            if idx >= replicas:
                # Scale-in: indices beyond the desired count are removed.
                for p in bucket:
                    self._delete_pod(exp_key, p, job)
                continue
            if not bucket:
                if allow_create:
                    self._create_new_pod(job, rtype, spec, idx, exp_key)
                continue

            pod = bucket[0]
            if pod.status.phase == PodPhase.FAILED:
                self._triage_failed_pod(job, rtype, spec, pod, exp_key)

    def _triage_failed_pod(self, job: Job, rtype: str, spec, pod: Pod, exp_key: str) -> None:
        """Exit-code restart classification (reference common/pod.go:350-374).

        System-caused failures — node-lost evictions (NODE_LOST_MESSAGE_
        PREFIX) and tenancy preemptions (PREEMPTED_MESSAGE_PREFIX) — are
        retryable regardless of restart policy (the reference's deleted-pod
        rule: the hardware died or was reclaimed, the workload did nothing
        wrong) and are NOT charged against the recreate-restart budget that
        backs past_backoff_limit."""
        policy = spec.restart_policy or RestartPolicy.ON_FAILURE
        exit_code = pod.status.exit_code(self.controller.default_container_name())
        node_lost = core.pod_failed_system(pod)
        restart = False
        if node_lost:
            restart = True
        elif policy == RestartPolicy.EXIT_CODE:
            if exit_code is not None and capi.is_retryable_exit_code(exit_code):
                restart = True
            # 1-127: permanent — leave the failed pod; status logic fails job.
        elif policy in (RestartPolicy.ON_FAILURE, RestartPolicy.ALWAYS):
            # Pod-level failure despite kubelet in-place restarts: recreate.
            restart = True
        if restart:
            detail = (
                pod.status.message if node_lost
                else f"failed with exit code {exit_code}"
            )
            self._event(
                job, "Warning", "RestartingPod",
                f"Pod {pod.name} {detail}; restarting",
            )
            self._delete_pod(exp_key, pod, job)
            if not node_lost:
                job.metadata.annotations[core.RESTART_COUNT_ANNOTATION] = str(
                    core.job_recreate_restarts(job) + 1
                )
            metrics.restarted_pods.inc()
            metrics.jobs_restarted.inc(job.namespace, job.kind)
            update_job_conditions(
                job.status, JobConditionType.RESTARTING, True, "JobRestarting",
                f"{job.kind} {job.name} is restarting because pod {pod.name} {detail}.",
                now=self.now(),
            )

    def _create_new_pod(self, job: Job, rtype: str, spec, index: int, exp_key: str) -> None:
        """Reference common/pod.go:383-474 createNewPod."""
        is_master = self.controller.is_master_role(job, rtype, index)
        template = spec.template.copy()
        template.labels.update(core.replica_labels(job.kind, job, rtype, index, is_master))
        template.restart_policy = core.effective_pod_restart_policy(spec.restart_policy)

        # Framework bootstrap env (the per-kind contract).
        self.controller.set_cluster_spec(job, template, rtype, index)

        if self.gang_enabled:
            self.podgroup_control.decorate_pod_template(template, job.name)
            pg = self.podgroup_control.get_podgroup(job.namespace, job.name)
            pod_name = core.gen_general_name(job.name, rtype, index)
            if pg is not None and pod_name in pg.placement:
                # tpu-packer emitted a binding for this pod: pin it.
                template.node_selector["kubernetes.io/hostname"] = pg.placement[pod_name]
            if pg is not None and pg.checkpointed_seconds > 0:
                # Checkpoint-aware resume after preemption: the gang saved
                # `checkpointed_seconds` of progress before it was displaced
                # (tenancy/arbiter.py; the trainer's own save/auto-resume
                # plays this role for real workloads). The recreated pod
                # runs only the REMAINING work — resumed from step, not
                # step 0.
                from training_operator_tpu_torch.cluster.runtime import (
                    ANNOTATION_SIM_DURATION,
                )

                dur = template.annotations.get(ANNOTATION_SIM_DURATION)
                if dur is not None:
                    try:
                        remaining = max(0.0, float(dur) - pg.checkpointed_seconds)
                    except ValueError:
                        remaining = None
                    if remaining is not None:
                        template.annotations[ANNOTATION_SIM_DURATION] = f"{remaining:g}"

        pod = Pod(
            metadata=ObjectMeta(
                name=core.gen_general_name(job.name, rtype, index),
                namespace=job.namespace,
                labels=dict(template.labels),
            ),
            spec=template,
        )
        self.expectations.raise_expectations(exp_key, 1, 0)
        try:
            self.pod_control.create_pod(pod, job)
        except Exception:
            # Creation failed: lower the expectation we just raised
            # (reference createNewPod error path).
            self.expectations.creation_observed(exp_key)
            raise

    def _delete_pod(self, exp_key: str, pod: Pod, job: Job) -> None:
        self.expectations.raise_expectations(exp_key, 0, 1)
        try:
            self.pod_control.delete_pod(pod.namespace, pod.name, job)
        except NotFoundError:
            self.expectations.deletion_observed(exp_key)
        except Exception:
            # Delete failed in flight (wire fault): unwind the expectation
            # we just raised, or every later reconcile early-returns at the
            # expectations gate until its TTL — wedging eviction recovery
            # for minutes (reference DeletePod error path lowers it too).
            # If the delete actually landed and the response was lost, the
            # late Deleted event's observation is clamped at zero.
            self.expectations.deletion_observed(exp_key)
            raise

    def _delete_service(self, svc: Service, job: Job) -> None:
        rtype = svc.metadata.labels.get(capi.REPLICA_TYPE_LABEL, "")
        exp_key = gen_expectation_key(job.key(), rtype, "services")
        self.expectations.raise_expectations(exp_key, 0, 1)
        try:
            self.service_control.delete_service(svc.namespace, svc.name, job)
        except NotFoundError:
            self.expectations.deletion_observed(exp_key)
        except Exception:
            self.expectations.deletion_observed(exp_key)  # see _delete_pod
            raise

    def reconcile_services(self, job: Job, services: Sequence[Service], rtype: str, spec) -> None:
        """One headless service per replica giving stable DNS identity
        (reference common/service.go:156-273)."""
        replicas = spec.replicas or 0
        typed = core.filter_services_for_replica_type(services, rtype)
        slices = core.get_service_slices(typed, replicas)
        exp_key = gen_expectation_key(job.key(), rtype, "services")

        for idx, bucket in enumerate(slices):
            if idx >= replicas:
                for s in bucket:
                    self._delete_service(s, job)
                continue
            if bucket:
                continue
            labels = core.replica_labels(
                job.kind, job, rtype, idx, self.controller.is_master_role(job, rtype, idx)
            )
            ports = {}
            c = spec.template.main_container(self.controller.default_container_name())
            if c is not None:
                ports = dict(c.ports)
            svc = Service(
                metadata=ObjectMeta(
                    name=core.gen_general_name(job.name, rtype, idx),
                    namespace=job.namespace,
                    labels=dict(labels),
                ),
                selector=labels,
                ports=ports,
            )
            self.expectations.raise_expectations(exp_key, 1, 0)
            try:
                self.service_control.create_service(svc, job)
            except Exception:
                self.expectations.creation_observed(exp_key)
                raise

    # ------------------------------------------------------------------
    # Helpers
    # ------------------------------------------------------------------

    def _schedule_deadline_requeue(self, job: Job, key: str) -> None:
        """Revisit the job when its ActiveDeadline elapses."""
        if job.run_policy.active_deadline_seconds is not None:
            self.requeue_after(key, float(job.run_policy.active_deadline_seconds))

    def get_pods_for_job(self, job: Job) -> List[Pod]:
        """List by job-name label, then CLAIM: adopt selector-matching
        orphans (operator restart with a fresh uid counter strands them
        otherwise), release relabeled dependents, ignore foreign-owned pods
        (reference GetPodsForJob + ClaimPods, common/pod.go:219-254 via
        control/controller_ref_manager.go:380)."""
        from training_operator_tpu_torch.engine.claim import ControllerRefManager

        pods = self.api.list("Pod", job.namespace, {JOB_NAME_LABEL: job.name})
        mgr = ControllerRefManager(
            self.api, job, core.base_labels(job.kind, job), "Pod"
        )
        return mgr.claim(pods)

    def get_services_for_job(self, job: Job) -> List[Service]:
        """Same claim semantics as pods (reference common/service.go)."""
        from training_operator_tpu_torch.engine.claim import ControllerRefManager

        svcs = self.api.list("Service", job.namespace, {JOB_NAME_LABEL: job.name})
        mgr = ControllerRefManager(
            self.api, job, core.base_labels(job.kind, job), "Service"
        )
        return mgr.claim(svcs)

    def _satisfied_expectations(self, job: Job) -> bool:
        key = job.key()
        for rtype in job.replica_specs:
            if not self.expectations.satisfied_expectations(
                gen_expectation_key(key, rtype, "pods")
            ):
                return False
            if not self.expectations.satisfied_expectations(
                gen_expectation_key(key, rtype, "services")
            ):
                return False
        return True

    def _sync_podgroup(self, job: Job):
        """Create/refresh the gang PodGroup (reference common/job.go:250-335
        SyncPodGroup + calcPGMinResources)."""
        sp = job.run_policy.scheduling_policy
        min_member = sp.min_available if sp and sp.min_available else job.total_replicas()
        min_resources: Dict[str, float] = dict(sp.min_resources) if sp and sp.min_resources else {}
        if not min_resources:
            for rtype, spec in job.replica_specs.items():
                per_pod = spec.template.resources()
                for k, v in per_pod.items():
                    min_resources[k] = min_resources.get(k, 0.0) + v * (spec.replicas or 0)
        pg = self.podgroup_control.get_podgroup(job.namespace, job.name)
        topo = job.tpu_policy.topology if job.tpu_policy else (sp.topology if sp else None)
        num_slices = job.tpu_policy.num_slices if job.tpu_policy else 1
        # Tenancy routing: the spec's priority class (RunPolicy.scheduling_
        # policy.priority_class — on the wire since the seed) is stamped
        # onto the PodGroup so the fair-share arbiter and `describe` see
        # it; a job naming none falls to the deployment's configured
        # default class.
        from training_operator_tpu_torch import config as _config

        priority_class = (sp.priority_class if sp else "") or (
            _config.current().default_priority_class
        )
        queue = sp.queue if sp else ""
        if pg is None:
            pg = self.podgroup_control.create_podgroup(
                job,
                min_member=min_member,
                min_resources=min_resources,
                queue=queue,
                priority_class=priority_class,
                schedule_timeout_seconds=sp.schedule_timeout_seconds if sp else None,
                topology_request=topo,
                num_slices=num_slices,
            )
        elif (
            pg.min_member != min_member
            or pg.min_resources != min_resources
            or pg.topology_request != topo
            or pg.priority_class != priority_class
            or pg.queue != queue
        ):
            # num_slices is deliberately NOT force-synced here: on elastic
            # TPU resize the repack path owns the num_slices transition
            # (derived from the whole-slice contract) together with the
            # placement release — racing it from here would flap the group.
            pg.min_member = min_member
            pg.min_resources = min_resources
            pg.topology_request = topo
            pg.priority_class = priority_class
            pg.queue = queue
            self.podgroup_control.update_podgroup(pg)
        return pg

    def _update_replica_statuses(self, job: Job, pods: Sequence[Pod]) -> None:
        """Active/succeeded/failed tallies (reference common/pod.go:376)."""
        for rtype in job.replica_specs:
            rs = job.status.replica_statuses.setdefault(rtype, capi.ReplicaStatus())
            typed = core.filter_pods_for_replica_type(pods, rtype)
            rs.active = sum(1 for p in typed if p.status.phase == PodPhase.RUNNING)
            rs.succeeded = sum(1 for p in typed if p.status.phase == PodPhase.SUCCEEDED)
            rs.failed = sum(1 for p in typed if p.status.phase == PodPhase.FAILED)

    def _cleanup_finished(self, job: Job, pods, services, now: float) -> None:
        """Reference common/job.go:122-144 + CleanupJob TTL GC (:420-453)."""
        policy = job.run_policy.clean_pod_policy or CleanPodPolicy.NONE
        if policy == CleanPodPolicy.ALL:
            self._delete_all_pods_and_services(job, pods, services, include_terminal=True)
        elif policy == CleanPodPolicy.RUNNING:
            running = [p for p in pods if p.status.phase == PodPhase.RUNNING]
            for p in running:
                exp_key = gen_expectation_key(
                    job.key(), p.metadata.labels.get(capi.REPLICA_TYPE_LABEL, ""), "pods"
                )
                self._delete_pod(exp_key, p, job)
            for s in services:
                self._delete_service(s, job)
        self.podgroup_control.delete_podgroup(job.namespace, job.name)
        if job.status.completion_time is None:
            job.status.completion_time = now
        ttl = job.run_policy.ttl_seconds_after_finished
        if ttl is not None and self.delete_job is not None:
            expire_at = job.status.completion_time + ttl
            if now >= expire_at:
                self.delete_job(job)
            else:
                self.requeue_after(job.key(), expire_at - now)

    def _delete_all_pods_and_services(
        self, job: Job, pods, services, include_terminal: bool = False
    ) -> None:
        """Reference common/job.go:43 DeletePodsAndServices. Suspend/failure
        paths delete only live pods; CleanPodPolicy=All sweeps terminal ones
        too."""
        for p in pods:
            if p.is_terminal() and not include_terminal:
                continue
            exp_key = gen_expectation_key(
                job.key(), p.metadata.labels.get(capi.REPLICA_TYPE_LABEL, ""), "pods"
            )
            self._delete_pod(exp_key, p, job)
        for s in services:
            self._delete_service(s, job)

    # Condition types whose true-transitions get a lifecycle Event; Warning
    # severity for the two that mean something went wrong.
    _EVENTED_CONDITIONS = (
        (JobConditionType.CREATED, "Normal"),
        (JobConditionType.RUNNING, "Normal"),
        (JobConditionType.SUCCEEDED, "Normal"),
        (JobConditionType.FAILED, "Warning"),
        (JobConditionType.RESTARTING, "Warning"),
        (JobConditionType.SUSPENDED, "Normal"),
    )

    def _observe_transitions(self, job: Job, prev_status: capi.JobStatus) -> None:
        """Uniform lifecycle Events + timeline spans from condition
        transitions, for EVERY job kind (the reference emits Events ad hoc
        per controller; `describe` needs a complete stream for a plain
        preset job). Runs once per status change, in _write_status, so all
        reconcile exit paths are covered."""
        status = job.status
        created = job.metadata.creation_time
        for cond_type, severity in self._EVENTED_CONDITIONS:
            cond = capi.get_condition(status, cond_type)
            was_true = capi.has_condition(prev_status, cond_type)
            if cond is not None and cond.status and not was_true:
                self._event(job, severity, cond.reason, cond.message)
                at = cond.last_transition_time
                tl = self.api.timelines
                if cond_type == JobConditionType.CREATED:
                    tl.mark(job.namespace, job.name, job.uid, "created", t=at)
                elif cond_type == JobConditionType.RUNNING:
                    # First run only: a restart clears RUNNING (Restarting
                    # is mutually exclusive with it), so the post-restart
                    # re-transition would otherwise re-observe
                    # creation->now — polluting the histogram with
                    # restart-recovery durations and duplicating the span.
                    first_run = (
                        capi.get_condition(prev_status, JobConditionType.RESTARTING) is None
                        and core.job_recreate_restarts(job) == 0
                    )
                    if first_run:
                        start = created if created is not None else at
                        metrics.job_time_to_running_seconds.observe(max(0.0, at - start))
                        # Windowed twin for the SLO burn-rate evaluator,
                        # keyed by tenancy queue so per-queue objectives
                        # slice without a store walk at evaluation time.
                        pg = self.api.try_get("PodGroup", job.namespace, job.name)
                        metrics.slo_time_to_running_window.observe(
                            max(0.0, at - start),
                            getattr(pg, "queue", "") or "",
                            job.kind,
                            now=at,
                        )
                        tl.record_span(
                            job.namespace, job.name, job.uid, "time_to_running",
                            start=start, end=at, kind=job.kind,
                        )
                elif cond_type in (JobConditionType.SUCCEEDED, JobConditionType.FAILED):
                    start = created if created is not None else at
                    tl.record_span(
                        job.namespace, job.name, job.uid, "total",
                        start=start, end=at, kind=job.kind,
                        outcome=cond_type.value,
                    )
            elif (
                cond_type == JobConditionType.SUSPENDED
                and was_true
                and cond is not None
                and not cond.status
            ):
                # Explicit resume (Suspended flipped to False) — distinct
                # from the condition being filtered out by a phase change.
                self._event(job, "Normal", cond.reason, cond.message)

    def _write_status(self, job: Job, prev_status: Optional[capi.JobStatus] = None) -> None:
        """Optimistic-concurrency status write with one re-get retry,
        skipped when the pass didn't change anything
        (reference UpdateJobStatusInApiServer, common/job.go:360)."""
        if prev_status is not None and prev_status == job.status:
            return
        if prev_status is not None:
            self._observe_transitions(job, prev_status)
        job.status.last_reconcile_time = self.now()
        try:
            self.api.update(job, status_only=True)
        except NotFoundError:
            return  # job deleted mid-reconcile (e.g. TTL GC in this pass)
        except ConflictError:
            # Shared graft arm (carries the restart-budget annotation bump
            # through the retry, not just status — see graft_status_retry).
            from training_operator_tpu_torch.cluster.apiserver import graft_status_retry

            graft_status_retry(self.api.try_get, self.api.update, job)
        if capi.is_finished(job.status):
            # Terminal-condition flush hook (wire protocol v2): a coalescing
            # API client buffers status writes until its window/tick flush —
            # fine for intermediate tallies, wrong for the job's closing
            # chapter, which SDK pollers and TTL timers key off. Push it out
            # now. No-op on the in-process APIServer (no flush_writes).
            flush = getattr(self.api, "flush_writes", None)
            if flush is not None:
                flush()

    def _event(self, job: Job, etype: str, reason: str, message: str) -> None:
        self.api.record_event(
            Event(
                object_kind=job.kind,
                object_name=job.name,
                namespace=job.namespace,
                event_type=etype,
                reason=reason,
                message=message,
                timestamp=self.now(),
            )
        )
