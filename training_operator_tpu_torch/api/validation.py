"""Admission-time validation.

Parity target: reference pkg/webhooks/<fw>/<fw>_webhook.go validators and
pkg/common/util/webhooks.go:15-27 (RunPolicy validation), plus
mpi_validation.go:69. The reference runs these as validating admission
webhooks; here they are a pure function invoked by the API server on
create/update and available to the SDK for client-side checks.
"""

from __future__ import annotations

import re
from typing import List

from training_operator_tpu_torch.api.defaults import DEFAULT_CONTAINER_NAME
from training_operator_tpu_torch.api.jobs import (
    JOB_KINDS,
    Job,
    MPIJob,
    PyTorchJob,
    TFJob,
    replica_types_for_kind,
)

# RFC 1035 label: what the reference enforces on job names so the generated
# pod/service DNS names are valid (e.g. pytorchjob_webhook.go:44-60).
_DNS1035 = re.compile(r"^[a-z]([-a-z0-9]*[a-z0-9])?$")
_MAX_NAME_LEN = 63


def is_dns1035_label(name: str) -> bool:
    """The one copy of the name rule (webhooks and the spec analyzer must
    agree with v1 admission about what a legal name is)."""
    return bool(_DNS1035.match(name)) and len(name) <= _MAX_NAME_LEN


class ValidationError(ValueError):
    def __init__(self, errors: List[str]):
        self.errors = errors
        super().__init__("; ".join(errors))


def validate_job(job: Job) -> None:
    """Raise ValidationError listing every problem found."""
    errs: List[str] = []

    if not job.metadata.name:
        errs.append("metadata.name: required")
    elif not is_dns1035_label(job.metadata.name):
        errs.append(
            f"metadata.name: {job.metadata.name!r} must be a valid RFC1035 label "
            f"(lowercase alphanumeric/'-', start with a letter, <={_MAX_NAME_LEN} chars)"
        )

    if not job.replica_specs:
        errs.append("replicaSpecs: at least one replica type required")

    valid_types = set(replica_types_for_kind(job.kind)) if job.kind in JOB_KINDS else None
    default_container = DEFAULT_CONTAINER_NAME.get(job.kind, "trainer")

    for rtype, spec in job.replica_specs.items():
        path = f"replicaSpecs[{rtype}]"
        if valid_types is not None and rtype not in valid_types:
            errs.append(f"{path}: invalid replica type for {job.kind}; valid: {sorted(valid_types)}")
        if spec.replicas is not None and spec.replicas < 0:
            errs.append(f"{path}.replicas: must be >= 0")
        if not spec.template.containers:
            errs.append(f"{path}.template.containers: required")
            continue
        names = [c.name for c in spec.template.containers]
        if default_container not in names:
            errs.append(
                f"{path}.template.containers: must contain a container named "
                f"{default_container!r} (got {names})"
            )
        for c in spec.template.containers:
            if not c.image:
                errs.append(f"{path}.template.containers[{c.name}].image: required")

    _validate_run_policy(job, errs)
    _validate_kind_specific(job, errs)
    _validate_tpu_policy(job, errs)

    if errs:
        raise ValidationError(errs)


def _validate_run_policy(job: Job, errs: List[str]) -> None:
    """Reference pkg/common/util/webhooks.go:15-27."""
    rp = job.run_policy
    if rp.backoff_limit is not None and rp.backoff_limit < 0:
        errs.append("runPolicy.backoffLimit: must be >= 0")
    if rp.active_deadline_seconds is not None and rp.active_deadline_seconds < 0:
        errs.append("runPolicy.activeDeadlineSeconds: must be >= 0")
    if rp.ttl_seconds_after_finished is not None and rp.ttl_seconds_after_finished < 0:
        errs.append("runPolicy.ttlSecondsAfterFinished: must be >= 0")
    if rp.scheduling_policy and rp.scheduling_policy.min_available is not None:
        if rp.scheduling_policy.min_available < 0:
            errs.append("runPolicy.schedulingPolicy.minAvailable: must be >= 0")


def _validate_kind_specific(job: Job, errs: List[str]) -> None:
    if isinstance(job, PyTorchJob):
        ep = job.elastic_policy
        if ep is not None:
            if ep.min_replicas is not None and ep.min_replicas < 0:
                errs.append("elasticPolicy.minReplicas: must be >= 0")
            if (
                ep.min_replicas is not None
                and ep.max_replicas is not None
                and ep.max_replicas < ep.min_replicas
            ):
                errs.append("elasticPolicy.maxReplicas: must be >= minReplicas")
        if job.nproc_per_node is not None and job.nproc_per_node < 1:
            errs.append("nprocPerNode: must be >= 1")
    elif isinstance(job, TFJob):
        # Chief and Master are semantically equivalent; at most one of each.
        for t in ("Chief", "Master"):
            spec = job.replica_specs.get(t)
            if spec is not None and (spec.replicas or 0) > 1:
                errs.append(f"replicaSpecs[{t}].replicas: must be <= 1")
        if "Chief" in job.replica_specs and "Master" in job.replica_specs:
            errs.append("replicaSpecs: at most one of Chief/Master may be set")
    elif isinstance(job, MPIJob):
        # Reference mpi_validation.go:69 — exactly one launcher.
        launcher = job.replica_specs.get("Launcher")
        if launcher is None:
            errs.append("replicaSpecs[Launcher]: required for MPIJob")
        elif (launcher.replicas or 0) > 1:
            errs.append("replicaSpecs[Launcher].replicas: must be <= 1")
        if job.slots_per_worker < 1:
            errs.append("slotsPerWorker: must be >= 1")


def _validate_tpu_policy(job: Job, errs: List[str]) -> None:
    tp = job.tpu_policy
    if tp is None:
        return
    if tp.num_slices < 1:
        errs.append("tpuPolicy.numSlices: must be >= 1")
    elif tp.num_slices > 1:
        # Multi-slice gangs split workers contiguously across slices (the
        # packer's placement convention and the per-slice bootstrap env both
        # assume it); an indivisible worker count can never be placed.
        total = sum(spec.replicas or 0 for spec in job.replica_specs.values())
        if total and total % tp.num_slices:
            errs.append(
                f"tpuPolicy.numSlices: total replicas {total} must be divisible "
                f"by numSlices {tp.num_slices}"
            )
    if tp.topology is not None:
        if not re.match(r"^[1-9]\d*(x[1-9]\d*)*$", tp.topology.lower()):
            errs.append(
                f"tpuPolicy.topology: {tp.topology!r} must look like '2x4' with positive dims"
            )
        else:
            # Cross-check against the accelerator's chip count when it has one
            # (e.g. "v5e-8"): topology must tile exactly those chips.
            try:
                accel_chips = int(tp.accelerator.rsplit("-", 1)[1])
            except (IndexError, ValueError):
                accel_chips = None
            if accel_chips is not None:
                topo_chips = 1
                for x in tp.topology.lower().split("x"):
                    topo_chips *= int(x)
                if topo_chips != accel_chips:
                    errs.append(
                        f"tpuPolicy.topology: {tp.topology!r} has {topo_chips} chips but "
                        f"accelerator {tp.accelerator!r} has {accel_chips}"
                    )
    if tp.mesh_axes:
        prod = 1
        for v in tp.mesh_axes.values():
            prod *= v
        if prod != tp.total_chips():
            errs.append(
                f"tpuPolicy.meshAxes: product {prod} must equal total chips "
                f"{tp.total_chips()} ({tp.num_slices} slice(s) x {tp.chips_per_slice()})"
            )
