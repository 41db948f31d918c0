"""Defaulting pass applied on admission and re-applied on reconcile.

Parity target: reference pkg/apis/kubeflow.org/v1/<fw>_defaults.go — default
replicas=1, default restart policy, default port injection, default
CleanPodPolicy/Suspend on RunPolicy — and `Scheme.Default` being re-applied at
the top of each reconcile (pytorchjob_controller.go:156).
"""

from __future__ import annotations

import time
from typing import Optional

from training_operator_tpu_torch.api.common import (
    CleanPodPolicy,
    Container,
    RestartPolicy,
)
from training_operator_tpu_torch.api.jobs import (
    JAXJob,
    Job,
    MPIJob,
    PaddleJob,
    PyTorchJob,
    TFJob,
    XGBoostJob,
)

# Default container name per kind (reference <fw>_types.go DefaultContainerName).
DEFAULT_CONTAINER_NAME = {
    "JAXJob": "jax",
    "PyTorchJob": "pytorch",
    "TFJob": "tensorflow",
    "XGBoostJob": "xgboost",
    "PaddleJob": "paddle",
    "MPIJob": "mpi",
    "TrainJob": "trainer",
}

DEFAULT_PORT = {
    "JAXJob": JAXJob.DEFAULT_PORT,
    "PyTorchJob": PyTorchJob.DEFAULT_PORT,
    "TFJob": TFJob.DEFAULT_PORT,
    "XGBoostJob": XGBoostJob.DEFAULT_PORT,
    "PaddleJob": PaddleJob.DEFAULT_PORT,
    "MPIJob": 0,  # MPI uses no Services (reference mpi controller)
}

DEFAULT_PORT_NAME = {
    "JAXJob": JAXJob.DEFAULT_PORT_NAME,
    "PyTorchJob": PyTorchJob.DEFAULT_PORT_NAME,
    "TFJob": TFJob.DEFAULT_PORT_NAME,
    "XGBoostJob": XGBoostJob.DEFAULT_PORT_NAME,
    "PaddleJob": PaddleJob.DEFAULT_PORT_NAME,
}

_DEFAULT_RESTART_POLICY = {
    # Reference: pytorch/tf/xgboost/paddle default OnFailure for workers;
    # MPI launcher defaults Never (reference mpi_defaults.go).
    "JAXJob": RestartPolicy.ON_FAILURE,
    "PyTorchJob": RestartPolicy.ON_FAILURE,
    "TFJob": RestartPolicy.ON_FAILURE,
    "XGBoostJob": RestartPolicy.ON_FAILURE,
    "PaddleJob": RestartPolicy.ON_FAILURE,
    "MPIJob": RestartPolicy.NEVER,
}


def default_job(job: Job, now: Optional[float] = None) -> Job:
    """Apply in-place defaulting; idempotent. Returns the job for chaining."""
    job.metadata.ensure_uid(job.kind)
    if job.metadata.creation_time is None:
        job.metadata.creation_time = time.time() if now is None else now

    if job.run_policy.clean_pod_policy is None:
        # Reference defaults CleanPodPolicy=None kind-dependently; v1 common
        # default is Running for MPI, None->All elsewhere in v2. We default to
        # Running to preserve failed pods for debugging, like mpi_defaults.go.
        job.run_policy.clean_pod_policy = (
            CleanPodPolicy.RUNNING if job.kind == "MPIJob" else CleanPodPolicy.NONE
        )

    for rtype, spec in job.replica_specs.items():
        if spec.replicas is None:
            spec.replicas = 1
        if spec.restart_policy is None:
            spec.restart_policy = _DEFAULT_RESTART_POLICY.get(
                job.kind, RestartPolicy.ON_FAILURE
            )
        _ensure_default_container(job, rtype)

    if isinstance(job, MPIJob) and not job.main_container:
        job.main_container = DEFAULT_CONTAINER_NAME["MPIJob"]
    if isinstance(job, PyTorchJob) and job.elastic_policy is not None:
        ep = job.elastic_policy
        if ep.max_restarts is None:
            ep.max_restarts = 10
        if ep.min_replicas is None:
            ep.min_replicas = job.replica_specs.get("Worker").replicas if job.replica_specs.get("Worker") else 1
        if ep.max_replicas is None:
            ep.max_replicas = ep.min_replicas
    return job


def _ensure_default_container(job: Job, rtype: str) -> None:
    spec = job.replica_specs[rtype]
    cname = DEFAULT_CONTAINER_NAME.get(job.kind, "trainer")
    if not spec.template.containers:
        spec.template.containers.append(Container(name=cname))
    port = DEFAULT_PORT.get(job.kind, 0)
    if isinstance(job, JAXJob):
        # The per-job coordinator_port knob IS the default port for JAXJobs;
        # injecting the static class default here would shadow it (the
        # controller's _port prefers the declared container port).
        port = job.coordinator_port
    pname = DEFAULT_PORT_NAME.get(job.kind)
    if port and pname:
        c = spec.template.main_container(cname)
        if c is not None and pname not in c.ports:
            c.ports[pname] = port
