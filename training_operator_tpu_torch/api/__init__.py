"""API layer: declarative job data model, defaulting, and validation.

Parity target: pkg/apis/kubeflow.org/v1 (common_types.go, <framework>_types.go) and
pkg/apis/kubeflow.org/v2alpha1 (trainjob_types.go, trainingruntime_types.go) in the
reference, re-designed as plain Python dataclasses with explicit defaulting and
validation passes (the reference performs these in admission webhooks).
"""

from training_operator_tpu_torch.api.common import (
    CleanPodPolicy,
    JobCondition,
    JobConditionType,
    JobStatus,
    ReplicaSpec,
    ReplicaStatus,
    RestartPolicy,
    RunPolicy,
    SchedulingPolicy,
)
from training_operator_tpu_torch.api.jobs import (
    ElasticPolicy,
    JAXJob,
    Job,
    MPIJob,
    PaddleJob,
    PyTorchJob,
    TFJob,
    XGBoostJob,
)

__all__ = [
    "CleanPodPolicy",
    "ElasticPolicy",
    "JAXJob",
    "Job",
    "JobCondition",
    "JobConditionType",
    "JobStatus",
    "MPIJob",
    "PaddleJob",
    "PyTorchJob",
    "ReplicaSpec",
    "ReplicaStatus",
    "RestartPolicy",
    "RunPolicy",
    "SchedulingPolicy",
    "TFJob",
    "XGBoostJob",
]
