"""The v1-generation job kinds: JAXJob (primary), PyTorchJob, TFJob, XGBoostJob,
PaddleJob, MPIJob.

Parity target: reference pkg/apis/kubeflow.org/v1/{jax,pytorch,tensorflow,
xgboost,paddlepaddle,mpi}_types.go. Each kind is a thin declarative wrapper
around a map of replica-type -> ReplicaSpec plus a RunPolicy and kind-specific
policy knobs (ElasticPolicy, SuccessPolicy, SlotsPerWorker, ...).

TPU-first extension: every job may carry a `TPUPolicy` describing the slice/mesh
it wants (accelerator type, topology, mesh axes). The reference has no such
surface — its unit of parallelism is the replica (SURVEY.md §2.3); here mesh
axes are first-class so the placement engine can score ICI contiguity.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from training_operator_tpu_torch.api.common import (
    JobStatus,
    ReplicaSpec,
    RunPolicy,
)

# Canonical replica-type names (reference <fw>_types.go constants).
REPLICA_MASTER = "Master"
REPLICA_WORKER = "Worker"
REPLICA_CHIEF = "Chief"
REPLICA_PS = "PS"
REPLICA_EVALUATOR = "Evaluator"
REPLICA_LAUNCHER = "Launcher"


@dataclass
class ObjectMeta:
    """Kubernetes-style object metadata for all API objects."""

    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    creation_time: Optional[float] = None
    deletion_time: Optional[float] = None
    resource_version: int = 0
    owner_uid: Optional[str] = None

    _uid_counter = itertools.count(1)

    def ensure_uid(self, kind: str) -> None:
        if not self.uid:
            self.uid = f"{kind.lower()}-{self.namespace}-{self.name}-{next(ObjectMeta._uid_counter)}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "namespace": self.namespace,
            "uid": self.uid,
            "labels": dict(self.labels),
            "annotations": dict(self.annotations),
            "creationTime": self.creation_time,
            "deletionTime": self.deletion_time,
            "resourceVersion": self.resource_version,
            "ownerUid": self.owner_uid,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid", ""),
            labels=dict(d.get("labels", {})),
            annotations=dict(d.get("annotations", {})),
            creation_time=d.get("creationTime"),
            deletion_time=d.get("deletionTime"),
            resource_version=d.get("resourceVersion", 0),
            owner_uid=d.get("ownerUid"),
        )


# ---------------------------------------------------------------------------
# TPU policy — the TPU-first extension (no reference analogue; SURVEY.md §2.3)
# ---------------------------------------------------------------------------


@dataclass
class TPUPolicy:
    """Declarative TPU slice / mesh request.

    accelerator: slice type, e.g. "v5e-8", "v5p-16".
    topology: requested physical ICI topology, e.g. "2x4" (chips per axis).
    num_slices: how many slices (multi-slice over DCN).
    mesh_axes: logical mesh axis names -> sizes, e.g. {"data": 2, "fsdp": 2,
        "tensor": 2}; product must equal total chips. Consumed by the trainer
        runtime to build a jax.sharding.Mesh and by tpu-packer to prefer
        contiguous ICI placements that realize these axes physically.
    """

    accelerator: str = "v5e-8"
    topology: Optional[str] = None
    num_slices: int = 1
    mesh_axes: Dict[str, int] = field(default_factory=dict)

    def chips_per_slice(self) -> int:
        if self.topology:
            dims = [int(x) for x in self.topology.lower().split("x")]
            prod = 1
            for x in dims:
                prod *= x
            return prod
        # "v5e-8" -> 8
        try:
            return int(self.accelerator.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return 1

    def total_chips(self) -> int:
        return self.chips_per_slice() * self.num_slices

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TPUPolicy":
        return cls(
            accelerator=d.get("accelerator", "v5e-8"),
            topology=d.get("topology"),
            num_slices=d.get("num_slices", 1),
            mesh_axes=dict(d.get("mesh_axes", {})),
        )


# ---------------------------------------------------------------------------
# Kind-specific policies
# ---------------------------------------------------------------------------


class RDZVBackend(str, enum.Enum):
    C10D = "c10d"
    ETCD = "etcd"
    ETCD_V2 = "etcd-v2"


@dataclass
class RDZVConf:
    key: str = ""
    value: str = ""


@dataclass
class ElasticPolicy:
    """Elastic (torchrun) policy (reference pytorch_types.go:98-141)."""

    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None
    rdzv_backend: Optional[RDZVBackend] = None
    rdzv_port: Optional[int] = None
    rdzv_host: Optional[str] = None
    rdzv_id: Optional[str] = None
    rdzv_conf: List[RDZVConf] = field(default_factory=list)
    standalone: Optional[bool] = None
    n_proc_per_node: Optional[int] = None
    max_restarts: Optional[int] = None
    # Metric specs driving the HPA-equivalent autoscaler: list of
    # {"name": ..., "target": float} utilization targets.
    metrics: List[Dict[str, Any]] = field(default_factory=list)


class SuccessPolicy(str, enum.Enum):
    """TFJob success policy (reference tensorflow_types.go:93-99)."""

    DEFAULT = ""
    ALL_WORKERS = "AllWorkers"


class MPIImplementation(str, enum.Enum):
    OPENMPI = "OpenMPI"
    INTEL = "Intel"
    MPICH = "MPICH"


# ---------------------------------------------------------------------------
# Job kinds
# ---------------------------------------------------------------------------


@dataclass
class Job:
    """Base declarative job: kind + metadata + replica specs + run policy.

    Concrete kinds add their policy knobs. `replica_specs` maps replica-type
    name (e.g. "Master", "Worker") to a ReplicaSpec, mirroring the reference's
    `<FW>ReplicaSpecs` maps.
    """

    KIND = "Job"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    replica_specs: Dict[str, ReplicaSpec] = field(default_factory=dict)
    run_policy: RunPolicy = field(default_factory=RunPolicy)
    tpu_policy: Optional[TPUPolicy] = None
    status: JobStatus = field(default_factory=JobStatus)

    @property
    def kind(self) -> str:
        return type(self).KIND

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def total_replicas(self) -> int:
        return sum(rs.replicas or 0 for rs in self.replica_specs.values())


@dataclass
class JAXJob(Job):
    """Distributed JAX job (reference jax_types.go:22-79).

    Worker-only: worker-0 is the coordinator (`jax.distributed.initialize`),
    reachable on `coordinator_port` (reference default 6666).
    This is the primary kind of the TPU-native framework.
    """

    KIND = "JAXJob"
    DEFAULT_PORT = 6666
    DEFAULT_PORT_NAME = "jaxjob-port"

    coordinator_port: int = DEFAULT_PORT


@dataclass
class PyTorchJob(Job):
    """PyTorch DDP/elastic job (reference pytorch_types.go:56-151)."""

    KIND = "PyTorchJob"
    DEFAULT_PORT = 23456
    DEFAULT_PORT_NAME = "pytorchjob-port"

    elastic_policy: Optional[ElasticPolicy] = None
    nproc_per_node: Optional[int] = None


@dataclass
class TFJob(Job):
    """TensorFlow job with PS/Worker/Chief/Master/Evaluator replicas
    (reference tensorflow_types.go:49-119)."""

    KIND = "TFJob"
    DEFAULT_PORT = 2222
    DEFAULT_PORT_NAME = "tfjob-port"

    success_policy: SuccessPolicy = SuccessPolicy.DEFAULT
    enable_dynamic_worker: bool = False


@dataclass
class XGBoostJob(Job):
    """XGBoost job with Rabit tracker bootstrap (reference xgboost_types.go)."""

    KIND = "XGBoostJob"
    DEFAULT_PORT = 9999
    DEFAULT_PORT_NAME = "xgboostjob-port"


@dataclass
class PaddleJob(Job):
    """PaddlePaddle collective job (reference paddlepaddle_types.go)."""

    KIND = "PaddleJob"
    DEFAULT_PORT = 37777
    DEFAULT_PORT_NAME = "paddlejob-port"


@dataclass
class MPIJob(Job):
    """MPI launcher/worker job (reference mpi_types.go).

    The TPU-native runtime drops the reference's `kubectl exec` rsh-agent hack
    (mpi/mpijob_controller.go:1227-1299) in favour of a hostfile + per-job
    ssh-less exec channel provided by the virtual substrate; slots_per_worker
    and the OpenMPI/Intel/MPICH env contracts are preserved.
    """

    KIND = "MPIJob"

    slots_per_worker: int = 1
    clean_pod_policy: Optional[str] = None
    main_container: str = ""
    mpi_implementation: MPIImplementation = MPIImplementation.OPENMPI
    run_launcher_as_node: bool = False


JOB_KINDS: Dict[str, type] = {
    k.KIND: k for k in (JAXJob, PyTorchJob, TFJob, XGBoostJob, PaddleJob, MPIJob)
}


def replica_types_for_kind(kind: str) -> List[str]:
    """Valid replica types per kind (reference <fw>_types.go constants)."""
    return {
        "JAXJob": [REPLICA_WORKER],
        "PyTorchJob": [REPLICA_MASTER, REPLICA_WORKER],
        "TFJob": [REPLICA_CHIEF, REPLICA_MASTER, REPLICA_PS, REPLICA_WORKER, REPLICA_EVALUATOR],
        "XGBoostJob": [REPLICA_MASTER, REPLICA_WORKER],
        "PaddleJob": [REPLICA_MASTER, REPLICA_WORKER],
        "MPIJob": [REPLICA_LAUNCHER, REPLICA_WORKER],
    }[kind]
