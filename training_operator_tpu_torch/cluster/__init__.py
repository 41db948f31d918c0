"""Virtual cluster substrate.

The reference delegates to the Kubernetes API server + scheduler + kubelet
(SURVEY.md §1 "substrate" layer). This package is the TPU-native equivalent:
an in-process, deterministic substrate with the same object model (Pods,
Services, Nodes, PodGroups, ConfigMaps, Events), watch streams, optimistic
concurrency, a default scheduler, and a virtual kubelet that runs pods —
either simulated (tests/bench set phases, like envtest where "pods never run")
or for-real (subprocess execution for e2e).

Nodes carry accelerator inventory with physical topology (TPU slice / ICI
coordinates, GPU NVLink domains) — the information the tpu-packer placement
engine scores. The reference only ever sees opaque `nvidia.com/gpu` counts
(mpi/mpijob.go:193-205); topology-awareness is the point of this design.
"""

from training_operator_tpu_torch.cluster.objects import (
    Event,
    Node,
    Pod,
    PodGroup,
    PodPhase,
    Service,
)
from training_operator_tpu_torch.cluster.apiserver import APIServer, WatchEvent
from training_operator_tpu_torch.cluster.runtime import Cluster

__all__ = [
    "APIServer",
    "Cluster",
    "Event",
    "Node",
    "Pod",
    "PodGroup",
    "PodPhase",
    "Service",
    "WatchEvent",
]
