"""Node records and the pools the port's placer reads.

Counterpart of training_operator_tpu/cluster/inventory.py (`TPU_RESOURCE`,
`GPU_RESOURCE`, `parse_topology`, `accel_family` and the pool functions
`make_tpu_slice`, `make_tpu_pool`, `make_gpu_pool`, `make_cpu_pool`) and of
cluster/objects.py's `node_ready`, `toleration_key` and `tolerates`, kept
here as copies so the port imports nothing of the JAX package.

A node is a plain record, not an API object: its name, capacity, physical
accelerator (kind; for a TPU host its type, slice, the slice's chip grid,
its chips and its index along the slice's host axis; for a GPU node its
NVLink domain), taints, and whether it is cordoned or not ready. The JAX
package keeps the host index in a label and readiness in conditions; here
they are fields.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

TPU_RESOURCE = "tpu.dev/chips"
GPU_RESOURCE = "nvidia.com/gpu"


def parse_topology(topology: str) -> List[int]:
    return [int(x) for x in topology.lower().split("x")]


def accel_family(accelerator: str) -> str:
    """"v5e-8" -> "v5e": the family the placer matches slices on."""
    return accelerator.rsplit("-", 1)[0] if "-" in accelerator else accelerator


@dataclass
class AcceleratorInfo:
    """Physical accelerator of a node. TPU hosts: `tpu_slice` names the
    slice, `slice_topology` its chip grid, `host_index` the host's place
    along the slice's host axis (host i owns the i-th block of `chips`
    chips). GPU nodes: `nvlink_domain` names the NVLink island."""

    kind: str = ""  # "tpu" | "gpu" | ""
    chips: int = 0
    tpu_type: str = ""
    tpu_slice: str = ""
    slice_topology: str = ""
    host_index: int = 0
    nvlink_domain: str = ""


@dataclass
class Node:
    name: str
    capacity: Dict[str, float] = field(default_factory=dict)
    accelerator: AcceleratorInfo = field(default_factory=AcceleratorInfo)
    # k8s-shaped dicts {"key", "value", "effect"}; NoSchedule and NoExecute
    # taints keep off every gang whose tolerations do not cover them.
    taints: List[Dict[str, Any]] = field(default_factory=list)
    unschedulable: bool = False
    ready: bool = True


def node_ready(node: Node) -> bool:
    """A node that is not ready contributes no free capacity."""
    return node.ready


def toleration_key(t: Dict[str, Any]) -> tuple:
    """Canonical hashable form of one toleration or taint dict: the form of
    the placer's class identity and cache signatures."""
    return tuple(sorted(t.items()))


def toleration_sig(entries) -> tuple:
    """Canonical hashable form of a list of tolerations or taints."""
    return tuple(sorted(toleration_key(t) for t in entries or ()))


def tolerates(taints: List[Dict[str, Any]], tolerations: List[Dict[str, Any]]) -> bool:
    """k8s taint/toleration matching: every NoSchedule/NoExecute taint must
    be covered by some toleration (Exists matches any value; Equal requires
    the value; an empty key with Exists tolerates everything; an empty
    effect matches every effect)."""

    def covered(taint: Dict[str, Any]) -> bool:
        for tol in tolerations:
            op = tol.get("operator", "Equal")
            if tol.get("effect") and tol.get("effect") != taint.get("effect"):
                continue
            if not tol.get("key"):
                if op == "Exists":
                    return True
                continue
            if tol.get("key") != taint.get("key"):
                continue
            if op == "Exists" or tol.get("value") == taint.get("value"):
                return True
        return False

    return all(
        covered(t)
        for t in taints
        if t.get("effect") in ("NoSchedule", "NoExecute")
    )


def topology_chips(topology: str) -> int:
    n = 1
    for d in parse_topology(topology):
        n *= d
    return n


def make_tpu_slice(slice_id: str, slice_topology: str = "4x4", chips_per_host: int = 4,
                   tpu_type: str = "v5e", cpu_per_host: float = 112.0,
                   mem_per_host: float = 192.0) -> List[Node]:
    """The hosts of one TPU slice: `slice_topology` chips, each host a
    contiguous block of `chips_per_host` along the grid's minor axis."""
    dims = parse_topology(slice_topology)
    total = topology_chips(slice_topology)
    if total % chips_per_host:
        raise ValueError(f"{slice_topology} not divisible into hosts of {chips_per_host}")
    minor = dims[-1]
    if chips_per_host % minor and minor % chips_per_host:
        raise ValueError(f"chips_per_host={chips_per_host} must tile minor axis {minor}")
    return [
        Node(
            name=f"{slice_id}-host-{h}",
            capacity={"cpu": cpu_per_host, "memory": mem_per_host,
                      TPU_RESOURCE: float(chips_per_host)},
            accelerator=AcceleratorInfo(kind="tpu", chips=chips_per_host, tpu_type=tpu_type,
                                        tpu_slice=slice_id, slice_topology=slice_topology,
                                        host_index=h),
        )
        for h in range(total // chips_per_host)
    ]


def make_tpu_pool(num_slices: int, slice_topology: str = "4x4", chips_per_host: int = 4,
                  tpu_type: str = "v5e", slice_prefix: str = "slice") -> List[Node]:
    nodes: List[Node] = []
    for s in range(num_slices):
        nodes.extend(make_tpu_slice(f"{slice_prefix}-{s}", slice_topology, chips_per_host,
                                    tpu_type))
    return nodes


def make_gpu_pool(num_nodes: int, gpus_per_node: int = 8, nodes_per_nvlink_domain: int = 4,
                  prefix: str = "gpu", cpu_per_node: float = 96.0,
                  mem_per_node: float = 1024.0) -> List[Node]:
    return [
        Node(
            name=f"{prefix}-{i}",
            capacity={"cpu": cpu_per_node, "memory": mem_per_node,
                      GPU_RESOURCE: float(gpus_per_node)},
            accelerator=AcceleratorInfo(kind="gpu", chips=gpus_per_node,
                                        nvlink_domain=f"nvl-{i // nodes_per_nvlink_domain}"),
        )
        for i in range(num_nodes)
    ]


def make_cpu_pool(num_nodes: int, prefix: str = "cpu", cpu_per_node: float = 64.0,
                  mem_per_node: float = 256.0) -> List[Node]:
    return [Node(name=f"{prefix}-{i}", capacity={"cpu": cpu_per_node, "memory": mem_per_node})
            for i in range(num_nodes)]
