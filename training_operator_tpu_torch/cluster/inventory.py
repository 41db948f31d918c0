"""Device inventory: TPU slice pools, GPU pools, CPU pools.

The reference understands accelerators only as opaque extended-resource counts
(`nvidia.com/gpu`, mpi/mpijob.go:193-205). Here nodes carry *physical topology*:
TPU hosts know which slice they belong to and where their chips sit in the
slice's ICI grid; GPU nodes know their NVLink domain. This inventory is the
"device" axis of the (jobs x nodes x devices) tensor the tpu-packer solves over.

Fake inventory generation is a build prerequisite, not an afterthought
(SURVEY.md §7 hard part (f)): every scheduler/bench path must run with zero
real accelerators.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from training_operator_tpu_torch.api.jobs import ObjectMeta
from training_operator_tpu_torch.cluster.objects import AcceleratorInfo, Node

TPU_RESOURCE = "tpu.dev/chips"
GPU_RESOURCE = "nvidia.com/gpu"

# Node labels the placement engine reads/writes.
LABEL_TPU_SLICE = "tpu.dev/slice"
LABEL_TPU_TYPE = "tpu.dev/type"
LABEL_TPU_TOPOLOGY = "tpu.dev/slice-topology"
LABEL_TPU_HOST_INDEX = "tpu.dev/host-index"
LABEL_NVLINK_DOMAIN = "gpu.dev/nvlink-domain"
LABEL_HOSTNAME = "kubernetes.io/hostname"


def parse_topology(topology: str) -> List[int]:
    return [int(x) for x in topology.lower().split("x")]


def accel_family(accelerator: str) -> str:
    """"v5e-8" -> "v5e": the family the packer matches slices on. One copy
    (scheduler/snapshot.py and the spec analyzer both consume it), so lint
    and placement can never disagree about what "matching" means."""
    return accelerator.rsplit("-", 1)[0] if "-" in accelerator else accelerator


# Memo for try_parse_topology: the admission analyzer parses each node's
# topology label, so a 10k-node inventory re-parses the same handful of
# strings millions of times over a sustained run. Values are tuples (or
# None); callers get a fresh list so the memo can never be mutated through
# a returned value. Bounded: label data is untrusted input.
_TOPOLOGY_MEMO: dict = {}
_TOPOLOGY_MEMO_MAX = 1024


def try_parse_topology(topology: str) -> Optional[List[int]]:
    """parse_topology for untrusted input (lint/admission paths): None on
    malformed or non-positive dims instead of ValueError."""
    # Non-str input must fall through to the hardened parse, not hash-fail
    # at the memo probe (the contract is None-on-anything-malformed).
    memoizable = isinstance(topology, str)
    if memoizable and topology in _TOPOLOGY_MEMO:
        hit = _TOPOLOGY_MEMO[topology]
        return None if hit is None else list(hit)
    try:
        dims = parse_topology(topology)
    except (ValueError, AttributeError, TypeError):
        dims = None
    if dims is not None and (not dims or any(d < 1 for d in dims)):
        dims = None
    if memoizable and len(_TOPOLOGY_MEMO) < _TOPOLOGY_MEMO_MAX:
        _TOPOLOGY_MEMO[topology] = None if dims is None else tuple(dims)
    return dims


def topology_chips(topology: str) -> int:
    n = 1
    for d in parse_topology(topology):
        n *= d
    return n


def make_tpu_slice(
    slice_id: str,
    slice_topology: str = "4x4",
    chips_per_host: int = 4,
    tpu_type: str = "v5e",
    cpu_per_host: float = 112.0,
    mem_per_host: float = 192.0,
) -> List[Node]:
    """Build the hosts of one TPU slice.

    Chips form a `slice_topology` grid (e.g. 4x4 = 16 chips); each host owns a
    contiguous block of `chips_per_host` chips along the minor axis (the
    physical v5e layout: a 4x4 slice has 4 hosts, each a 1x4 chip row). A
    host's `ici_coords` is the grid origin of its chip block.
    """
    dims = parse_topology(slice_topology)
    total = topology_chips(slice_topology)
    if total % chips_per_host:
        raise ValueError(f"{slice_topology} not divisible into hosts of {chips_per_host}")
    n_hosts = total // chips_per_host
    minor = dims[-1]
    if chips_per_host % minor and minor % chips_per_host:
        raise ValueError(f"chips_per_host={chips_per_host} must tile minor axis {minor}")

    nodes = []
    for h in range(n_hosts):
        # Origin of host h's chip block in row-major grid order.
        flat = h * chips_per_host
        coords = []
        rem = flat
        for d in reversed(dims):
            coords.append(rem % d)
            rem //= d
        coords.reverse()
        name = f"{slice_id}-host-{h}"
        nodes.append(
            Node(
                metadata=ObjectMeta(
                    name=name,
                    namespace="",
                    labels={
                        LABEL_HOSTNAME: name,
                        LABEL_TPU_SLICE: slice_id,
                        LABEL_TPU_TYPE: tpu_type,
                        LABEL_TPU_TOPOLOGY: slice_topology,
                        LABEL_TPU_HOST_INDEX: str(h),
                    },
                ),
                capacity={"cpu": cpu_per_host, "memory": mem_per_host, TPU_RESOURCE: float(chips_per_host)},
                accelerator=AcceleratorInfo(
                    kind="tpu",
                    chips=chips_per_host,
                    tpu_type=tpu_type,
                    tpu_slice=slice_id,
                    slice_topology=slice_topology,
                    ici_coords=coords,
                ),
            )
        )
    return nodes


def make_tpu_pool(
    num_slices: int,
    slice_topology: str = "4x4",
    chips_per_host: int = 4,
    tpu_type: str = "v5e",
    slice_prefix: str = "slice",
) -> List[Node]:
    nodes: List[Node] = []
    for s in range(num_slices):
        nodes.extend(
            make_tpu_slice(f"{slice_prefix}-{s}", slice_topology, chips_per_host, tpu_type)
        )
    return nodes


def make_gpu_pool(
    num_nodes: int,
    gpus_per_node: int = 8,
    nodes_per_nvlink_domain: int = 4,
    prefix: str = "gpu",
    cpu_per_node: float = 96.0,
    mem_per_node: float = 1024.0,
) -> List[Node]:
    nodes = []
    for i in range(num_nodes):
        domain = f"nvl-{i // nodes_per_nvlink_domain}"
        name = f"{prefix}-{i}"
        nodes.append(
            Node(
                metadata=ObjectMeta(
                    name=name,
                    namespace="",
                    labels={LABEL_HOSTNAME: name, LABEL_NVLINK_DOMAIN: domain},
                ),
                capacity={"cpu": cpu_per_node, "memory": mem_per_node, GPU_RESOURCE: float(gpus_per_node)},
                accelerator=AcceleratorInfo(kind="gpu", chips=gpus_per_node, nvlink_domain=domain),
            )
        )
    return nodes


def make_cpu_pool(
    num_nodes: int, prefix: str = "cpu", cpu_per_node: float = 64.0, mem_per_node: float = 256.0
) -> List[Node]:
    return [
        Node(
            metadata=ObjectMeta(
                name=f"{prefix}-{i}",
                namespace="",
                labels={LABEL_HOSTNAME: f"{prefix}-{i}"},
            ),
            capacity={"cpu": cpu_per_node, "memory": mem_per_node},
        )
        for i in range(num_nodes)
    ]
