"""The device mesh: TPU_MESH_AXES -> a torch DeviceMesh over the process group.

Counterpart of training_operator_tpu/trainer/mesh.py. The operator exports
the requested logical mesh as TPU_MESH_AXES; the trainer builds it here with
`init_device_mesh` over all six axes of AXIS_ORDER, row-major, so rank r sits
at the coordinate where the JAX `build_mesh` puts device r. One process owns
one device, so the mesh's size is the world size.

Unlike the JAX `mesh_from_env`, nothing falls back: a mesh the world cannot
fill raises, and so does an axis whose parallelism is not ported yet
(`pipeline`, `expert` larger than 1).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_ORDER = ("pipeline", "data", "fsdp", "expert", "sequence", "tensor")

# Batch dims shard over every data-parallel-like axis (the JAX BATCH_AXES).
BATCH_AXES = ("data", "fsdp", "expert")

# The axes that split a batch's tokens: its rows over BATCH_AXES, its
# sequence over `sequence` (the JAX batch_sharding, P(BATCH_AXES,
# "sequence")). Sums over the tokens (the loss, the gradients) run over them.
TOKEN_AXES = BATCH_AXES + ("sequence",)

# Axes whose parallelism is not ported yet, with the ROADMAP item that ports it.
NOT_PORTED = {"pipeline": 12, "expert": 13}


@dataclass
class MeshSpec:
    """Logical mesh request: axis name -> size, in AXIS_ORDER."""

    axes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for name in self.axes:
            if name not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {name!r}; valid: {AXIS_ORDER}")

    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def dims(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((a, self.axes.get(a, 1)) for a in AXIS_ORDER)

    @classmethod
    def from_string(cls, s: str) -> "MeshSpec":
        """Parse "data=2,fsdp=2,tensor=2" (the TPU_MESH_AXES wire format)."""
        axes: Dict[str, int] = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            axes[k.strip()] = int(v)
        return cls(axes)

    @classmethod
    def for_devices(cls, n: int) -> "MeshSpec":
        """Default factorization when the job didn't pin axes: fsdp-major,
        with a tensor axis once the device count allows it."""
        if n <= 1:
            return cls({})
        tensor = 1
        while n % 2 == 0 and tensor < 4 and n > 2:
            tensor *= 2
            n //= 2
        return cls({"fsdp": n, "tensor": tensor})


def build_mesh(spec: MeshSpec, device_type: str) -> DeviceMesh:
    """The six-axis DeviceMesh of `spec` over the default process group,
    whose world size must equal `spec.size()`. Raises NotImplementedError
    for an axis that is not ported yet."""
    for axis, item in NOT_PORTED.items():
        if spec.axes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh axis {axis}={spec.axes[axis]}: {axis} parallelism is not ported "
                f"yet (ROADMAP items 12-13; this axis is item {item})"
            )
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spec.size() != world:
        raise ValueError(f"mesh {spec.axes} needs {spec.size()} processes, the world has {world}")
    names = tuple(a for a, _ in spec.dims())
    sizes = tuple(s for _, s in spec.dims())
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def mesh_from_env(device_type: str = "cuda",
                  environ: Optional[Mapping[str, str]] = None) -> DeviceMesh:
    """The mesh a scheduled job uses: TPU_MESH_AXES if the operator set it,
    else `MeshSpec.for_devices(world_size)`. Needs an initialized process
    group (distributed.initialize)."""
    e = os.environ if environ is None else environ
    s = e.get("TPU_MESH_AXES", "")
    world = dist.get_world_size() if dist.is_initialized() else 1
    spec = MeshSpec.from_string(s) if s else MeshSpec.for_devices(world)
    return build_mesh(spec, device_type)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def batch_coordinate(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index, count) over BATCH_AXES, row-major: the slice of
    the global batch this rank holds, as the JAX `batch_sharding` lays the
    batch dim over (data, fsdp, expert). Ranks that differ only in another
    axis (tensor) share the coordinate and so the rows."""
    index, count = 0, 1
    for name in BATCH_AXES:
        size = axis_size(mesh, name)
        index = index * size + mesh.get_local_rank(name)
        count *= size
    return index, count


def sequence_coordinate(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index, count) over `sequence`: the slice of every row's
    positions this rank holds."""
    return mesh.get_local_rank("sequence"), axis_size(mesh, "sequence")


def check_sequence(seq: int, mesh: DeviceMesh) -> None:
    count = axis_size(mesh, "sequence")
    if seq % count:
        raise ValueError(f"sequence of {seq} positions does not split over "
                         f"sequence={count}")


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch: every [B, S] entry split on dim
    0 by `batch_coordinate` and on dim 1 by `sequence_coordinate`. Raises
    when the batch does not divide by the batch axes or its sequence by
    `sequence`."""
    index, count = batch_coordinate(mesh)
    s_index, s_count = sequence_coordinate(mesh)
    out = {}
    for name, t in batch.items():
        if t.shape[0] % count:
            raise ValueError(f"batch of {t.shape[0]} rows does not split over the batch "
                             f"axes {BATCH_AXES} ({count} shards)")
        t = t.chunk(count, 0)[index]
        if s_count > 1:
            check_sequence(t.shape[1], mesh)
            t = t.chunk(s_count, 1)[s_index]
        out[name] = t
    return out


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis: size} over AXIS_ORDER, as the JAX `dict(mesh.shape)` prints."""
    return {n: axis_size(mesh, n) for n in mesh.mesh_dim_names}
