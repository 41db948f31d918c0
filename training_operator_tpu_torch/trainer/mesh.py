"""The device mesh: TPU_MESH_AXES -> a torch DeviceMesh over the process group.

Counterpart of training_operator_tpu/trainer/mesh.py. The operator exports
the requested logical mesh as TPU_MESH_AXES; the trainer builds it here with
`init_device_mesh` over all six axes of AXIS_ORDER, row-major, so rank r sits
at the coordinate where the JAX `build_mesh` puts device r. One process owns
one device, so the mesh's size is the world size.

Unlike the JAX `mesh_from_env`, nothing falls back: a mesh the world cannot
fill raises, and so does `pipeline` with `sequence` (the JAX pipeline refuses
that pair when it runs, pipeline.py:56-60; the port when the mesh is built).

On a pipeline mesh a batch rank's rows are its share of every microbatch
(`batch_rows`): microbatch j is rows j*mb .. (j+1)*mb - 1 of the global
batch, as the JAX schedule cuts it (pipeline.py:83), and batch rank r holds
the r-th block of each, so the ranks' tokens in rank order are each
microbatch's tokens in the global order that MoE capacity counts in.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
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

PIPELINE_WITH_SEQUENCE = ("pipeline and sequence (ring attention) axes are mutually "
                          "exclusive; shard long sequences within a stage instead")


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
    whose world size must equal `spec.size()`. Raises ValueError for
    `pipeline` with `sequence`."""
    if spec.axes.get("pipeline", 1) > 1 and spec.axes.get("sequence", 1) > 1:
        raise ValueError(PIPELINE_WITH_SEQUENCE)
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


def batch_rows(mesh: DeviceMesh, rows: int, microbatches: int = 0) -> np.ndarray:
    """The rows of a global batch of `rows` that this rank holds, in order:
    the block at its batch coordinate, or on a pipeline mesh that block of
    every one of the `microbatches` (0: one per stage, JAX
    `pipeline_microbatches or n_stages`; the module docstring). Raises when
    the batch does not divide by the microbatches or a block by the batch
    axes."""
    index, count = batch_coordinate(mesh)
    stages = axis_size(mesh, "pipeline")
    m = 1 if stages == 1 else (microbatches or stages)
    if rows % m:
        raise ValueError(f"batch {rows} not divisible by microbatches {m}")
    mb = rows // m
    if mb % count:
        what = f"microbatch of {mb} rows" if m > 1 else f"batch of {rows} rows"
        raise ValueError(f"{what} does not split over the batch axes {BATCH_AXES} "
                         f"({count} shards)")
    per = mb // count
    return (np.arange(m)[:, None] * mb + index * per + np.arange(per)).reshape(-1)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh,
                microbatches: int = 0) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch: every [B, S] entry's rows by
    `batch_rows` (`microbatches` is the config's `pipeline_microbatches`,
    read on a pipeline mesh only) and its positions by
    `sequence_coordinate`. Raises when the batch does not split."""
    s_index, s_count = sequence_coordinate(mesh)
    out = {}
    for name, t in batch.items():
        rows = batch_rows(mesh, t.shape[0], microbatches)
        if rows[-1] - rows[0] + 1 == rows.size:  # one block: a view
            t = t[rows[0]:rows[-1] + 1]
        else:
            t = t[torch.from_numpy(rows).to(t.device)]
        if s_count > 1:
            check_sequence(t.shape[1], mesh)
            t = t.chunk(s_count, 1)[s_index]
        out[name] = t
    return out


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis: size} over AXIS_ORDER, as the JAX `dict(mesh.shape)` prints."""
    return {n: axis_size(mesh, n) for n in mesh.mesh_dim_names}
