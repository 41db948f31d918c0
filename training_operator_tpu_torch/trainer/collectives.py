"""Collectives over the axes of a DeviceMesh, with their autograd rules.

The sharded model (model.py) computes on local shards and places every
collective itself, where the JAX package leaves that to XLA's partitioner:

- `gather`: the shards of a weight along one tensor dim, before the product
  that uses it (fsdp, and the embedding table's fsdp x tensor). Backward
  sums the gradient over the gathered batch axes (a reduce-scatter: each
  holds other rows of the batch) and keeps this rank's slice over the
  others (tensor peers compute the same complete gradient).
- `copy_to_tensor`: the input of a column-parallel product. Identity
  forward, all-reduce over `tensor` backward (each peer's product adds its
  part of the input's gradient): Megatron's f.
- `reduce_sum`: a sum over axes whose peers each hold a part, such as a
  row-parallel product's output over `tensor` or the loss numerator over the
  batch axes. All-reduce forward, identity backward (what follows is the
  same on every peer): Megatron's g.
- `all_to_all`: rows of dim 0 to the ranks of a group, in split sizes that
  may differ per rank (MoE dispatch over `expert`; Ulysses over `sequence`
  with equal splits). Backward is the inverse all-to-all.
- `token_prefix`: per row and column, the count of tokens before a rank's
  own in the global token order, over the ranks that split the tokens (the
  place MoE's queue resumes at on this rank).

Every rank runs the same collectives in the same order, recomputes under
remat included, since every rank runs the same program.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.trainer.mesh import (
    BATCH_AXES,
    axis_size,
    batch_coordinate,
    sequence_coordinate,
)

# The single-tensor collectives' names since torch 2.13; older releases
# have only the `_into_tensor` / `_tensor` names.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of `x` along `dim` from every rank on `axis`, in
    coordinate order, contiguous: a product then runs on the layout an
    unsharded weight has (another layout takes another GEMM, which rounds
    differently, and the embedding's row gather runs slower on it)."""
    n = axis_size(mesh, axis)
    out = x.new_empty((n,) + tuple(x.shape))  # the shards stacked on a new dim
    _all_gather_single(out.flatten(0, 1), x.contiguous(), group=mesh.get_group(axis))
    shape = list(x.shape)
    shape[dim] *= n
    # A copy only where the shards interleave (n > 1 and dim > 0).
    return out.movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """Sum of `x` over the ranks on `axis`, each keeping its slice of `dim`."""
    n = axis_size(mesh, axis)
    shape = list(x.shape)
    shape[dim] //= n
    # The slices stacked on a leading dim, the layout the collective takes.
    xs = x.reshape(shape[:dim] + [n] + shape[dim:]).movedim(dim, 0).contiguous()
    out = x.new_empty(shape)
    _reduce_scatter_single(out, xs.flatten(0, 1), group=mesh.get_group(axis))
    return out


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`x` reduced in place over the ranks on `axes`, one axis after the other."""
    for axis in axes:
        dist.all_reduce(x, op=op, group=mesh.get_group(axis))
    return x


def _slice(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(mesh, axis)
    return x.chunk(n, dim)[mesh.get_local_rank(axis)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        for axis in reversed(axes):  # the minor axis first
            x = all_gather(x, mesh, axis, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for axis in ctx.axes:  # the major axis first
            if axis in BATCH_AXES:
                g = reduce_scatter(g, ctx.mesh, axis, ctx.dim)
            else:
                g = _slice(g, ctx.mesh, axis, ctx.dim)
        return g.contiguous(), None, None, None


def gather(x: torch.Tensor, mesh: DeviceMesh, dim: int, axes: Sequence[str]) -> torch.Tensor:
    """`x` sharded along `dim` over `axes` (major first, as a JAX
    PartitionSpec entry lists them) -> the whole dim; see the module
    docstring for the backward."""
    return _Gather.apply(x, mesh, dim, tuple(axes))


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ("tensor",)), None


def copy_to_tensor(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Megatron's f; see the module docstring."""
    return _CopyToTensor.apply(x, mesh)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_sum(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """Megatron's g over `axes`; see the module docstring."""
    return _ReduceSum.apply(x, mesh, tuple(axes))


def _exchange(x: torch.Tensor, group, out_splits, in_splits) -> torch.Tensor:
    rows = x.shape[0] if out_splits is None else sum(out_splits)
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), out_splits, in_splits, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, out_splits, in_splits):
        ctx.group, ctx.splits = group, (out_splits, in_splits)
        return _exchange(x, group, out_splits, in_splits)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return _exchange(g, ctx.group, in_splits, out_splits), None, None, None


def all_to_all(x: torch.Tensor, group, out_splits: Optional[List[int]] = None,
               in_splits: Optional[List[int]] = None) -> torch.Tensor:
    """Rows of `x` (dim 0) to the ranks of `group` in rank order,
    `in_splits[j]` rows to rank j, and the rows received, `out_splits[j]`
    from rank j, in rank order; equal splits when None. Differentiable: the
    gradient goes back the way the rows came."""
    return _AllToAll.apply(x, group, out_splits, in_splits)


def token_prefix(counts: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """counts [rows, C] (per local row, the tokens of this rank's slice of
    it that fall in column C) -> [rows, C], the tokens of each column that
    come before each local row's slice in the global token order: row-major
    over [B, S], the rows split over BATCH_AXES (in batch_coordinate order)
    and the positions over `sequence`. An exclusive prefix sum over the
    gathered counts of every rank that splits the tokens; without a mesh,
    over the local rows."""
    if mesh is None:
        return counts.cumsum(0) - counts
    x = counts[None, None]  # [batch ranks, sequence ranks, rows, C]
    if axis_size(mesh, "sequence") > 1:
        x = all_gather(x, mesh, "sequence", 1)
    for axis in reversed(BATCH_AXES):  # minor first: batch_coordinate's order
        if axis_size(mesh, axis) > 1:
            x = all_gather(x, mesh, axis, 0)
    order = x.transpose(1, 2)  # global order: batch rank, row, sequence slice
    flat = order.reshape(-1, counts.shape[-1])
    before = (flat.cumsum(0) - flat).reshape(order.shape)
    return before[batch_coordinate(mesh)[0], :, sequence_coordinate(mesh)[0]]
