"""Attention: the plain path, the flash dispatcher, and sequence parallelism.

Counterpart of training_operator_tpu/trainer/attention.py. Layout
[batch, seq, heads, head_dim]; under a mesh, batch is this rank's rows over
(data, fsdp, expert), seq its slice over `sequence`, heads its slice over
`tensor`.

Every backend's forward is one dispatcher op that returns (out, lse) and
whose backward needs only (q, k, v, out, lse): the flash op (flash.py), the
plain op and the ring op here. That is the port's
`checkpoint_name(..., "attn_out")`: the save_attn remat policy keeps the
outputs of ATTENTION_OPS, and save_attn_qkv runs them outside the
checkpoint, so no backend recomputes its attention (nor the ring its
exchange) in backward. Ulysses is two all-to-alls around one of them.

The ring (JAX `_ring_attention_local`): the rank keeps its queries, and the
K/V blocks of the `sequence` group pass by, one hop to rank + 1 per step.
Each block is one flash call: causal on the diagonal block (src == rank),
non-causal for an earlier block (src < rank), skipped for a later one under
a causal mask. The blocks' (out, lse) merge in fp32. The backward runs
dq and dk/dv per block with the merged lse; dk/dv accumulate in fp32 and
travel with their block back to its owner. The per-rank body
(`ring_forward`, `ring_backward`) takes its blocks from a transport: the
process group (`GroupRing`) or a list, for the ranks of one process run one
after another (`LoopbackRing`, what a single card can run of a ring).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.trainer import flash
from training_operator_tpu_torch.trainer.collectives import all_to_all
from training_operator_tpu_torch.trainer.flash import (
    FLASH_FWD_OP,
    OPS,
    flash_attention,
    kernel_supports,
    row_delta,
    save_residuals,
)
from training_operator_tpu_torch.trainer.mesh import axis_size

_MASK_VALUE = -1e30

IMPLS = ("auto", "flash", "xla", "ring", "ulysses")


def plain_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Reference single-device attention on [B, S, H, D]: full fp32 scores,
    softmax, probabilities cast back to the input dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k).float() * scale
    if causal:
        s_q, s_k = scores.shape[1], scores.shape[3]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, :, None, :], scores, _MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bqhk,bkhd->bqhd", probs, v)


def plain_attention_fwd(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """`plain_attention` with its row logsumexp: (out [B, S, H, D] in q's
    dtype, lse [B*H, S, 1] fp32), the plain op's forward."""
    b, s, h, _ = q.shape
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bqhk", q, k).float() * scale
    if causal:
        mask = torch.ones(s, k.shape[1], dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, :, None, :], scores, _MASK_VALUE)
    lse = torch.logsumexp(scores, dim=-1, keepdim=True)
    probs = torch.exp(scores - lse).to(q.dtype)
    out = torch.einsum("bqhk,bkhd->bqhd", probs, v)
    return out, lse.permute(0, 2, 1, 3).reshape(b * h, s, 1)


# ----------------------------------------------------------------------
# The plain op: plain attention with the flash-style backward
# ----------------------------------------------------------------------

@torch.library.custom_op(f"{OPS}::plain_attn", mutates_args=())
def _plain_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return plain_attention_fwd(q, k, v, causal)


def _fake(q, k, v, causal, *extra):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, s, 1), dtype=torch.float32)


_plain_op.register_fake(_fake)


def _plain_backward(ctx, g, _g_lse):
    """The kernels' backward in its plain versions (fp32 scores and
    probabilities from q, k and the saved lse): no forward recompute."""
    q, k, v, out, lse = ctx.saved_tensors
    delta = row_delta(g, out)
    dq = flash.flash_bwd_dq_plain(q, k, v, g, lse, delta, ctx.causal)
    dk, dv = flash.flash_bwd_dkv_plain(q, k, v, g, lse, delta, ctx.causal)
    return dq, dk, dv, None


_plain_op.register_autograd(_plain_backward, setup_context=save_residuals)


# ----------------------------------------------------------------------
# The ring: per-rank body and its transports
# ----------------------------------------------------------------------

def _block_fns(q: torch.Tensor):
    """(forward, dq, dk/dv) of one ring block: the kernel wrappers (their
    plain versions on a CPU tensor), or the plain versions on the card for
    a dtype or head_dim the kernels do not take."""
    if q.is_cuda and not kernel_supports(q):
        return flash.flash_fwd_plain, flash.flash_bwd_dq_plain, flash.flash_bwd_dkv_plain
    return flash.flash_fwd, flash.flash_bwd_dq, flash.flash_bwd_dkv


def _lse_rows(lse: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, S, 1] -> [B, S, H, 1], to scale out rows."""
    return lse.reshape(b, h, -1).permute(0, 2, 1)[..., None]


def ring_forward(q, k, v, causal: bool, transport) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's ring forward: (out in q's dtype, merged lse [B*H, S, 1]
    fp32) over the blocks `transport.kv_blocks` hands it."""
    fwd = _block_fns(q)[0]
    b, s, h, _ = q.shape
    out = lse = None
    for src, kb, vb in transport.kv_blocks(k, v):
        if causal and src > transport.rank:
            continue
        ob, lb = fwd(q, kb, vb, causal and src == transport.rank)
        lb = _lse_rows(lb, b, h)
        if out is None:  # step 0: the rank's own block, always visible
            out, lse = ob.float(), lb
            continue
        new = torch.logaddexp(lse, lb)
        # In place, the bf16 block widened inside the kernels.
        out.mul_(torch.exp(lse - new)).addcmul_(ob, torch.exp(lb - new))
        lse = new
    return out.to(q.dtype), lse[..., 0].permute(0, 2, 1).reshape(b * h, s, 1)


def ring_backward(q, k, v, out, lse, do, causal: bool, transport) -> torch.Tensor:
    """One rank's ring backward: returns dq; each block's dk/dv goes to
    `transport.add_grads`, which sums it where the block's owner finds it
    (GroupRing.own_grads, the loopback's slots)."""
    _, dq_fn, dkv_fn = _block_fns(q)
    delta = row_delta(do, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for src, kb, vb in transport.grad_blocks(k, v):
        if causal and src > transport.rank:
            continue
        diagonal = causal and src == transport.rank
        dq += dq_fn(q, kb, vb, do, lse, delta, diagonal)
        transport.add_grads(src, *dkv_fn(q, kb, vb, do, lse, delta, diagonal))
    return dq.to(q.dtype)


class GroupRing:
    """The ring over a process group: at each step every rank sends its
    block to rank + 1 and receives rank - 1's (`batch_isend_irecv`), the
    JAX permutation (j -> j+1). The next block is in flight while the
    current one computes. In backward the fp32 dk/dv of the block held
    travel with it; after the last step one more hop brings each block's
    sums home."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        self._next = dist.get_global_rank(group, (rank + 1) % size)
        self._prev = dist.get_global_rank(group, (rank - 1) % size)
        self._acc: List[torch.Tensor] = []

    def _rotate(self, tensors: Sequence[torch.Tensor]):
        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, self._next, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, r, self._prev, self.group) for r in recv]
        return dist.batch_isend_irecv(ops), recv

    @staticmethod
    def _wait(pending) -> List[torch.Tensor]:
        works, recv = pending
        for w in works:
            w.wait()
        return recv

    def kv_blocks(self, k, v) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        cur = [k.contiguous(), v.contiguous()]
        for t in range(self.size):
            pending = self._rotate(cur) if t + 1 < self.size else None
            yield (self.rank - t) % self.size, cur[0], cur[1]
            if pending is not None:
                cur = self._wait(pending)

    def grad_blocks(self, k, v) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
        self._acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                     torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for src, kb, vb in self.kv_blocks(k, v):
            yield src, kb, vb
            self._acc = self._wait(self._rotate(self._acc))

    def add_grads(self, src: int, dk, dv) -> None:
        self._acc[0] += dk
        self._acc[1] += dv

    def own_grads(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._acc[0], self._acc[1]


class LoopbackRing:
    """The NS ranks of a ring in one process, run one after another: rank r
    takes block src from the list, and its dk/dv contributions add into
    block src's fp32 slot. `rank(r)` is rank r's transport."""

    def __init__(self, ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]):
        self.ks, self.vs, self.size = list(ks), list(vs), len(ks)
        self.dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in ks]
        self.dv = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in vs]

    def rank(self, r: int) -> "_LoopbackRank":
        return _LoopbackRank(self, r)


class _LoopbackRank:
    def __init__(self, ring: LoopbackRing, rank: int):
        self.ring, self.rank, self.size = ring, rank, ring.size

    def kv_blocks(self, k, v):
        for t in range(self.size):
            src = (self.rank - t) % self.size
            yield src, self.ring.ks[src], self.ring.vs[src]

    grad_blocks = kv_blocks

    def add_grads(self, src: int, dk, dv) -> None:
        self.ring.dk[src] += dk
        self.ring.dv[src] += dv


def ring_loopback(qs, ks, vs, dos, causal: bool = True):
    """The ring's per-rank body for len(qs) ranks in one process, forward
    then backward, on the per-rank blocks of q, k, v and dO (each [B, S/NS,
    H, D]): returns per-rank lists (outs, lses, dqs, dks, dvs), the merged
    lse [B*H, S/NS, 1] fp32, dk/dv in k's dtype."""
    ring = LoopbackRing(ks, vs)
    fwd = [ring_forward(qs[r], ks[r], vs[r], causal, ring.rank(r)) for r in range(ring.size)]
    dqs = [ring_backward(qs[r], ks[r], vs[r], fwd[r][0], fwd[r][1], dos[r], causal,
                         ring.rank(r)) for r in range(ring.size)]
    return ([o for o, _ in fwd], [lse for _, lse in fwd], dqs,
            [d.to(ks[0].dtype) for d in ring.dk], [d.to(vs[0].dtype) for d in ring.dv])


# The process groups the ring op runs over, by index: an op's arguments are
# tensors and scalars, so it names its group by this index.
_RING_GROUPS: List[Tuple[object, int, int]] = []


def _ring_index(mesh: DeviceMesh) -> int:
    entry = (mesh.get_group("sequence"), mesh.get_local_rank("sequence"),
             axis_size(mesh, "sequence"))
    for i, known in enumerate(_RING_GROUPS):
        if known[0] is entry[0]:
            return i
    _RING_GROUPS.append(entry)
    return len(_RING_GROUPS) - 1


@torch.library.custom_op(f"{OPS}::ring_attn", mutates_args=())
def _ring_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             ring: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return ring_forward(q, k, v, causal, GroupRing(*_RING_GROUPS[ring]))


_ring_op.register_fake(_fake)


def _ring_backward(ctx, g, _g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    transport = GroupRing(*_RING_GROUPS[ctx.extra[0]])
    dq = ring_backward(q, k, v, out, lse, g, ctx.causal, transport)
    dk, dv = transport.own_grads()
    return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


_ring_op.register_autograd(_ring_backward, setup_context=save_residuals)


def ring_attention(q, k, v, mesh: DeviceMesh, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over the mesh's `sequence` axis on this
    rank's [B, S/NS, H, D] blocks (JAX `ring_attention`)."""
    return torch.ops.training_operator_tpu_torch.ring_attn(q, k, v, causal, _ring_index(mesh))[0]


# ----------------------------------------------------------------------
# Ulysses: all-to-all over `sequence`, full-sequence attention on a head slice
# ----------------------------------------------------------------------

def _reshard(x: torch.Tensor, group, n: int, heads_out: bool) -> torch.Tensor:
    """[B, S/n, H, D] -> [B, S, H/n, D] (heads_out=True) or back: chunk j
    of the split dim to rank j of `group`, the chunks received joined in
    rank order. Its gradient is the inverse all-to-all."""
    split, join = (2, 1) if heads_out else (1, 2)
    parts = all_to_all(torch.stack(x.chunk(n, split)), group)
    return torch.cat(parts.unbind(0), join)


def ulysses_attention(q, k, v, mesh: DeviceMesh, causal: bool = True) -> torch.Tensor:
    """All-to-all sequence parallelism (JAX `ulysses_attention`): this
    rank's [B, S/sp, H_loc, D] becomes [B, S, H_loc/sp, D], the head order
    major `tensor`, minor `sequence` (the JAX P(..., ("tensor",
    "sequence"), ...)); the single-device attention (flash on the card)
    runs on the whole sequence; a second all-to-all returns the sequence
    slice."""
    sp, tp = axis_size(mesh, "sequence"), axis_size(mesh, "tensor")
    if q.shape[2] % sp:
        raise ValueError(f"ulysses needs heads ({q.shape[2] * tp}) divisible by "
                         f"sequence x tensor axis sizes ({sp} x {tp})")
    group = mesh.get_group("sequence")
    q, k, v = (_reshard(x, group, sp, True) for x in (q, k, v))
    return _reshard(_single_device(q, k, v, causal, "auto"), group, sp, False)


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------

ATTENTION_OPS = (FLASH_FWD_OP, torch.ops.training_operator_tpu_torch.plain_attn.default,
                 torch.ops.training_operator_tpu_torch.ring_attn.default)


def _single_device(q, k, v, causal: bool, impl: str) -> torch.Tensor:
    if impl == "flash" or (impl == "auto" and q.is_cuda and kernel_supports(q)):
        return flash_attention(q, k, v, causal)
    return torch.ops.training_operator_tpu_torch.plain_attn(q, k, v, causal)[0]


def attention(q, k, v, causal: bool = True, impl: str = "auto",
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Dispatch, as the JAX `attention()`: on a mesh whose `sequence` axis
    is larger than 1, the ring (any `impl` but "ulysses") or Ulysses.
    Otherwise the single-device path: "flash" takes the flash op (the CUDA
    kernels on the card, their plain versions on the CPU), "auto" takes it
    on a CUDA tensor whenever the kernels take its dtype and head_dim, and
    every other impl ("xla", and "ring" or "ulysses" without a sequence
    axis) the plain op.

    GQA (fewer KV heads) is expanded here, once, for every backend:
    `repeat_interleave` on the head axis, as `jnp.repeat` does."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    heads, kv_heads = q.shape[2], k.shape[2]
    if kv_heads != heads:
        if heads % kv_heads:
            raise ValueError(
                f"attention requires q heads ({heads}) divisible by kv heads "
                f"({kv_heads})"
            )
        rep = heads // kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if mesh is not None and axis_size(mesh, "sequence") > 1:
        if impl == "ulysses":
            return ulysses_attention(q, k, v, mesh, causal)
        return ring_attention(q, k, v, mesh, causal)
    return _single_device(q, k, v, causal, impl)
