"""The mixture-of-experts MLPs: the switch (top-1) layer, dispatched by
index, and the dropless top-k layer (`dropless_mlp`, below).

Counterpart of the JAX `_moe_mlp` (training_operator_tpu/trainer/model.py
:271-315), which computes the same function with one-hot dispatch and
combine einsums over a [tokens, E, capacity] slot tensor. The rules kept:

- top-1 routing on fp32 router logits: `gate` the largest softmax
  probability, `choice` its expert;
- `cap = max(1, int(expert_capacity * T / E))`, T the global token count of
  the call (every rank's tokens; on a pipeline, one microbatch's);
- a token's place in its expert's queue is its rank among the tokens that
  chose that expert, in global token order (row-major over [B, S]); tokens
  at or past `cap` are dropped and contribute 0 (the residual carries them);
- `out[t] = gate[t] * MLP_e(x[t])` with the gate rounded to the compute
  dtype, as the combine einsum's operand is;
- `aux = E * sum_e frac_e * mean_prob_e` over the global tokens.

Each kept token lands in row `place` of its expert's [cap, D] buffer, as in
the JAX `[E, cap, D]` dispatch result, and its output is read back from the
same row: a slot holds one token, so the einsums' sums have one non-zero
term and the index form is exact. Without a mesh (or on one without an
`expert` axis) every token is written by index into the [E, cap, D] buffer,
a dropped one into a spare row no product reads, so nothing waits on the
host. The expert products are batched over E as the JAX einsums are.

On a mesh the queue places come from `collectives.token_prefix` (the
counts of the ranks whose tokens come first), so which tokens drop is
decided globally although each rank routes only its own. With `expert` > 1
each rank holds E/n experts (the expert dim of w1/w3/w2 sharded over
`expert`): its kept tokens go to the rank that owns their expert in one
all-to-all of variable splits (after an all-to-all of the counts, so each
receiver gets exactly its tokens and builds its experts' [cap, D] buffers:
the products are JAX's own size, where padding each source's buffer to cap
would multiply them by the number of sources), and the results come back
by the inverse all-to-all. The split sizes reach the host, one sync per
MoE call. The expert products use the fsdp-gathered expert weights and the
dense MLP's tensor-parallel f and g.

The dropless top-k layer (`moe_router="dropless"`; OLMoE's block, transformers'
`OlmoeSparseMoeBlock`) has no JAX counterpart. Its rules:

- `probs = softmax(h W_router)` over all E experts, in fp32; each token's
  `n_experts_per_tok` largest probabilities are its gates, not
  renormalised, and their experts its choices;
- no capacity: every (token, choice) pair is computed;
- `out[t] = sum_j gate[t, j] * SwiGLU_choice[t, j](h[t])`, each gate rounded
  to the compute dtype before its product, the k terms summed in fp32
  accumulation and rounded once;
- the load-balancing loss pools every layer (transformers'
  `load_balancing_loss_func`): with C_e the (token, choice) pairs that chose
  expert e and P_e the sum of e's probability, both over every layer's
  tokens, `aux = E * sum_e (C_e / (L T)) * (P_e / (L T))`; a layer returns
  its [2, E] stack of (C_e, P_e) and `balance_loss` forms it.

Its pairs are sorted by expert on the device (a stable sort, so each
expert's rows keep token order) into one [M, D] buffer of groups, each
padded with zero rows to a multiple of `GROUP_ALIGN` and at least that,
the slack of the fixed M = T k + GROUP_ALIGN E rows given to the last
group, so every shape is fixed and no count reaches the host. The three
SwiGLU products run over the groups as grouped GEMMs (`grouped_mm`): on the
card torch's `_grouped_mm` (a CUTLASS sm90 grouped GEMM that reads the group
offsets on the device, with its own backward), on the CPU a loop of plain
products over the groups. The padding keeps every group's rows 16-byte
aligned and never empty, which the grouped GEMM's weight gradient needs.
The permutation into that buffer and back (`_Dispatch`, `_Combine`) runs on
the card in the kernels of trainer/permute.py, which write each padding row
once and fill nothing else, and on the CPU as torch ops (`plain_dispatch`,
`plain_dispatch_backward`, `plain_combine`).
It runs unsharded (model.py refuses a mesh).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.observe.spans import (
    EXPERT_LOAD,
    MOE,
    MOE_EXPERTS,
    MOE_EXPERTS_GRAD,
    MOE_GRAD,
    MOE_PERMUTE,
    MOE_ROUTE,
    backward_span,
    count,
    counting,
    span,
)
from training_operator_tpu_torch.trainer import permute
from training_operator_tpu_torch.trainer.collectives import (
    all_reduce,
    all_to_all,
    copy_to_tensor,
    reduce_sum,
    token_prefix,
)
from training_operator_tpu_torch.trainer.mesh import TOKEN_AXES, axis_size


def route(h: torch.Tensor, router: torch.Tensor, config,
          mesh: Optional[DeviceMesh] = None, choice: Optional[torch.Tensor] = None):
    """h [b, s, D] (this rank's tokens) -> (choice [T], gate [T] fp32,
    place [T] in the expert's queue, keep [T], aux, cap). A given `choice`
    [T] sends each token to that expert, at its probability, in place of
    its top one: two runs whose hidden states differ in the last bits (two
    attention paths) can be held to one routing, since top-1 routing
    sends a near-tied token elsewhere on such a difference."""
    b, s, d = h.shape
    E = config.n_experts
    ranks = 1 if mesh is None else math.prod(axis_size(mesh, a) for a in TOKEN_AXES)
    tokens = b * s * ranks
    cap = max(1, int(config.expert_capacity * tokens / E))
    probs = torch.softmax(h.reshape(-1, d).float() @ router.float(), dim=-1)  # [T, E]
    if choice is None:
        gate, choice = probs.max(dim=-1)
    else:
        gate = probs.gather(1, choice[:, None])[:, 0]
    onehot = F.one_hot(choice, E)  # [T, E] int64
    rows = onehot.view(b, s, E)
    before = rows.cumsum(1) - rows + token_prefix(rows.sum(1), mesh)[:, None]
    place = before.view(-1, E).gather(1, choice[:, None])[:, 0]
    frac, mass = onehot.sum(0).float(), probs.sum(0)
    if mesh is not None:
        frac = all_reduce(frac, mesh, TOKEN_AXES)
        mass = reduce_sum(mass, mesh, TOKEN_AXES)
    aux = E * ((frac / tokens) * (mass / tokens)).sum()
    return choice, gate, place, place < cap, aux, cap


def expert_products(xin: torch.Tensor, experts: Dict[str, torch.Tensor], config,
                    mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """SwiGLU of each expert on its buffer: xin [E, cap, D] with w1, w3
    [E, D, F] and w2 [E, F, D] (under a mesh this rank's experts, F its
    tensor slice) -> [E, cap, D]."""
    dtype = config.dtype
    if mesh is not None:
        xin = copy_to_tensor(xin, mesh)
    gate = F.silu(torch.bmm(xin, experts["w1"].to(dtype)))
    up = torch.bmm(xin, experts["w3"].to(dtype))
    y = torch.bmm(gate * up, experts["w2"].to(dtype))
    return y if mesh is None else reduce_sum(y, mesh, ("tensor",))


def moe_mlp(h: torch.Tensor, router: torch.Tensor, experts: Dict[str, torch.Tensor],
            config, mesh: Optional[DeviceMesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch MoE on the normed hidden states h [b, s, D] (compute dtype):
    (out [b, s, D], aux). `router` [D, E]; `experts` the layer's w1, w3, w2
    with their fsdp shards gathered. See the module docstring."""
    b, s, d = h.shape
    x = h.reshape(-1, d)
    choice, gate, place, keep, aux, cap = route(h, router, config, mesh)
    n_ranks = 1 if mesh is None else axis_size(mesh, "expert")
    local = config.n_experts // n_ranks
    slot = (choice % local) * cap + place  # the row in its expert's buffer
    if n_ranks == 1:
        slot = torch.where(keep, slot, local * cap)  # dropped: the spare row
        buf = x.new_zeros(local * cap + 1, d).index_add(0, slot, x)
        y = expert_products(buf[:-1].view(local, cap, d), experts, config, mesh)
        y = F.pad(y.reshape(-1, d), (0, 0, 0, 1))[slot]  # the spare row reads 0
    else:
        y = _expert_parallel(x, choice // local, slot, keep, experts, config, mesh,
                             local, cap)
    return (y * gate.to(config.dtype)[:, None]).view(b, s, d), aux


def _expert_parallel(x, owner, slot, keep, experts, config, mesh: DeviceMesh,
                     local: int, cap: int) -> torch.Tensor:
    """The kept tokens of x [T, D] to the `expert` rank `owner` of their
    expert and their outputs back, in place of x's rows (0 for a dropped
    token)."""
    group, n_ranks, d = mesh.get_group("expert"), axis_size(mesh, "expert"), x.shape[1]
    kept = keep.nonzero()[:, 0]
    dest = owner[kept]
    idx = kept[torch.sort(dest, stable=True).indices]  # by destination, in token order
    sent = torch.bincount(dest, minlength=n_ranks)
    got = all_to_all(sent, group)
    in_splits, out_splits = sent.tolist(), got.tolist()
    xs = all_to_all(x[idx], group, out_splits, in_splits)
    rows = all_to_all(slot[idx], group, out_splits, in_splits)
    buf = x.new_zeros(local * cap, d).index_add(0, rows, xs)
    y = expert_products(buf.view(local, cap, d), experts, config, mesh)
    back = all_to_all(y.reshape(-1, d)[rows], group, in_splits, out_splits)
    return x.new_zeros(x.shape).index_add(0, idx, back)


# The rows of each expert's group in the dropless layer's grouped products
# are a multiple of this, and at least this (the module docstring).
GROUP_ALIGN = 16


def route_topk(x: torch.Tensor, router: torch.Tensor, config):
    """The dropless router on x [T, D]: (gate [T, k] fp32, choice [T, k],
    counts [E] int64 (pairs per expert), probs [T, E] fp32), k the config's
    `n_experts_per_tok`, gates in descending order."""
    E, k = config.n_experts, config.n_experts_per_tok
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate, choice = probs.topk(k, dim=-1)
    flat = choice.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    return gate, choice, counts, probs


def group_layout(choice: torch.Tensor, counts: torch.Tensor, n_experts: int):
    """Where each (token, choice) pair lands in the grouped buffer: (dest
    [T k], its row of each pair in token-major order; offs [E] int32, the
    end row of each expert's group; rows M of the buffer). All on the
    device, with fixed shapes."""
    pairs = choice.numel()
    rows = pairs + GROUP_ALIGN * n_experts
    size = ((counts + GROUP_ALIGN - 1) // GROUP_ALIGN).clamp(min=1) * GROUP_ALIGN
    end = size.cumsum(0)
    start = end - size
    # The slack rows, zeros, close the last group (a fill, not a copy from
    # the host, which would wait for the device).
    end = torch.cat((end[:-1], end.new_full((1,), rows)))
    flat = choice.reshape(-1)
    order = torch.argsort(flat, stable=True)
    expert = flat[order]
    first = counts.cumsum(0) - counts  # each expert's first pair in `order`
    within = torch.arange(pairs, device=flat.device) - first[expert]
    dest = torch.empty_like(order)
    dest[order] = start[expert] + within
    return dest, end.to(torch.int32), rows


def plain_dispatch(x: torch.Tensor, dest: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """The dispatch as torch ops (the CPU's path, and the reference the
    kernels are held to): x [T, D] -> [rows, D], row dest[t k + j] holding
    x[t], the others zeros."""
    out = x.new_zeros(rows, x.shape[1])
    out[dest.view(-1, k)] = x.unsqueeze(1)
    return out


def plain_dispatch_backward(grad: torch.Tensor, dest: torch.Tensor, k: int) -> torch.Tensor:
    """The dispatch's backward as torch ops: each token's k rows of grad
    [M, D] summed, with fp32 accumulation, rounded once."""
    g = grad.index_select(0, dest)
    return g.view(-1, k, g.shape[1]).sum(1)


def plain_combine(y: torch.Tensor, gate: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """The combine as torch ops, differentiable: y [M, D], gate [T, k] fp32
    -> [T, D], out[t] = sum_j bf16(gate[t, j]) y[dest[t k + j]] (the gate
    rounded to y's dtype, each product rounded, the k terms summed with fp32
    accumulation and rounded once)."""
    k = gate.shape[1]
    return (y.index_select(0, dest).view(-1, k, y.shape[1]) * gate.to(y.dtype)[..., None]).sum(1)


class _Dispatch(torch.autograd.Function):
    """x [T, D] -> the grouped buffer [M, D]: row dest[t k + j] holds x[t],
    the padding rows zeros. Its backward sums each token's k rows, with fp32
    accumulation, rounded once, under the range `model.moe.permute`. On the
    card the permutation kernels (trainer/permute.py: `scatter`, then
    `gather_sum`), on the CPU `plain_dispatch` and its backward."""

    @staticmethod
    def forward(ctx, x, dest, rows: int, k: int):
        ctx.save_for_backward(dest)
        ctx.k = k
        if permute.fused(x, dest):
            return permute.scatter(x, dest.view(-1, k), rows)
        return plain_dispatch(x, dest, rows, k)

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        with span(MOE_PERMUTE):
            if permute.fused(grad, dest):
                dx = permute.gather_sum(grad.contiguous(), dest.view(-1, ctx.k))
            else:
                dx = plain_dispatch_backward(grad, dest, ctx.k)
        return dx, None, None, None


class _Combine(torch.autograd.Function):
    """`plain_combine`: y [M, D], gate [T, k] fp32, dest [T k] -> [T, D].
    Its backward, under the range `model.moe.permute`, gives y's gradient
    (bf16(g[t] bf16(gate[t, j])) in row dest[t k + j], zeros elsewhere) and
    the gate's. On the card the permutation kernels (`gather_sum` with the
    gate, then `scatter` with it, whose gate gradient is summed in fp32); on
    the CPU `plain_combine` and its autograd, bit for bit."""

    @staticmethod
    def forward(ctx, y, gate, dest):
        ctx.save_for_backward(y, gate, dest)
        if permute.fused(y, gate, dest):
            return permute.gather_sum(y, dest.view_as(gate), gate)
        return plain_combine(y, gate, dest)

    @staticmethod
    def backward(ctx, grad):
        y, gate, dest = ctx.saved_tensors
        with span(MOE_PERMUTE):
            if permute.fused(grad, y, gate, dest):
                dy, dgate = permute.scatter(grad.contiguous(), dest.view_as(gate), y.shape[0],
                                            gate, y)
            else:
                with torch.enable_grad():
                    y, gate = y.detach().requires_grad_(), gate.detach().requires_grad_()
                    dy, dgate = torch.autograd.grad(plain_combine(y, gate, dest), (y, gate), grad)
        return dy, dgate, None


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """a [M, K] in groups of rows ending at offs [E] (int32, the last M),
    b [E, K, N] -> [M, N]: each group times its expert's matrix. On the card
    torch's `_grouped_mm`, bf16 only; on the CPU `plain_grouped_mm`."""
    if not a.is_cuda:
        return plain_grouped_mm(a, b, offs)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the grouped expert products run in bfloat16 on the card, not "
                        f"{a.dtype} x {b.dtype}")
    return torch._grouped_mm(a, b, offs=offs)


def plain_grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """`grouped_mm` as a loop of plain products (reads the offsets on the
    host)."""
    parts, start = [], 0
    for e, end in enumerate(offs.tolist()):
        parts.append(a[start:end] @ b[e])
        start = end
    return torch.cat(parts)


def _dropless(h, router, w1, w3, w2, config):
    b, s, d = h.shape
    x = h.reshape(-1, d)
    k = config.n_experts_per_tok
    with span(MOE_ROUTE):
        gate, choice, counts, probs = route_topk(x, router, config)
        dest, offs, rows = group_layout(choice, counts, config.n_experts)
        sums = torch.stack([counts.float(), probs.sum(0)])
        if counting():
            count(EXPERT_LOAD, counts.max() * (config.n_experts / choice.numel()))
    with span(MOE_PERMUTE):
        xs = _Dispatch.apply(x, dest, rows, k)

    def products(xs, w1, w3, w2):
        with span(MOE_EXPERTS):
            dtype = config.dtype
            gate = F.silu(grouped_mm(xs, w1.to(dtype), offs))
            up = grouped_mm(xs, w3.to(dtype), offs)
            return grouped_mm(gate * up, w2.to(dtype), offs)

    y = backward_span(MOE_EXPERTS_GRAD, products, xs, w1, w3, w2)
    with span(MOE_PERMUTE):
        out = _Combine.apply(y, gate, dest)
    return out.view(b, s, d), sums


def dropless_mlp(h: torch.Tensor, router: torch.Tensor, experts: Dict[str, torch.Tensor],
                 config) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless top-k MoE on the normed hidden states h [b, s, D]
    (compute dtype): (out [b, s, D], the layer's [2, E] stack of pairs and
    probability sums per expert, for `balance_loss`). `router` [D, E];
    `experts` the layer's w1, w3 [E, D, F] and w2 [E, F, D]. See the module
    docstring."""
    with span(MOE):
        return backward_span(
            MOE_GRAD, lambda h, r, w1, w3, w2: _dropless(h, r, w1, w3, w2, config),
            h, router, experts["w1"], experts["w3"], experts["w2"])


def balance_loss(sums: torch.Tensor, tokens: int, config) -> torch.Tensor:
    """The pooled load-balancing loss from the layers' summed [2, E] stacks
    over `tokens` tokens a layer: E * sum_e (C_e / (L T)) * (P_e / (L T))."""
    rows = config.n_layers * tokens
    return config.n_experts * ((sums[0] / rows) * (sums[1] / rows)).sum()
