"""The switch (top-1) mixture-of-experts MLP, dispatched by index.

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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

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
