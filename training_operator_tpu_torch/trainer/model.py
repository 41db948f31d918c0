"""Flagship model: the decoder-only transformer LM, dense path, in PyTorch.

Counterpart of training_operator_tpu/trainer/model.py (TransformerConfig,
init_params, backbone, loss_fn). The parameters keep the JAX package's
names and layout so the weight bridge (convert.py) is a renaming:

- per-layer weights are stacked on a leading [L] axis (`layers.wq` is
  [L, d_model, q_dim]) and the decoder loops over that axis;
- matrices are stored [in, out] and applied as `h @ w`, not `nn.Linear`'s
  [out, in];
- parameters are fp32; each product casts its weight to `config.dtype`
  (bf16 by default), and the lm head runs in fp32 (on the card through
  head_gemm.py's 3xTF32 kernel).

Architecture: pre-RMSNorm, split-half rotary embeddings, GQA-capable
attention, SwiGLU MLP, or with `n_experts > 0` a MoE MLP of moe.py in every
layer, whose load-balancing aux loss adds to the loss at `router_aux_coef`:
the switch (top-1) layer, its aux averaged over the layers, or with
`moe_router="dropless"` the dropless top-k layer, its aux pooled over the
layers (OLMoE's). `qk_norm` adds RMSNorms over the whole q and k
projections before RoPE (OLMoE's q_norm and k_norm); every norm takes
`rms_norm_eps`. `remat=True` applies
`remat_policy` to each layer (`layer_body`, the JAX `make_layer_body`);
`remat_head=True` checkpoints the head and loss. On a mesh with a
`pipeline` axis, or a model given to `pipeline.loopback`, the loss runs the
GPipe schedule of pipeline.py over `model.stages`.

The sharded half (JAX `param_specs` and the mesh paths of `backbone` and
`loss_fn`): `init_params(..., mesh)` builds on each rank the shard of every
parameter that the JAX `param_specs` puts at its mesh coordinate (and
`shard_model(model, mesh)` cuts it out of a whole model), and `model.mesh`
then sends the forward through the collectives of collectives.py.
Megatron column/row products on `tensor` and the complementary dim on
`fsdp`, each layer's fsdp shards gathered as it runs (and again in a
recompute), attention over the `sequence` axis (attention.py: ring or
Ulysses) with RoPE at each slice's global positions, a vocab-parallel head
and loss, and a loss that is the global masked mean over the batch axes and
`sequence`. MoE expert stacks shard their expert dim over `expert` and
their tokens travel there by all-to-all (moe.py). On a pipeline mesh each
rank holds only its stage's layers: the [L] dim of every layer weight
sharded over `pipeline` (`layout_specs`, JAX `_stage_specs`). The
parameters stay plain tensors holding the
local shard: DTensor op dispatch on a six-axis mesh enumerates placement
strategies per op (on torch 2.13 the backward of one tiny DTensor parameter
took seconds), so the placements (`param_placements`) describe the layout
to the checkpoint (train.state_dict) and take no part in the compute; FSDP2
would shard the stacked [L] dim and hold DTensors too.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from training_operator_tpu_torch.observe.spans import HEAD, HEAD_GRAD, LAYER, backward_span, span
from training_operator_tpu_torch.trainer.attention import ATTENTION_OPS, attention
from training_operator_tpu_torch.trainer.head_gemm import head_matmul
from training_operator_tpu_torch.trainer.collectives import (
    all_reduce,
    copy_to_tensor,
    gather,
    reduce_sum,
)
from training_operator_tpu_torch.trainer.mesh import (
    AXIS_ORDER,
    TOKEN_AXES,
    axis_size,
    sequence_coordinate,
)
from training_operator_tpu_torch.trainer.moe import balance_loss, dropless_mlp, moe_mlp


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU"
        )
    return device


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # Mixture-of-experts: n_experts > 0 replaces every layer's SwiGLU by a
    # switch (top-1) MoE with n_experts experts (moe.py).
    n_experts: int = 0
    expert_capacity: float = 1.25  # slots per expert = capacity * tokens / E
    router_aux_coef: float = 0.01  # weight of the load-balancing loss
    # The MoE layer: "switch" (the above) or "dropless" (softmax top-
    # `n_experts_per_tok`, gates not renormalised, no token dropped;
    # moe.dropless_mlp; unsharded only).
    moe_router: str = "switch"
    n_experts_per_tok: int = 1
    # RMSNorm over the whole q and k projections before RoPE; unsharded only.
    qk_norm: bool = False
    rms_norm_eps: float = 1e-6  # every RMSNorm's epsilon
    # GPipe microbatches on a mesh with a `pipeline` axis (0: one per
    # stage); read there only.
    pipeline_microbatches: int = 0
    # "auto" (flash kernels on the card where they take the dtype and
    # head_dim), "flash", "xla" (the plain path); on a sequence-sharded mesh
    # "ring" (what any impl but "ulysses" takes there) or "ulysses".
    attn_impl: str = "auto"
    # What a layer keeps for its backward under remat (see `layer_body`):
    # "full" (only the layer input), "save_attn" (+ the attention op's out
    # and lse), "save_attn_qkv" (+ the RoPE'd q, k and v), "mlp_only" (the
    # whole attention half; only the MLP half is recomputed), "save_dots"
    # (every weight product's output).
    remat_policy: str = "full"
    remat_head: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    REMAT_POLICIES = ("full", "mlp_only", "save_attn", "save_attn_qkv", "save_dots")
    MOE_ROUTERS = ("switch", "dropless")

    def validate(self) -> None:
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads:
            raise ValueError("d_model must divide by n_heads and n_heads by n_kv_heads")
        if self.remat_policy not in self.REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                f"one of {self.REMAT_POLICIES}"
            )
        if self.n_experts < 0 or self.pipeline_microbatches < 0:
            raise ValueError(f"n_experts={self.n_experts} and pipeline_microbatches="
                             f"{self.pipeline_microbatches} must not be negative")
        if self.moe_router not in self.MOE_ROUTERS:
            raise ValueError(f"unknown moe_router {self.moe_router!r}; one of {self.MOE_ROUTERS}")
        if self.moe_router == "switch" and self.n_experts_per_tok != 1:
            raise ValueError("the switch router sends a token to one expert")
        if self.moe_router == "dropless" and not 1 <= self.n_experts_per_tok <= self.n_experts:
            raise ValueError(f"n_experts_per_tok={self.n_experts_per_tok} must lie in "
                             f"1..n_experts={self.n_experts}")

    @property
    def unsharded_only(self) -> bool:
        """Whether the model has parts that run only unsharded: the dropless
        MoE layer, qk-norm."""
        return self.qk_norm or (self.n_experts > 0 and self.moe_router == "dropless")


# Fields the JAX package's TransformerConfig lacks: at their defaults the
# port's model is the JAX one.
PORT_ONLY_FIELDS = ("moe_router", "n_experts_per_tok", "qk_norm", "rms_norm_eps")

LAYER_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")
MOE_LAYER_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "router", "w1", "w3", "w2")


def layer_params(config: TransformerConfig) -> Tuple[str, ...]:
    names = MOE_LAYER_PARAMS if config.n_experts > 0 else LAYER_PARAMS
    if config.qk_norm:
        names = names[:4] + ("q_norm", "k_norm") + names[4:]
    return names


def param_shapes(config: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """The full shape of every parameter, by the port's names (JAX
    `init_params`): a MoE layer's router is [D, E] and its expert stacks
    lead with E; qk-norm's scales are [q_dim] and [kv_dim]."""
    c = config
    dm, dff, L, V = c.d_model, c.d_ff, c.n_layers, c.vocab_size
    q_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    layers = {
        "ln1": (L, dm), "wq": (L, dm, q_dim), "wk": (L, dm, kv_dim),
        "wv": (L, dm, kv_dim), "wo": (L, q_dim, dm), "ln2": (L, dm),
        "w1": (L, dm, dff), "w3": (L, dm, dff), "w2": (L, dff, dm),
        "q_norm": (L, q_dim), "k_norm": (L, kv_dim),
    }
    if c.n_experts > 0:
        E = c.n_experts
        layers.update(router=(L, dm, E), w1=(L, E, dm, dff), w3=(L, E, dm, dff),
                      w2=(L, E, dff, dm))
    return {"embed": (V, dm), **{"layers." + n: layers[n] for n in layer_params(c)},
            "ln_f": (dm,), "lm_head": (dm, V)}


class DecoderLayers(nn.Module):
    """Every layer's weights, stacked on a leading [L] axis."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        shapes = param_shapes(config)
        for name in layer_params(config):
            self.register_parameter(
                name, nn.Parameter(torch.empty(shapes["layers." + name], device=device))
            )

    def unbind(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer views of the stacked weights. One `unbind` per stack:
        its backward stacks the layers' gradients once, where indexing each
        layer (`w[i]`) would add L zero-filled full-stack gradients."""
        return unbind_layers(dict(self.named_parameters()))


def unbind_layers(stacks: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """{name: [L, ...] stack} -> L dicts of per-layer views."""
    parts = {name: t.unbind(0) for name, t in stacks.items()}
    return [dict(zip(parts, layer)) for layer in zip(*parts.values())]


class Transformer(nn.Module):
    """Parameters `embed` [V, D], `layers.*` [L, ...], `ln_f` [D], `lm_head`
    [D, V], all fp32."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        config.validate()
        self.config = config
        c = config
        self.embed = nn.Parameter(torch.empty(c.vocab_size, c.d_model, device=device))
        self.layers = DecoderLayers(c, device)
        self.ln_f = nn.Parameter(torch.empty(c.d_model, device=device))
        self.lm_head = nn.Parameter(torch.empty(c.d_model, c.vocab_size, device=device))
        # Set when sharded: the parameters then hold this rank's shards, laid
        # out by `specs` (layout_specs).
        self.mesh: Optional[DeviceMesh] = None
        self.specs = param_specs(config)
        # The GPipe stages the loss runs through (pipeline.py): set on a
        # pipeline mesh, or by pipeline.loopback.
        self.stages = None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


@torch.no_grad()
def init_params(
    config: TransformerConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
    mesh: Optional[DeviceMesh] = None,
) -> Transformer:
    """Scaled-normal init in fp32 (the JAX init's distribution; the numbers
    differ, since torch's generator is not JAX's). The generator must live on
    `device`; by default one seeded with 0.

    Under a mesh the model is built straight into this rank's shards: each
    parameter is drawn whole, in the unsharded order, and only its shard is
    kept before the next is drawn. So the shards equal those of the
    unsharded init, and the rank never holds more than its shards and one
    whole parameter (the JAX init under `out_shardings`)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    c = config
    std = c.d_model ** -0.5
    resid_std = std / (2 * c.n_layers) ** 0.5
    scales = {
        "embed": 1.0, "layers.wq": std, "layers.wk": std, "layers.wv": std,
        "layers.wo": resid_std, "layers.router": std, "layers.w1": std, "layers.w3": std,
        "layers.w2": resid_std, "lm_head": std,
    }

    def fill(name: str, p: torch.Tensor) -> torch.Tensor:
        if name in scales:
            return p.normal_(0.0, scales[name], generator=generator)
        return p.fill_(1.0)  # the norm scales

    if mesh is None:
        model = Transformer(config, device)
        for name, p in model.named_parameters():
            fill(name, p)
        return model

    def shard(name: str, shape, specs) -> torch.Tensor:
        whole = fill(name, torch.empty(shape, device=device))
        return local_shard(name, whole, mesh, specs).clone(
            memory_format=torch.contiguous_format)

    return _build_sharded(config, mesh, shard)


@torch.no_grad()
def zeros_sharded(config: TransformerConfig, mesh: DeviceMesh, device) -> Transformer:
    """A model holding this rank's shards, zero-filled, allocated at their
    own size: the restore template under a mesh."""
    return _build_sharded(config, mesh, lambda name, shape, specs: torch.zeros(
        local_shape(name, shape, mesh, specs), device=resolve_device(device)))


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding on [B, S, H, D]; positions [B, S]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _weight(lp, name: str, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """A layer weight, its fsdp shards gathered under a mesh (the [in, out]
    matrix keeps its tensor shard: the products are column/row parallel; an
    expert stack [E, in, out] its expert shard too)."""
    w = lp[name]
    if mesh is None:
        return w
    return gather(w, mesh, LAYER_FSDP_DIM[name] + w.dim() - 2, ("fsdp",))


def _qkv_raw(x, lp, config: TransformerConfig, mesh: Optional[DeviceMesh] = None):
    """norm -> the q, k, v products, as [b, s, heads * head_dim] (this rank's
    heads under a mesh)."""
    c = config
    h = _rms_norm(x, lp["ln1"], c.rms_norm_eps)
    if mesh is not None:
        h = copy_to_tensor(h, mesh)
    return tuple(h @ _weight(lp, n, mesh).to(c.dtype) for n in ("wq", "wk", "wv"))


def _qk_norm(q, k, lp, config: TransformerConfig):
    """qk-norm, where the config has it: an RMSNorm over each of the whole q
    and k projections."""
    if not config.qk_norm:
        return q, k
    eps = config.rms_norm_eps
    return _rms_norm(q, lp["q_norm"], eps), _rms_norm(k, lp["k_norm"], eps)


def _heads(t, config: TransformerConfig):
    b, s, _ = t.shape
    return t.reshape(b, s, -1, config.head_dim)


def _qkv_products(x, lp, config: TransformerConfig, mesh: Optional[DeviceMesh] = None):
    """norm -> the q, k, v products (and qk-norm), as [b, s, heads,
    head_dim] (this rank's heads under a mesh)."""
    q, k, v = _qkv_raw(x, lp, config, mesh)
    q, k = _qk_norm(q, k, lp, config)
    return _heads(q, config), _heads(k, config), _heads(v, config)


def _out_projection(attn, lp, config: TransformerConfig, mesh: Optional[DeviceMesh] = None):
    b, s = attn.shape[:2]
    out = attn.reshape(b, s, -1) @ _weight(lp, "wo", mesh).to(config.dtype)
    return out if mesh is None else reduce_sum(out, mesh, ("tensor",))


def _attn_block(x, lp, config: TransformerConfig, positions, attn_impl: str,
                mesh: Optional[DeviceMesh] = None):
    """norm -> qkv -> rope -> attention -> output projection."""
    c = config
    q, k, v = _qkv_products(x, lp, c, mesh)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    attn = attention(q, k, v, causal=True, impl=attn_impl, mesh=mesh)
    return _out_projection(attn, lp, c, mesh)


def _mlp_block(x, lp, config: TransformerConfig, mesh: Optional[DeviceMesh] = None):
    """norm -> SwiGLU, or a MoE; returns (out, aux), aux None for the dense
    MLP (the dropless layer's a [2, E] stack, moe.balance_loss)."""
    c = config
    h = _rms_norm(x, lp["ln2"], c.rms_norm_eps)
    if c.n_experts > 0:
        experts = {n: _weight(lp, n, mesh) for n in ("w1", "w3", "w2")}
        if c.moe_router == "dropless":
            return dropless_mlp(h, lp["router"], experts, c)
        return moe_mlp(h, lp["router"], experts, c, mesh)
    if mesh is not None:
        h = copy_to_tensor(h, mesh)
    gate = F.silu(h @ _weight(lp, "w1", mesh).to(c.dtype))
    up = h @ _weight(lp, "w3", mesh).to(c.dtype)
    out = (gate * up) @ _weight(lp, "w2", mesh).to(c.dtype)
    return (out if mesh is None else reduce_sum(out, mesh, ("tensor",))), None


def _add_mlp(x, lp, config: TransformerConfig, mesh: Optional[DeviceMesh]):
    with span(LAYER):
        out, aux = _mlp_block(x, lp, config, mesh)
        return x + out, aux


def decoder_layer(x, lp, config: TransformerConfig, positions, attn_impl: str = "auto",
                  mesh: Optional[DeviceMesh] = None):
    """One pre-norm decoder block on [b, s, d]; returns (x, aux)."""
    with span(LAYER):
        x = x + _attn_block(x, lp, config, positions, attn_impl, mesh)
        return _add_mlp(x, lp, config, mesh)


def _out_and_mlp(x, attn, lp, config: TransformerConfig, mesh: Optional[DeviceMesh] = None):
    """The layer after its attention: output projection, residual, MLP;
    returns (x, aux)."""
    with span(LAYER):
        x = x + _out_projection(attn, lp, config, mesh)
        return _add_mlp(x, lp, config, mesh)


class _NormQKV(torch.autograd.Function):
    """`_qkv_products` keeping only its inputs for the backward: that
    recomputes the norm (the weight gradients need its output) and none of
    the three products, whose gradients are products with the saved
    weights. With qk-norm it keeps the q and k products too, and recomputes
    their norms. Under a mesh it takes the gathered weights and sums the
    norm output's gradient over `tensor` (the f of copy_to_tensor)."""

    @staticmethod
    def forward(ctx, x, ln1, wq, wk, wv, q_norm, k_norm, config, mesh):
        ctx.config, ctx.mesh = config, mesh
        q, k, v = _qkv_raw(x, {"ln1": ln1, "wq": wq, "wk": wk, "wv": wv}, config)
        if config.qk_norm:
            ctx.save_for_backward(x, ln1, wq, wk, wv, q, k, q_norm, k_norm)
            q, k = _qk_norm(q, k, {"q_norm": q_norm, "k_norm": k_norm}, config)
        else:
            ctx.save_for_backward(x, ln1, wq, wk, wv)
        return _heads(q, config), _heads(k, config), _heads(v, config)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, ln1, *ws = ctx.saved_tensors[:5]
        config = ctx.config
        dtype, eps = config.dtype, config.rms_norm_eps
        dnorms = (None, None)
        if config.qk_norm:
            q, k, q_norm, k_norm = ctx.saved_tensors[5:]
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, q_norm, k_norm)]
                qn = _rms_norm(leaves[0], leaves[2], eps)
                kn = _rms_norm(leaves[1], leaves[3], eps)
            gq, gk, *dnorms = torch.autograd.grad(
                (qn, kn), leaves, (gq.reshape(qn.shape), gk.reshape(kn.shape)))
        with torch.enable_grad():
            xd, lnd = x.detach().requires_grad_(), ln1.detach().requires_grad_()
            h = _rms_norm(xd, lnd, eps)
        h2 = h.detach().reshape(-1, h.shape[-1])
        dh, dws = None, []
        for w, g in zip(ws, (gq, gk, gv)):
            g2 = g.reshape(h2.shape[0], -1)
            dws.append((h2.t() @ g2).to(w.dtype))
            d = g2 @ w.to(dtype).t()
            dh = d if dh is None else dh + d
        if ctx.mesh is not None:
            all_reduce(dh, ctx.mesh, ("tensor",))
        dx, dln = torch.autograd.grad(h, (xd, lnd), dh.reshape(h.shape))
        return dx, dln, *dws, *dnorms, None, None


def _save_attention_outputs(ctx, op, *args, **kwargs):
    """save_attn: keep the attention op's (out, lse), JAX's "attn_out" and
    "attn_lse", on every backend (attention.ATTENTION_OPS: flash, plain,
    ring; Ulysses runs flash or plain inside)."""
    if op in ATTENTION_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_weight_products(ctx, op, *args, **kwargs):
    """save_dots: JAX's dots_with_no_batch_dims_saveable. A weight product
    `h @ w` reaches the dispatcher as `mm`; batched products and the
    attention ops are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SELECTIVE = {"save_attn": _save_attention_outputs, "save_dots": _save_weight_products}


def layer_body(config: TransformerConfig, positions,
               mesh: Optional[DeviceMesh] = None) -> Callable:
    """`(x, lp) -> (x, aux)` for one layer with the config's remat policy
    applied (the JAX `make_layer_body`); aux is the MoE layer's
    load-balancing loss, None for a dense layer. Under a mesh `lp` holds the
    local shards, gathered inside the checkpointed region, so a recompute
    gathers again (and a MoE layer routes and exchanges its tokens again):

    - "full": the whole layer under `checkpoint`; backward recomputes it,
      the attention forward included (2 forward launches per layer and
      step; the ring exchanges its blocks again).
    - "save_attn", "save_dots": the whole layer under `checkpoint` with a
      selective policy: the attention op's outputs, or every weight
      product's, are kept and not recomputed.
    - "save_attn_qkv": attention runs outside the checkpoint. The qkv
      products keep only their inputs (`_NormQKV`); RoPE keeps only its
      cos/sin; the attention op, whichever the backend, keeps (q, k, v,
      out, lse), as JAX keeps the names attn_q/k/v and attn_out/lse.
      Output projection and MLP are recomputed under `checkpoint`.
    - "mlp_only": attention outside the checkpoint, unchanged; only the MLP
      (or MoE) half is recomputed.
    """
    c = config
    impl = c.attn_impl
    if not c.remat:
        return lambda x, lp: decoder_layer(x, lp, c, positions, impl, mesh)
    policy = c.remat_policy
    if policy == "mlp_only":
        def body(x, lp):
            x = x + _attn_block(x, lp, c, positions, impl, mesh)
            return checkpoint(_add_mlp, x, lp, c, mesh, use_reentrant=False)
        return body
    if policy == "save_attn_qkv":
        def body(x, lp):
            weights = [_weight(lp, n, mesh) for n in ("wq", "wk", "wv")]
            q, k, v = _NormQKV.apply(x, lp["ln1"], *weights, lp.get("q_norm"),
                                     lp.get("k_norm"), c, mesh)
            q = _rope(q, positions, c.rope_theta)
            k = _rope(k, positions, c.rope_theta)
            attn = attention(q, k, v, causal=True, impl=impl, mesh=mesh)
            return checkpoint(_out_and_mlp, x, attn, lp, c, mesh, use_reentrant=False)
        return body
    if policy != "full" and policy not in _SELECTIVE:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {c.REMAT_POLICIES}")
    kwargs = {}
    if policy in _SELECTIVE:
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _SELECTIVE[policy])
    return lambda x, lp: checkpoint(decoder_layer, x, lp, c, positions, impl, mesh,
                                    use_reentrant=False, **kwargs)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, config: TransformerConfig,
                 mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """tokens [b, s] -> [b, s, D] in the compute dtype."""
    if mesh is not None:
        # The whole table before the row gather, as the JAX backbone
        # replicates it explicitly.
        embed = gather(embed, mesh, 1, PARAM_SPECS["embed"][1])
    return embed.to(config.dtype)[tokens.long()]


def run_layers(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]], body: Callable):
    """`body` over the layers in order: (x, the sum of their aux losses, or
    None for dense layers)."""
    aux = None
    for lp in layers:
        x, a = body(x, lp)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _backbone(model: Transformer, tokens: torch.Tensor, config: TransformerConfig):
    if model.stages is not None:
        raise ValueError("a pipelined model's hidden states live on its last stage: "
                         "run loss_fn")
    mesh = model.mesh
    b, s = tokens.shape
    offset = 0 if mesh is None else sequence_coordinate(mesh)[0] * s
    x = embed_tokens(model.embed, tokens, config, mesh)
    positions = torch.arange(offset, offset + s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x, aux = run_layers(x, model.layers.unbind(), layer_body(config, positions, mesh))
    if aux is not None and config.moe_router == "dropless":
        aux = balance_loss(aux, b * s, config)  # pooled over the layers
    elif aux is not None:
        aux = aux / config.n_layers  # the mean over layers (JAX aux_layers.mean())
    return _rms_norm(x, model.ln_f, config.rms_norm_eps), aux


def backbone(model: Transformer, tokens: torch.Tensor,
             config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D]. `config`
    overrides the model's own (same shapes; e.g. another attn_impl). Under
    a mesh, tokens and hidden states are this rank's rows of the batch and
    its slice of the sequence, and RoPE takes the slice's global positions
    (the JAX `_rope` docstring)."""
    return _backbone(model, tokens, config or model.config)[0]


def _head_logits(x: torch.Tensor, lm_head: torch.Tensor,
                 mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """fp32 logits; under a mesh this rank's vocab slice [.., V/tensor]. The
    product and its gradients are head_gemm's op (x @ W on the CPU)."""
    if mesh is None:
        return head_matmul(x.float(), lm_head)
    return head_matmul(copy_to_tensor(x.float(), mesh), gather(lm_head, mesh, 0, ("fsdp",)))


def forward(model: Transformer, tokens: torch.Tensor,
            config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] fp32 (under a mesh: this rank's
    rows and vocab slice)."""
    return _head_logits(backbone(model, tokens, config), model.lm_head, model.mesh)


def _head_nll(x, lm_head, targets, mesh: Optional[DeviceMesh] = None):
    with span(HEAD):
        return _nll(_head_logits(x, lm_head, mesh), targets, mesh)


def _nll(logits, targets, mesh: Optional[DeviceMesh] = None):
    """Per-token cross-entropy of fp32 logits (under a mesh, this rank's
    vocab slice of them)."""
    if mesh is None:
        logz = torch.logsumexp(logits, dim=-1)
        target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        return logz - target_logit
    # Vocab-parallel: the logsumexp of the slices' own logsumexps, and the
    # target's logit from the one slice that holds it. With one slice this
    # is the unsharded computation bit for bit (exp(0) = 1, log(1) = 0).
    local = torch.logsumexp(logits, dim=-1)
    top = local.detach().clone()
    all_reduce(top, mesh, ("tensor",), dist.ReduceOp.MAX)
    logz = top + reduce_sum((local - top).exp(), mesh, ("tensor",)).log()
    width = logits.shape[-1]
    local = targets.long() - mesh.get_local_rank("tensor") * width
    inside = (local >= 0) & (local < width)
    picked = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[..., 0]
    target_logit = reduce_sum(torch.where(inside, picked, 0.0), mesh, ("tensor",))
    return logz - target_logit


def _head(x, lm_head, targets, config: TransformerConfig,
          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Per-token cross-entropy of final-norm hidden states [b, s, D],
    checkpointed under `remat_head`; its backward under a profiler range
    `model.head.grad` (observe/spans.py)."""
    if config.remat_head:
        def head(x, lm_head):
            return checkpoint(_head_nll, x, lm_head, targets, mesh, use_reentrant=False)
    else:
        def head(x, lm_head):
            return _head_nll(x, lm_head, targets, mesh)
    return backward_span(HEAD_GRAD, head, x, lm_head)


def final_nll(x, ln_f, lm_head, targets, config: TransformerConfig,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """The final norm, the head and the per-token cross-entropy of the last
    layer's output x [b, s, D] (a pipeline's last stage)."""
    return _head(_rms_norm(x, ln_f, config.rms_norm_eps), lm_head, targets, config, mesh)


def masked_sums(nll: torch.Tensor, mask: Optional[torch.Tensor],
                mesh: Optional[DeviceMesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of nll*mask, sum of the mask), each over the global batch under
    a mesh (summed over the batch axes and `sequence`)."""
    mask = torch.ones_like(nll) if mask is None else mask.float()
    if mesh is None:
        return (nll * mask).sum(), mask.sum()
    return (reduce_sum((nll * mask).sum(), mesh, TOKEN_AXES),
            all_reduce(mask.sum(), mesh, TOKEN_AXES))


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, plus `router_aux_coef` times the
    layers' mean load-balancing loss for MoE; `batch` = {tokens, targets,
    mask}. Under a mesh the batch is this rank's rows and sequence slice,
    and the loss is the masked mean over the global batch on every rank:
    the sums of nll*mask and of the mask are each summed over the batch
    axes and `sequence` before the division. A pipelined model
    (`model.stages`) runs the GPipe schedule (pipeline.pipeline_loss), whose
    backward the schedule drives."""
    config = config or model.config
    if model.stages is not None:
        from training_operator_tpu_torch.trainer.pipeline import pipeline_loss

        return pipeline_loss(model, batch, config)
    mesh = model.mesh
    x, aux = _backbone(model, batch["tokens"], config)
    nll = _head(x, model.lm_head, batch["targets"], config, mesh)
    mask = batch.get("mask")
    if mesh is None and mask is None:
        ce = nll.mean()
    else:
        total, count = masked_sums(nll, mask, mesh)
        ce = total / torch.clamp(count, min=1.0)
    if config.n_experts > 0:
        return ce + config.router_aux_coef * aux
    return ce


# ----------------------------------------------------------------------
# The sharded half: the JAX param_specs, and the shards they give a rank
# ----------------------------------------------------------------------

# Per parameter, per tensor dim, the mesh axes that shard it, major first:
# the JAX `param_specs` (model.py:103-136) as tuples. Megatron TP: q/k/v and
# w1/w3 column-parallel (output dim on `tensor`), wo/w2 row-parallel (input
# dim on `tensor`), `fsdp` on the complementary dim; the [L] stack never
# sharded; the embedding's d over (fsdp, tensor), the head's vocab on
# `tensor` (sharded logits feed the vocab-parallel loss); norms replicated.
_COLUMN, _ROW = ((), ("fsdp",), ("tensor",)), ((), ("tensor",), ("fsdp",))
PARAM_SPECS: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "embed": ((), ("fsdp", "tensor")),
    "layers.ln1": ((), ()),
    "layers.wq": _COLUMN, "layers.wk": _COLUMN, "layers.wv": _COLUMN,
    "layers.wo": _ROW,
    "layers.ln2": ((), ()),
    "layers.w1": _COLUMN, "layers.w3": _COLUMN,
    "layers.w2": _ROW,
    "ln_f": ((),),
    "lm_head": (("fsdp",), ("tensor",)),
}

# A MoE layer's expert stacks lead with the expert dim on `expert`; its
# router is replicated (JAX model.py:110-116).
_EXPERT = ("expert",)
MOE_SPECS: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "layers.router": ((), (), ()),
    "layers.w1": ((), _EXPERT) + _COLUMN[1:], "layers.w3": ((), _EXPERT) + _COLUMN[1:],
    "layers.w2": ((), _EXPERT) + _ROW[1:],
}

# The dim a layer's [in, out] matrix gathers over fsdp (its spec without
# [L]); an expert stack's is one further (`_weight`).
LAYER_FSDP_DIM = {name.split(".")[1]: spec.index(("fsdp",)) - 1
                  for name, spec in PARAM_SPECS.items()
                  if name.startswith("layers.") and ("fsdp",) in spec}

Specs = Dict[str, Tuple[Tuple[str, ...], ...]]


def param_specs(config: TransformerConfig) -> Specs:
    """The JAX `param_specs(config)` by the port's parameter names: the
    dense table, or with `n_experts > 0` the expert stacks' and the
    router's."""
    config.validate()
    specs = dict(PARAM_SPECS)
    if config.n_experts > 0:
        specs.update(MOE_SPECS)
    if config.qk_norm:
        specs.update({"layers.q_norm": ((), ()), "layers.k_norm": ((), ())})
    return specs


def layout_specs(config: TransformerConfig, mesh: Optional[DeviceMesh]) -> Specs:
    """How a rank holds the parameters on `mesh`: `param_specs`, with the
    [L] dim of every layer weight on `pipeline` on a pipeline mesh (the
    JAX `_stage_specs` fold, pipeline.py:37-41: each stage holds its L/P
    layers). JAX keeps the whole stack on every pipeline rank at rest and
    reshards it inside the step; the global tensors are the same."""
    specs = param_specs(config)
    if mesh is None or axis_size(mesh, "pipeline") == 1:
        return specs
    return {name: ((("pipeline",),) + spec[1:]) if name.startswith("layers.") else spec
            for name, spec in specs.items()}


def spec_axes(name: str, specs: Specs) -> Tuple[str, ...]:
    """The mesh axes that shard parameter `name`."""
    return tuple(a for dim in specs[name] for a in dim)


def param_placements(name: str, specs: Specs = PARAM_SPECS) -> list:
    """The DTensor placements over AXIS_ORDER of parameter `name`: Shard(d)
    on each axis that shards dim d, Replicate elsewhere. Where two axes
    shard one dim (the embedding), AXIS_ORDER lists fsdp before tensor,
    which is DTensor's major-first order and the JAX spec's."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in AXIS_ORDER]
    for dim, axes in enumerate(specs[name]):
        for axis in axes:
            out[AXIS_ORDER.index(axis)] = Shard(dim)
    return out


def _shard_index(axes: Tuple[str, ...], mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's block, block count) of a dim sharded over `axes`."""
    index, count = 0, 1
    for axis in axes:
        index = index * axis_size(mesh, axis) + mesh.get_local_rank(axis)
        count *= axis_size(mesh, axis)
    return index, count


def local_shape(name: str, shape, mesh: DeviceMesh, specs: Specs) -> Tuple[int, ...]:
    """The shape of this rank's shard of parameter `name` (whole `shape`)."""
    out = []
    for dim, size in enumerate(shape):
        _, count = _shard_index(specs[name][dim], mesh)
        if size % count:
            raise ValueError(f"{name} dim {dim} of size {size} does not split "
                             f"over {specs[name][dim]} ({count} shards)")
        out.append(size // count)
    return tuple(out)


def local_shard(name: str, full: torch.Tensor, mesh: DeviceMesh, specs: Specs) -> torch.Tensor:
    """The block of `full` that the sharding of parameter `name` puts at
    this rank's mesh coordinate."""
    local_shape(name, full.shape, mesh, specs)  # raises where a dim does not split
    out = full
    for dim in range(full.dim()):
        index, count = _shard_index(specs[name][dim], mesh)
        out = out.chunk(count, dim)[index]
    return out


def _check_mesh(config: TransformerConfig, mesh) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"sharding needs a DeviceMesh (mesh.build_mesh), not {mesh!r}")
    if config.unsharded_only:
        raise ValueError("the dropless MoE layer and qk-norm run unsharded only")
    # The JAX attention falls back to its unsharded path where the heads do
    # not split over `tensor`; the port raises.
    tensor = axis_size(mesh, "tensor")
    for what, n in (("n_heads", config.n_heads), ("n_kv_heads", config.n_kv_heads)):
        if n % tensor:
            raise ValueError(f"{what}={n} does not split over tensor={tensor}")
    stages = axis_size(mesh, "pipeline")
    if config.n_layers % stages:
        raise ValueError(f"n_layers={config.n_layers} not divisible by pipeline={stages}")


def _attach(model: Transformer, mesh: DeviceMesh, specs: Specs) -> Transformer:
    """Sends the forward of a model holding its shards through `mesh`."""
    model.mesh, model.specs = mesh, specs
    if axis_size(mesh, "pipeline") > 1:
        from training_operator_tpu_torch.trainer.pipeline import GroupStages

        model.stages = GroupStages(mesh)
    return model


def _build_sharded(config: TransformerConfig, mesh: DeviceMesh,
                   make: Callable[[str, Tuple[int, ...], Specs], torch.Tensor]) -> Transformer:
    """A sharded model whose parameter `name` is `make(name, whole shape,
    layout specs)`, made one parameter after another in the model's order;
    nothing whole is allocated here."""
    _check_mesh(config, mesh)
    specs = layout_specs(config, mesh)
    model = Transformer(config, "meta")
    for name, p in list(model.named_parameters()):
        _set_param(model, name, make(name, tuple(p.shape), specs))
    return _attach(model, mesh, specs)


def _set_param(model: Transformer, name: str, value: torch.Tensor) -> None:
    owner = model.layers if name.startswith("layers.") else model
    setattr(owner, name.split(".")[-1], nn.Parameter(value))


@torch.no_grad()
def shard_model(model: Transformer, mesh: DeviceMesh) -> Transformer:
    """Replaces every parameter of an unsharded model by this rank's shard
    (`local_shard`; a copy, so the full tensors can be freed) and sends the
    forward through the mesh. The batch given to `loss_fn` is then this
    rank's rows and sequence slice (mesh.shard_batch)."""
    _check_mesh(model.config, mesh)
    if model.mesh is not None or model.stages is not None:
        raise ValueError("the model is sharded or pipelined already")
    specs = layout_specs(model.config, mesh)
    for name, p in list(model.named_parameters()):
        local = local_shard(name, p.detach(), mesh, specs).clone(
            memory_format=torch.contiguous_format)
        _set_param(model, name, local)
    return _attach(model, mesh, specs)


@torch.no_grad()
def reduce_gradients(model: Transformer) -> None:
    """After backward on a sharded model: sums each gradient over the axes
    that split the tokens (the batch axes and `sequence`) and do not shard
    its parameter (the fsdp sums already happened in the gathers'
    backward), as the data-parallel all-reduce; and, on a pipeline mesh,
    over `pipeline` for the parameters every stage holds whole (the
    embedding's gradient lives on the first stage, the final norm's and the
    head's on the last). An expert stack is not summed over `expert`: its
    gradient already holds every token routed to this rank's experts,
    through the all-to-all's backward."""
    mesh, specs = model.mesh, model.specs
    staged = axis_size(mesh, "pipeline") > 1
    for name, p in model.named_parameters():
        sharded = spec_axes(name, specs)
        axes = [a for a in TOKEN_AXES if a not in sharded]
        if staged and "pipeline" not in sharded:
            axes.append("pipeline")
        all_reduce(p.grad, mesh, axes)
