"""Flagship model: the decoder-only transformer LM, dense path, in PyTorch.

Counterpart of training_operator_tpu/trainer/model.py (TransformerConfig,
init_params, backbone, loss_fn). The parameters keep the JAX package's
names and layout so the weight bridge (convert.py) is a renaming:

- per-layer weights are stacked on a leading [L] axis (`layers.wq` is
  [L, d_model, q_dim]) and the decoder loops over that axis;
- matrices are stored [in, out] and applied as `h @ w`, not `nn.Linear`'s
  [out, in];
- parameters are fp32; each product casts its weight to `config.dtype`
  (bf16 by default), and the lm head runs in fp32.

Architecture: pre-RMSNorm, split-half rotary embeddings, GQA-capable
attention, SwiGLU MLP. `remat=True` wraps each layer in activation
checkpointing; `remat_head=True` does the same for the head and loss.
Mixture-of-experts, pipeline stages and the selective remat policies are not
ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from training_operator_tpu_torch.trainer.attention import attention


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
    # Mixture-of-experts; only 0 (dense) is ported.
    n_experts: int = 0
    expert_capacity: float = 1.25
    router_aux_coef: float = 0.01
    pipeline_microbatches: int = 0
    # "auto" (flash kernels on the card where they take the dtype and
    # head_dim), "flash", "xla" (the plain path).
    attn_impl: str = "auto"
    # Selective remat: only "full" (recompute the whole layer) is ported.
    remat_policy: str = "full"
    remat_head: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    REMAT_POLICIES = ("full", "mlp_only", "save_attn", "save_attn_qkv", "save_dots")

    def validate(self) -> None:
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads:
            raise ValueError("d_model must divide by n_heads and n_heads by n_kv_heads")
        if self.remat_policy not in self.REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                f"one of {self.REMAT_POLICIES}"
            )
        if self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not ported yet; use 'full'"
            )
        if self.n_experts != 0:
            raise NotImplementedError("mixture-of-experts (n_experts > 0) is not ported yet")


LAYER_PARAMS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")


class DecoderLayers(nn.Module):
    """Every layer's weights, stacked on a leading [L] axis."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        c = config
        dm, dff, L = c.d_model, c.d_ff, c.n_layers
        q_dim, kv_dim = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
        shapes = {
            "ln1": (L, dm), "wq": (L, dm, q_dim), "wk": (L, dm, kv_dim),
            "wv": (L, dm, kv_dim), "wo": (L, q_dim, dm), "ln2": (L, dm),
            "w1": (L, dm, dff), "w3": (L, dm, dff), "w2": (L, dff, dm),
        }
        for name in LAYER_PARAMS:
            self.register_parameter(
                name, nn.Parameter(torch.empty(shapes[name], device=device))
            )

    def unbind(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer views of the stacked weights. One `unbind` per stack:
        its backward stacks the layers' gradients once, where indexing each
        layer (`w[i]`) would add L zero-filled full-stack gradients."""
        stacks = {name: getattr(self, name).unbind(0) for name in LAYER_PARAMS}
        return [{name: stacks[name][i] for name in LAYER_PARAMS}
                for i in range(len(stacks["ln1"]))]


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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


@torch.no_grad()
def init_params(
    config: TransformerConfig,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Transformer:
    """Scaled-normal init in fp32 (the JAX init's distribution; the numbers
    differ, since torch's generator is not JAX's). The generator must live on
    `device`; by default one seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = Transformer(config, device)
    c = config
    std = c.d_model ** -0.5
    resid_std = std / (2 * c.n_layers) ** 0.5
    scales = {
        "embed": 1.0, "layers.wq": std, "layers.wk": std, "layers.wv": std,
        "layers.wo": resid_std, "layers.w1": std, "layers.w3": std,
        "layers.w2": resid_std, "lm_head": std,
    }
    for name, p in model.named_parameters():
        if name in scales:
            p.normal_(0.0, scales[name], generator=generator)
        else:  # the norm scales
            p.fill_(1.0)
    return model


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding on [B, S, H, D]; positions [B, S]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_block(x, lp, config: TransformerConfig, positions, attn_impl: str):
    """norm -> qkv -> rope -> attention -> output projection."""
    c = config
    b, s, _ = x.shape
    h = _rms_norm(x, lp["ln1"])
    q = (h @ lp["wq"].to(c.dtype)).reshape(b, s, c.n_heads, c.head_dim)
    k = (h @ lp["wk"].to(c.dtype)).reshape(b, s, c.n_kv_heads, c.head_dim)
    v = (h @ lp["wv"].to(c.dtype)).reshape(b, s, c.n_kv_heads, c.head_dim)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    attn = attention(q, k, v, causal=True, impl=attn_impl)
    return attn.reshape(b, s, c.n_heads * c.head_dim) @ lp["wo"].to(c.dtype)


def _mlp_block(x, lp, config: TransformerConfig):
    """norm -> SwiGLU."""
    c = config
    h = _rms_norm(x, lp["ln2"])
    gate = F.silu(h @ lp["w1"].to(c.dtype))
    up = h @ lp["w3"].to(c.dtype)
    return (gate * up) @ lp["w2"].to(c.dtype)


def decoder_layer(x, lp, config: TransformerConfig, positions, attn_impl: str = "auto"):
    """One pre-norm decoder block on [b, s, d]."""
    x = x + _attn_block(x, lp, config, positions, attn_impl)
    return x + _mlp_block(x, lp, config)


def backbone(model: Transformer, tokens: torch.Tensor,
             config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] -> final-norm hidden states [B, S, D]. `config`
    overrides the model's own (same shapes; e.g. another attn_impl)."""
    c = config or model.config
    b, s = tokens.shape
    x = model.embed.to(c.dtype)[tokens.long()]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    for lp in model.layers.unbind():
        if c.remat:
            x = checkpoint(decoder_layer, x, lp, c, positions, c.attn_impl,
                           use_reentrant=False)
        else:
            x = decoder_layer(x, lp, c, positions, c.attn_impl)
    return _rms_norm(x, model.ln_f)


def _head_logits(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    return x.float() @ lm_head


def forward(model: Transformer, tokens: torch.Tensor,
            config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] fp32."""
    return _head_logits(backbone(model, tokens, config), model.lm_head)


def _head_nll(x, lm_head, targets):
    logits = _head_logits(x, lm_head)
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - target_logit


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; `batch` = {tokens, targets, mask}."""
    config = config or model.config
    x = backbone(model, batch["tokens"], config)
    if config.remat_head:
        nll = checkpoint(_head_nll, x, model.lm_head, batch["targets"], use_reentrant=False)
    else:
        nll = _head_nll(x, model.lm_head, batch["targets"])
    mask = batch.get("mask")
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
