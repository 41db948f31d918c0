"""Attention on one device: the plain path and the flash dispatcher.

Counterpart of the single-device half of training_operator_tpu/trainer/
attention.py. Layout [batch, seq, heads, head_dim]. Ring and Ulysses
sequence parallelism are not ported yet.
"""

from __future__ import annotations

import torch

from training_operator_tpu_torch.trainer.flash import flash_attention, kernel_supports

_MASK_VALUE = -1e30

IMPLS = ("auto", "flash", "xla")


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


def attention(q, k, v, causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """Dispatch: `impl` "flash" takes the flash path (the CUDA kernels on the
    card, their plain versions on the CPU), "xla" the plain path, and "auto"
    takes flash on a CUDA tensor whenever the kernels take its dtype and
    head_dim, else the plain path. ("xla" keeps the JAX package's name.)

    GQA (fewer KV heads) is expanded here, once, for every backend:
    `repeat_interleave` on the head axis, as `jnp.repeat` does."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(f"attention impl {impl!r} is not ported yet")
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
    if impl == "flash" or (impl == "auto" and q.is_cuda and kernel_supports(q)):
        return flash_attention(q, k, v, causal)
    return plain_attention(q, k, v, causal)
