"""Flash attention: the hand-written CUDA kernels and their autograd rule.

Counterpart of training_operator_tpu/trainer/flash.py. Three kernels, in
`csrc/`, each beside a plain PyTorch version of the same function in this
module:

  flash_fwd      out, lse     <- q, k, v                   (csrc/flash_fwd.cu)
  flash_bwd_dq   dq           <- q, k, v, dO, lse, delta   (csrc/flash_bwd_dq.cu)
  flash_bwd_dkv  dk, dv       <- q, k, v, dO, lse, delta   (csrc/flash_bwd_dkv.cu)

Each wrapper dispatches on the device of its inputs: a CPU tensor goes to the
plain version (the CPU tests), a CUDA tensor launches the kernel of its
dtype or raises. There is no fallback from the card to the plain version.
Every launch adds one to `launches[name]` and to `launches_dtype[type][name]`. The wrappers are registered as dispatcher ops
(`torch.ops.training_operator_tpu_torch.flash_*`) that carry the autograd
rule, so selective remat can keep the forward op's outputs.

Shapes follow the JAX package: q, k, v are [B, S, H, D] with equal head
counts (GQA is expanded by attention.py's dispatcher); lse is [B*H, S, 1]
fp32. Unlike the TPU kernels, nothing is padded to 128: the kernels mask
keys past S themselves. On the card the kernels take bf16, fp16 and fp32 at
head_dim 64, 128 or 256, at any batch*heads; any other dtype or head_dim
raises there. bf16 and fp16 run the wgmma kernels (`csrc/flash_*.cu`, one
instantiation per type: the products in the input dtype, fp32 sums, as the
JAX kernels), fp32 its own kernels (`csrc/flash_*_fp32.cu`: 3xTF32 products
on mma.sync, fp32-class precision; plain TF32 would miss the JAX package's
fp32 tolerance 30-50 times over).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from training_operator_tpu_torch.trainer import kernels

_MASK = -1e30

# The dtypes the kernels take, by the suffix of their C entry points.
KERNEL_TYPES = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}
KERNEL_DTYPES = tuple(KERNEL_TYPES)
KERNEL_HEAD_DIMS = (64, 128, 256)

# Launches per kernel since the last reset_launches(): a run reads them to
# show that its path went through the kernels. `launches_causal` counts the
# causal ones among them (the ring launches both kinds), `launches_dtype`
# the launches of each type's instantiation ("bf16", "fp16", "fp32").
launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
launches_causal: Dict[str, int] = dict(launches)
launches_dtype: Dict[str, Dict[str, int]] = {t: dict(launches) for t in KERNEL_TYPES.values()}


def reset_launches() -> None:
    for counts in (launches, launches_causal, *launches_dtype.values()):
        for name in counts:
            counts[name] = 0


def _count(name: str, causal: bool, dtype: torch.dtype) -> None:
    launches[name] += 1
    launches_causal[name] += int(causal)
    launches_dtype[KERNEL_TYPES[dtype]][name] += 1


def kernel_supports(q: torch.Tensor) -> bool:
    """Whether the CUDA kernels take this dtype and head_dim (what `auto`
    sends them on the card; they take any batch, heads and length)."""
    return q.dtype in KERNEL_DTYPES and q.shape[-1] in KERNEL_HEAD_DIMS


# ----------------------------------------------------------------------
# Plain versions: the full masked score matrix, fp32 throughout
# ----------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Masked, scaled scores [B, H, S, S] in fp32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _MASK)
    return s


def _rows(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, S(, 1)] row statistics as [B, H, S, 1]."""
    return x.reshape(b, h, -1, 1)


def flash_fwd_plain(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """out [B, S, H, D] (q's dtype) and lse [B*H, S, 1] fp32."""
    b, s, h, _ = q.shape
    sc = _scores(q, k, causal)
    lse = torch.logsumexp(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - lse)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.reshape(b * h, s, 1)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dq = d^-0.5 * (p * (dO vᵀ - delta)) k, with p = exp(s - lse)."""
    b, _, h, d = q.shape
    p = torch.exp(_scores(q, k, causal) - _rows(lse, b, h))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _rows(delta, b, h))
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * d ** -0.5).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True):
    """dk = d^-0.5 * dsᵀ q and dv = pᵀ dO."""
    b, _, h, d = q.shape
    p = torch.exp(_scores(q, k, causal) - _rows(lse, b, h))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _rows(delta, b, h))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * d ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on the card
# ----------------------------------------------------------------------

def _on_cpu(*xs: torch.Tensor) -> bool:
    devices = {x.device.type for x in xs}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"flash attention inputs must all lie on the CPU or all on "
                     f"the card; got {sorted(devices)}")


def _check_kernel_inputs(*xs: torch.Tensor) -> None:
    q = xs[0]
    if not kernel_supports(q):
        raise ValueError(
            f"the flash kernels take dtype {KERNEL_DTYPES} and head_dim "
            f"{KERNEL_HEAD_DIMS}; got {q.dtype} and head_dim {q.shape[-1]}"
        )
    for x in xs:
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"flash inputs differ: {tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")


def _contig(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (out [B, S, H, D], lse [B*H, S, 1] fp32)."""
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal)
    q, k, v = _contig(q), _contig(k), _contig(v)
    _check_kernel_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    kernels.load().call(
        f"flash_fwd_{KERNEL_TYPES[q.dtype]}", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, d, int(causal), d ** -0.5, _stream(),
    )
    _count("flash_fwd", causal, q.dtype)
    return out, lse


def _bwd_inputs(q, k, v, do, lse, delta):
    q, k, v, do = _contig(q), _contig(k), _contig(v), _contig(do)
    _check_kernel_inputs(q, k, v, do)
    b, s, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.numel() != b * h * s:
            raise ValueError(f"{name} must be fp32 with B*H*S elements")
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True) -> torch.Tensor:
    """dq kernel; lse and delta are [B*H, S(, 1)] fp32."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    kernels.load().call(
        f"flash_bwd_dq_{KERNEL_TYPES[q.dtype]}", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, h, d, int(causal),
        d ** -0.5, _stream(),
    )
    _count("flash_bwd_dq", causal, q.dtype)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """dk/dv kernel; returns (dk, dv)."""
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    q, k, v, do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    b, s, h, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    kernels.load().call(
        f"flash_bwd_dkv_{KERNEL_TYPES[q.dtype]}", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
        int(causal), d ** -0.5, _stream(),
    )
    _count("flash_bwd_dkv", causal, q.dtype)
    return dk, dv


# ----------------------------------------------------------------------
# Dispatcher ops and their autograd rule
# ----------------------------------------------------------------------
# The three wrappers are registered as torch.library custom ops, each with a
# fake (meta) version, so the dispatcher sees the kernels as ops: a selective
# remat policy can name the forward op and keep its (out, lse), as the JAX
# package names the custom_vjp residuals "attn_out" and "attn_lse"
# (model.py, save_attn). The ops call the wrappers above, so the CPU takes
# the plain versions, the card launches the kernels, and `launches` counts
# every launch.

OPS = "training_operator_tpu_torch"


@torch.library.custom_op(f"{OPS}::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, causal)


@_flash_fwd_op.register_fake
def _(q, k, v, causal):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, s, 1), dtype=torch.float32)


@torch.library.custom_op(f"{OPS}::flash_bwd_dq", mutates_args=())
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                     lse: torch.Tensor, delta: torch.Tensor, causal: bool) -> torch.Tensor:
    return flash_bwd_dq(q, k, v, do, lse, delta, causal)


@_flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, causal):
    return torch.empty_like(q)


@torch.library.custom_op(f"{OPS}::flash_bwd_dkv", mutates_args=())
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                      lse: torch.Tensor, delta: torch.Tensor,
                      causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_bwd_dkv(q, k, v, do, lse, delta, causal)


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, causal):
    return torch.empty_like(k), torch.empty_like(v)


# The forward op as the dispatcher sees it (what a remat policy matches).
FLASH_FWD_OP = torch.ops.training_operator_tpu_torch.flash_fwd.default


def save_residuals(ctx, inputs, output):
    """Residuals (q, k, v, out, lse), as the JAX custom_vjp saves them, for
    every attention op of the port (inputs q, k, v, causal, then any
    others, kept as `ctx.extra`); the lse output's cotangent is dropped (it
    feeds no loss)."""
    q, k, v, causal = inputs[:4]
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.extra = causal, inputs[4:]
    ctx.mark_non_differentiable(lse)


def row_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta_i = rowsum(dO_i * O_i) in fp32, outside the kernels as in the
    JAX backward, folded to the kernels' [B*H, S] row order."""
    b, s, h, _ = out.shape
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)


def _backward(ctx, g, _g_lse):
    q, k, v, out, lse = ctx.saved_tensors
    delta = row_delta(g, out)
    ops = torch.ops.training_operator_tpu_torch
    dq = ops.flash_bwd_dq(q, k, v, g, lse, delta, ctx.causal)
    dk, dv = ops.flash_bwd_dkv(q, k, v, g, lse, delta, ctx.causal)
    return dq, dk, dv, None


_flash_fwd_op.register_autograd(_backward, setup_context=save_residuals)


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """(out [B, S, H, D], lse [B*H, S, 1] fp32). The lse is a primal output
    without a gradient: a loss built from it gets none back through it."""
    return torch.ops.training_operator_tpu_torch.flash_fwd(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention on [B, S, H, D]; K/V carry Q's head count."""
    return flash_attention_with_lse(q, k, v, causal)[0]
