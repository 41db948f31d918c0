"""The model head's fp32 products: a hand-written 3xTF32 wgmma GEMM.

The head computes fp32 logits = x W from final-norm hidden states x [.., D]
and the head weight W [D, V] (the JAX package leaves `x.astype(f32) @
lm_head` to XLA's dot, so no Pallas kernel stands behind this one). On the
card cuBLAS runs an fp32 product on the CUDA cores; the kernel in
`csrc/head_gemm_fp32.cu` runs it on the tensor cores in the 3xTF32 split
(fp32-class precision, not TF32) for the three products of the head:

  logits = x W     head_logits    (the forward and its recompute)
  dX     = dL Wᵀ   head_dx        (the gradient of x)
  dW     = xᵀ dL   head_dw        (the gradient of W)

Each wrapper dispatches on the device of its inputs: CPU tensors take the
plain product (`x @ W` and the products autograd would take for it, bit for
bit), CUDA tensors launch the kernel or raise. Every launch adds one to
`launches[product]`. `head_matmul` is the dispatcher op
`training_operator_tpu_torch::head_matmul_fp32`, whose backward runs the
ops `head_matmul_fp32_dx` and `head_matmul_fp32_dw`; it saves what
autograd saves for `x @ W`: x and W.

`plan` picks, from (T, D, V), what the kernel adapts: the k blocks summed
apart (the tensor cores add with truncation, so a long k is summed in
chunks of at most CHUNK_MAX) and how many rows of tiles are dealt together.
The tile is 128 x 128 for every shape: a consumer warpgroup's 64 x 128
chunk sum and running sum take 128 of its registers.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict

import torch

from training_operator_tpu_torch.trainer import kernels

PRODUCTS = ("logits", "dx", "dw")
TILE = 128  # rows and columns of C per block
BLOCK_K = 32  # k of one ring stage
CHUNK_MAX = 256  # most k summed in one chunk before the rounded fp32 add
H100_SMS = 132

# Launches per product since the last reset_launches().
launches: Dict[str, int] = dict.fromkeys(PRODUCTS, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@dataclass(frozen=True)
class Plan:
    """One product as the kernel runs it: C [M x N] = A [M x K] B [K x N]."""

    m: int
    n: int
    k: int
    chunk: int  # k blocks of BLOCK_K summed from zero before joining the sum
    group: int  # rows of tiles dealt to consecutive blocks
    tiles: int  # blocks launched


def plan(product: str, t: int, d: int, v: int, sms: int = H100_SMS) -> Plan:
    """The chunk and the tile grouping for x [t, d], W [d, v]. (M, N, K)
    is the kernel's orientation: the operand that is K-major in memory is
    wgmma's shared-memory B (x for the logits and dW, W for dX), so the
    logits and dW come out transposed. Chunks are as even as the k blocks
    allow, none past CHUNK_MAX; a group is about sqrt(sms) rows of tiles,
    so one wave of blocks reads about as many panels of A as of B."""
    if product not in PRODUCTS:
        raise ValueError(f"product must be one of {PRODUCTS}; got {product!r}")
    m, n, k = {"logits": (v, t, d), "dx": (t, d, v), "dw": (v, d, t)}[product]
    if min(m, n, k) <= 0:
        raise ValueError(f"empty product: M={m}, N={n}, K={k}")
    blocks = -(-k // BLOCK_K)
    chunks = -(-blocks // (CHUNK_MAX // BLOCK_K))
    chunk = -(-blocks // chunks)
    tiles_m, tiles_n = -(-m // TILE), -(-n // TILE)
    group = max(1, min(tiles_m, round(math.sqrt(sms))))
    return Plan(m, n, k, chunk, group, tiles_m * tiles_n)


# ----------------------------------------------------------------------
# Plain versions: the products autograd takes for x @ W
# ----------------------------------------------------------------------

def head_logits_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def head_dx_plain(dl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (dl.reshape(-1, w.shape[1]) @ w.t()).reshape(*dl.shape[:-1], w.shape[0])


def head_dw_plain(x: torch.Tensor, dl: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).t() @ dl.reshape(-1, dl.shape[-1])


# ----------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on the card
# ----------------------------------------------------------------------

def _on_cpu(*xs: torch.Tensor) -> bool:
    devices = {x.device.type for x in xs}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"head inputs must all lie on the CPU or all on the card; "
                     f"got {sorted(devices)}")


def _check(a: torch.Tensor, b: torch.Tensor, shapes_match: bool) -> None:
    """float32 operands whose shapes agree as the kernel reads them."""
    for x in (a, b):
        if x.dtype != torch.float32:
            raise ValueError(f"the head kernel takes float32; got {x.dtype}")
    if not shapes_match:
        raise ValueError(f"head operands do not match: {tuple(a.shape)} and {tuple(b.shape)}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(product: str, entry: str, p0, p1, out, t: int, d: int, v: int) -> None:
    pl = plan(product, t, d, v, _sms(out.device.index or 0))
    kernels.load().call(entry, p0.data_ptr(), p1.data_ptr(), out.data_ptr(), t, d, v,
                        pl.chunk, pl.group, torch.cuda.current_stream(out.device).cuda_stream)
    launches[product] += 1


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """logits [.., V] = x [.., D] W [D, V]."""
    if _on_cpu(x, w):
        return head_logits_plain(x, w)
    _check(x, w, w.dim() == 2 and x.dim() >= 1 and x.shape[-1] == w.shape[0])
    d, v = w.shape
    x2, w = x.reshape(-1, d).contiguous(), w.contiguous()
    out = x2.new_empty((x2.shape[0], v))
    if out.numel():
        _launch("logits", "head_logits_fp32", x2, w, out, x2.shape[0], d, v)
    return out.reshape(*x.shape[:-1], v)


def head_dx(dl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX [.., D] = dL [.., V] Wᵀ."""
    if _on_cpu(dl, w):
        return head_dx_plain(dl, w)
    _check(dl, w, w.dim() == 2 and dl.dim() >= 1 and dl.shape[-1] == w.shape[1])
    d, v = w.shape
    dl2, w = dl.reshape(-1, v).contiguous(), w.contiguous()
    out = dl2.new_empty((dl2.shape[0], d))
    if out.numel():
        _launch("dx", "head_dx_fp32", dl2, w, out, dl2.shape[0], d, v)
    return out.reshape(*dl.shape[:-1], d)


def head_dw(x: torch.Tensor, dl: torch.Tensor) -> torch.Tensor:
    """dW [D, V] = xᵀ dL over every row of x [.., D] and dL [.., V]."""
    if _on_cpu(x, dl):
        return head_dw_plain(x, dl)
    _check(x, dl, x.dim() >= 1 and x.shape[:-1] == dl.shape[:-1])
    d, v = x.shape[-1], dl.shape[-1]
    x2, dl2 = x.reshape(-1, d).contiguous(), dl.reshape(-1, v).contiguous()
    if x2.shape[0] == 0:
        return x2.new_zeros((d, v))
    out = x2.new_empty((d, v))
    _launch("dw", "head_dw_fp32", x2, dl2, out, x2.shape[0], d, v)
    return out


# ----------------------------------------------------------------------
# Dispatcher ops and their autograd rule
# ----------------------------------------------------------------------
# Registered as torch.library custom ops like the flash kernels
# (flash.py), so a profiler links each launch to its op and to the ranges
# around it (model.head, model.head.grad).

OPS = "training_operator_tpu_torch"


@torch.library.custom_op(f"{OPS}::head_matmul_fp32", mutates_args=())
def _head_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return head_logits(x, w)


@_head_matmul_op.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[1]))


@torch.library.custom_op(f"{OPS}::head_matmul_fp32_dx", mutates_args=())
def _head_dx_op(dl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return head_dx(dl, w)


@_head_dx_op.register_fake
def _(dl, w):
    return dl.new_empty((*dl.shape[:-1], w.shape[0]))


@torch.library.custom_op(f"{OPS}::head_matmul_fp32_dw", mutates_args=())
def _head_dw_op(x: torch.Tensor, dl: torch.Tensor) -> torch.Tensor:
    return head_dw(x, dl)


@_head_dw_op.register_fake
def _(x, dl):
    return x.new_empty((x.shape[-1], dl.shape[-1]))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    x, w = ctx.saved_tensors
    ops = torch.ops.training_operator_tpu_torch
    dx = ops.head_matmul_fp32_dx(g, w) if ctx.needs_input_grad[0] else None
    dw = ops.head_matmul_fp32_dw(x, g) if ctx.needs_input_grad[1] else None
    return dx, dw


_head_matmul_op.register_autograd(_backward, setup_context=_setup)


def head_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 x [.., D] @ W [D, V] with its gradients, through the kernel on
    the card."""
    return torch.ops.training_operator_tpu_torch.head_matmul_fp32(x, w)
