"""The dropless expert layer's token permutation on the card: the two entry
points of `csrc/moe_permute.cu`, four uses.

`moe._Dispatch` and `moe._Combine` ask `fused` which path a call takes.
CPU tensors take the torch ops (`moe.plain_dispatch`,
`moe.plain_dispatch_backward`, `moe.plain_combine`), the reference the
kernels are held to on the card and the path the CPU tests hold to the
benchmark's reference. Tensors on the card take the kernels; a call they
refuse (`refusal`: rows not bf16, dest not int64, gate not fp32, not
contiguous, shapes that disagree, not on one CUDA device) raises, naming
why, so nothing on the card falls back to the torch ops.

  scatter     out[dest[t, j]] = src[t], rows dest does not name zeroed (the
              dispatch); with a gate, bf16(src[t] bf16(gate[t, j])) and, in
              the same pass, grad_gate[t, j] = src[t] . y[dest[t, j]] in fp32
              (the combine's backward)
  gather_sum  out[t] = the fp32 sum over j of bf16(buf[dest[t, j]]
              bf16(gate[t, j])), rounded once (the combine); with no gate,
              of buf[dest[t, j]] (the dispatch's backward)

dest is [T, k] int64: k, D and the rows come from the shapes, so any top-k
up to MAX_K takes the same kernels. Neither reads anything back to the host.
Each launch adds one to `launches[kernel]`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from training_operator_tpu_torch.trainer import kernels

MAX_K = 32  # choices a token: one a lane of the token's warp (kMaxK)

# Launches per kernel since the last reset_launches().
launches: Dict[str, int] = {"scatter": 0, "gather_sum": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def fused(*tensors: torch.Tensor) -> bool:
    """Whether a call on these tensors takes the kernels: False where all
    lie on the CPU (the torch ops), True otherwise; `scatter` and
    `gather_sum` then raise for what they refuse, mixed devices included."""
    return not all(t.device.type == "cpu" for t in tensors)


def refusal(dest: torch.Tensor, gate: Optional[torch.Tensor] = None,
            buf: Optional[torch.Tensor] = None, src: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why the kernels do not take a call, or None where they do: `dest`
    [T, k] int64, `gate` [T, k] fp32 or None, and the call's bf16 rows, a
    buffer `buf` [M, D] and a source `src` [T, D]."""
    rows = [t for t in (buf, src) if t is not None]
    tensors = [*rows, dest] + ([] if gate is None else [gate])
    if any(t.dtype != torch.bfloat16 for t in rows):
        return "rows not bfloat16"
    if dest.dtype != torch.int64:
        return "dest not int64"
    if gate is not None and gate.dtype != torch.float32:
        return "gate not float32"
    if not all(t.is_contiguous() for t in tensors):
        return "not contiguous"
    if dest.dim() != 2 or not 1 <= dest.shape[1] <= MAX_K:
        return f"dest not [T, k] with k from 1 to {MAX_K}"
    if gate is not None and gate.shape != dest.shape:
        return "gate and dest shapes differ"
    if any(t.dim() != 2 or t.shape[1] != rows[0].shape[1] for t in rows):
        return "rows not [N, D] of one D"
    if src is not None and src.shape[0] != dest.shape[0]:
        return "src and dest differ in tokens"
    if rows[0].shape[1] % 8 or any(t.data_ptr() % 16 for t in rows):
        return "rows not whole 16-byte units"
    first = tensors[0]
    if first.device.type != "cuda" or any(t.device != first.device for t in tensors):
        return "not on one CUDA device"
    return None


def _check(what: str, why: Optional[str]) -> None:
    if why is not None:
        raise ValueError(f"{what}: the permutation on the card takes bf16 rows, int64 dest "
                         f"and fp32 gates, contiguous, of agreeing shapes, on one CUDA "
                         f"device; refused: {why}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def scatter(src: torch.Tensor, dest: torch.Tensor, rows: int, gate: Optional[torch.Tensor] = None,
            y: Optional[torch.Tensor] = None) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """src [T, D] -> out [rows, D]: out[dest[t, j]] = src[t], every row dest
    does not name zero. With `gate` [T, k] and `y` [rows, D], the rows are
    bf16(src[t] bf16(gate[t, j])) and the result is (out, grad_gate [T, k]
    fp32, src[t] . y[dest[t, j]]). dest must name each row at most once."""
    if (gate is None) != (y is None):
        raise ValueError("scatter takes a gate and y together, or neither")
    _check("scatter", "y's rows are not the output's" if y is not None and y.shape[0] != rows
           else refusal(dest, gate, y, src))
    tokens, k = dest.shape
    out = torch.empty(rows, src.shape[1], dtype=src.dtype, device=src.device)
    named = torch.empty(rows, dtype=torch.uint8, device=src.device)
    grad_gate = None if gate is None else torch.empty_like(gate)
    kernels.load().call("moe_scatter_bf16", src.data_ptr(), dest.data_ptr(), _ptr(gate), _ptr(y),
                        out.data_ptr(), _ptr(grad_gate), named.data_ptr(), tokens, k,
                        src.shape[1], rows, _stream(src.device))
    launches["scatter"] += 1
    return out if gate is None else (out, grad_gate)


def gather_sum(buf: torch.Tensor, dest: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """buf [M, D] -> out [T, D]: out[t] = bf16 of the fp32 sum over j, in j
    order, of bf16(buf[dest[t, j]] bf16(gate[t, j])), or of buf[dest[t, j]]
    with no gate. Every dest must lie in [0, M)."""
    _check("gather_sum", refusal(dest, gate, buf))
    tokens, k = dest.shape
    out = torch.empty(tokens, buf.shape[1], dtype=buf.dtype, device=buf.device)
    kernels.load().call("moe_gather_sum_bf16", buf.data_ptr(), dest.data_ptr(), _ptr(gate),
                        out.data_ptr(), tokens, k, buf.shape[1], _stream(buf.device))
    launches["gather_sum"] += 1
    return out
