"""Clip by the global norm and AdamW: two multi-tensor passes on the card,
a loop of torch ops on the CPU.

`train.global_norm` and `train.AdamW.update` ask `fused` which path a
parameter's tensors take. CPU tensors take the loop (`plain_update`, and
the norm's `t.float().square().sum()`), the reference the kernels are held
to on the card and the path the CPU parity tests hold to optax. Tensors on
the card take the kernels; one they refuse (`refusal`: not float32, not
contiguous, shapes that differ, not on one CUDA device) raises, naming
why, so nothing on the card falls back to the loop. `csrc/adamw_fp32.cu`
holds the kernels:

  square_sums   each gradient's fp32 sum of squares and the global norm
                (sumsq_kernel, then sumsq_finish_kernel)
  update        clip and AdamW in place on p, mu and nu, the clip decided
                on the card from the norm (adamw_update_kernel)

Both read a table, a row of COLUMNS per tensor (`table_rows`), built once
in pinned host memory for a set of tensors and reused while their data
pointers and sizes stay the same (`_TABLES`, the last TABLES_KEPT). Each
call copies it to the card asynchronously, so neither pass waits for the
card, and frees it with the norm's scratch after the launch: between steps
the optimizer holds no device memory beyond the state. Each launch adds
one to `launches[pass]`. The state keeps its layout: mu and nu stay a
tensor per parameter.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from training_operator_tpu_torch.trainer import kernels

CHUNK = 1 << 16  # elements a block; csrc/adamw_fp32.cu's kChunk
COLUMNS = ("p", "g", "mu", "nu", "numel", "chunk0")  # the table's int64 columns
TABLES_KEPT = 8  # pinned host tables kept for reuse
# The most elements `plain_update` treats at once (1 GiB of fp32): its
# temporaries stay that size (a MoE expert stack of the flagship's width
# is 3.6 GB).
UPDATE_CHUNK = 1 << 28

# Launches per pass since the last reset_launches().
launches: Dict[str, int] = {"sumsq": 0, "update": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def refusal(*tensors: torch.Tensor) -> Optional[str]:
    """Why the kernels do not take these tensors (a parameter, its gradient
    and its moments, or a gradient alone), or None where they do."""
    first = tensors[0]
    if any(t.shape != first.shape for t in tensors):
        return "shapes differ"
    if any(t.dtype != torch.float32 for t in tensors):
        return "not float32"
    if not all(t.is_contiguous() for t in tensors):
        return "not contiguous"
    if first.device.type != "cuda" or any(t.device != first.device for t in tensors):
        return "not on one CUDA device"
    return None


def fused(name: str, *tensors: torch.Tensor) -> bool:
    """Whether parameter `name`'s tensors (p, g, mu and nu, or a gradient
    alone) take the kernels: False where all are on the CPU (the loop's),
    True where `refusal` takes them. Raises for any other, naming why."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    why = refusal(*tensors)
    if why is not None:
        raise ValueError(f"{name}: clip + AdamW on the card takes float32, contiguous tensors "
                         f"of one shape on one CUDA device; these are refused: {why}")
    return True


def table_rows(groups: Sequence[Sequence[Optional[torch.Tensor]]]) -> Tuple[List[List[int]], int]:
    """The kernels' table for `groups` of (p, g, mu, nu), with p, mu and nu
    None for the norm alone: a row of COLUMNS per group (a missing tensor's
    pointer 0), and the chunks of CHUNK elements over every row. An empty
    tensor keeps its row, with no chunk. Raises where a group's shapes
    differ."""
    rows, chunks = [], 0
    for group in groups:
        present = [t for t in group if t is not None]
        if any(t.shape != present[0].shape for t in present):
            raise ValueError(f"p, g, mu and nu differ in shape: "
                             f"{[tuple(t.shape) for t in present]}")
        n = present[0].numel()
        rows.append([0 if t is None else t.data_ptr() for t in group] + [n, chunks])
        chunks += -(-n // CHUNK)
    return rows, chunks


class _Tables:
    """Pinned host tables by their rows, the last TABLES_KEPT kept: a set of
    tensors whose pointers and sizes recur reuses its table."""

    def __init__(self):
        self._tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()

    def get(self, rows: List[List[int]], device: torch.device) -> torch.Tensor:
        """The table of `rows` on `device`, copied there without a wait."""
        key = tuple(map(tuple, rows))
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = torch.tensor(rows, dtype=torch.int64).pin_memory()
            if len(self._tables) > TABLES_KEPT:
                self._tables.popitem(last=False)
        else:
            self._tables.move_to_end(key)
        return table.to(device, non_blocking=True)


# Keyed by the tables' contents alone, so every caller may share it.
_TABLES = _Tables()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def square_sums(grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the fp32 sum of squares of each gradient, [len(grads)]; the global
    norm, the 0-d fp32 square root of their total). Each gradient must pass
    `refusal`, all on one device."""
    device = grads[0].device
    rows, chunks = table_rows([(None, g, None, None) for g in grads])
    if chunks == 0:
        return (torch.zeros(len(grads), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))
    sums = torch.empty(len(grads), dtype=torch.float32, device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    partials = torch.empty(chunks, dtype=torch.float64, device=device)
    table = _TABLES.get(rows, device)
    kernels.load().call("adamw_sumsq_fp32", table.data_ptr(), len(rows), chunks,
                        partials.data_ptr(), sums.data_ptr(), norm.data_ptr(), _stream(device))
    launches["sumsq"] += 1
    return sums, norm


def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], norm: torch.Tensor, *,
           clip_norm: float, lr: float, b1: float, b2: float, bc1: float, bc2: float,
           eps: float, weight_decay: float) -> None:
    """Clip by `norm` (a 0-d fp32 tensor on the card, the global norm of the
    raw gradients) and one AdamW step, in place on every p, mu and nu. Each
    (p, g, mu, nu) must pass `refusal`, all on one device."""
    if norm.dtype != torch.float32 or norm.numel() != 1 or norm.device != params[0].device:
        raise ValueError(f"the norm must be one float32 on {params[0].device}; got "
                         f"{norm.dtype} {tuple(norm.shape)} on {norm.device}")
    rows, chunks = table_rows(list(zip(params, grads, mus, nus)))
    if chunks == 0:
        return
    device = params[0].device
    table = _TABLES.get(rows, device)
    kernels.load().call("adamw_update_fp32", table.data_ptr(), len(rows), chunks,
                        norm.data_ptr(), clip_norm, lr, b1, b2, bc1, bc2, eps, weight_decay,
                        _stream(device))
    launches["update"] += 1
    for t in (*params, *mus, *nus):
        torch.autograd.graph.increment_version(t)


def plain_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor], norm: torch.Tensor,
                 *, clip_norm: float, lr: float, b1: float, b2: float, bc1: float, bc2: float,
                 eps: float, weight_decay: float) -> None:
    """`update` as a loop of torch ops, a tensor of more than UPDATE_CHUNK
    elements one run of its leading dim at a time (the update is
    elementwise, so the numbers are the same): the CPU's path, and the
    reference the kernels are held to. Any dtype, layout or device."""
    clip = norm >= clip_norm
    for whole, grad, mu_whole, nu_whole in zip(params, grads, mus, nus):
        parts = -(-whole.numel() // UPDATE_CHUNK)
        for p, g, mu, nu in zip(*(t.chunk(parts) for t in (whole, grad, mu_whole, nu_whole))):
            g = torch.where(clip, g / norm * clip_norm, g)
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (mu / bc1) / ((nu / bc2).sqrt_() + eps)
            upd.add_(p, alpha=weight_decay)
            p.add_(upd, alpha=-lr)
