"""The benchmark's fixed arithmetic: peaks, model FLOPs, attention work and
the kernel-family rule.

Copied from the port's `training_operator_tpu_torch/trainer/bench.py` so that
a change to the port cannot move the yardstick it is measured by:

- `PEAK_BF16_FLOPS`, `PEAK_BYTES_PER_S` (bench.py:25-28): NVIDIA's H100 and
  H200 SXM data sheets, dense bf16 tensor-core FLOP/s and HBM bytes/s;
- `FLOPS_RULE`, `flops_per_step` (bench.py:154-166), with the parameter
  count of `_count_params` (bench.py:141-151) taken from shapes here, so no
  model has to be built to count;
- `attention_work` (bench.py:491-505);
- `kernel_family` (bench.py:327-335, `_kernel_family`).

Nothing here imports the port.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

PEAK_BF16_FLOPS = {"H100": 989e12, "H200": 989e12}
PEAK_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}

FLOPS_RULE = ("6 x active params per token (the embedding gather excluded; for MoE one "
              "expert's MLP per token, capacity padding and dropped tokens not counted) "
              "+ 6 x n_layers x seq x d_model causal attention")

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peak(table: Dict[str, float], device_name: str) -> Optional[float]:
    """The entry of `table` whose key is in the card's name, or None."""
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def param_shapes(dims: dict) -> Dict[str, tuple]:
    """Every parameter of the dense decoder by the port's names and layout:
    per-layer weights stacked on a leading [L] axis, matrices [in, out]."""
    dm, dff, L, V = dims["d_model"], dims["d_ff"], dims["n_layers"], dims["vocab_size"]
    hd = dm // dims["n_heads"]
    q_dim, kv_dim = dims["n_heads"] * hd, dims["n_kv_heads"] * hd
    return {
        "embed": (V, dm),
        "layers.ln1": (L, dm), "layers.wq": (L, dm, q_dim), "layers.wk": (L, dm, kv_dim),
        "layers.wv": (L, dm, kv_dim), "layers.wo": (L, q_dim, dm), "layers.ln2": (L, dm),
        "layers.w1": (L, dm, dff), "layers.w3": (L, dm, dff), "layers.w2": (L, dff, dm),
        "ln_f": (dm,), "lm_head": (dm, V),
    }


def count_params(dims: dict) -> tuple:
    """(total, in products): the embedding table is a gather, not a product
    (`_count_params` for a dense model)."""
    sizes = {n: _numel(s) for n, s in param_shapes(dims).items()}
    total = sum(sizes.values())
    return total, total - sizes["embed"]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def flops_per_step(dims: dict, n_matmul_params: int, batch: int, seq: int) -> float:
    """Model FLOPs of one fwd+bwd step (FLOPS_RULE): 6*N per token for
    weight products plus causal self-attention 6*L*S*d_model per token (no
    remat recompute)."""
    tokens = batch * seq
    attn = 6 * dims["n_layers"] * seq * dims["d_model"]
    return float(tokens) * (6.0 * n_matmul_params + attn)


def attention_work(batch: int, seq: int, heads: int, head_dim: int, causal: bool,
                   dtype_bytes: int = 2) -> Dict[str, Dict[str, float]]:
    """FLOPs and bytes each flash kernel must do on these shapes: the (q, k)
    pairs the mask keeps, 2*D FLOP per pair per product; each input read once
    and each output written once (tensors of `dtype_bytes` a value, fp32
    lse/delta)."""
    bh = batch * heads
    pairs = bh * (seq * (seq + 1) // 2 if causal else seq * seq)
    tensor = bh * seq * head_dim * dtype_bytes
    rows = bh * seq * 4
    return {
        "flash_fwd": {"flops": 2 * 2 * head_dim * pairs, "bytes": 4 * tensor + rows},
        "flash_bwd_dq": {"flops": 3 * 2 * head_dim * pairs, "bytes": 5 * tensor + 2 * rows},
        "flash_bwd_dkv": {"flops": 4 * 2 * head_dim * pairs, "bytes": 6 * tensor + 2 * rows},
    }


def kernel_family(name: str) -> str:
    if re.search(r"(fwd|bwd_dq|bwd_dkv)(_f32)?_kernel", name):
        return "flash (this port)"
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions"
    return "elementwise and other"
