"""The benchmark's fixed arithmetic that every model family shares: the
card's peaks and the kernel-family rule. A family's own arithmetic (its
parameter count, FLOP rule and attention work) is in its file under
`benchmark/families/`.

Copied from the port's `training_operator_tpu_torch/trainer/bench.py` so that
a change to the port cannot move the yardstick it is measured by:

- `PEAK_BF16_FLOPS`, `PEAK_BYTES_PER_S` (bench.py:25-28): NVIDIA's H100 and
  H200 SXM data sheets, dense bf16 tensor-core FLOP/s and HBM bytes/s;
- `kernel_family` (bench.py:327-335, `_kernel_family`).

Nothing here imports the port.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

PEAK_BF16_FLOPS = {"H100": 989e12, "H200": 989e12}
PEAK_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peak(table: Dict[str, float], device_name: str) -> Optional[float]:
    """The entry of `table` whose key is in the card's name, or None."""
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def kernel_family(name: str) -> str:
    if re.search(r"(fwd|bwd_dq|bwd_dkv)(_f32)?_kernel", name):
        return "flash (this port)"
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions"
    return "elementwise and other"
