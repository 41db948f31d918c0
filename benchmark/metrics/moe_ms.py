"""Device ms per traced step of the dropless expert layer: the kernels under
the program's `model.moe` range (forward and recompute) or its
`model.moe.grad` / `model.moe.experts.grad` ranges (backward)."""

from benchmark import moe_spans


def read(run):
    return moe_spans.device_ms(run, moe_spans.LAYER)
