"""Device ms per traced step of the optimizer: the kernels launched inside a
`train.step` range after that step's `train.backward` (program_spans.py),
the `train.optimizer` range's global norm, clip and AdamW update."""

from benchmark import program_spans as ps


def read(run):
    return ps.device_ms(run, lambda spans, d: spans.phase(d) == "optimizer")
