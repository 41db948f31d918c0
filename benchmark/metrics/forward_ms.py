"""Device ms per traced step of the forward: the kernels launched inside a
`train.step` range before that step's `train.backward` (program_spans.py),
the loss with the head's forward."""

from benchmark import program_spans as ps


def read(run):
    return ps.device_ms(run, lambda spans, d: spans.phase(d) == "forward")
