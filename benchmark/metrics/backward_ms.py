"""Device ms per traced step of the kernels launched inside the program's
`train.backward` range, by the launching op's start time and on any thread
(program_spans.py): the backward, with the recompute of the checkpointed
layers and head."""

from benchmark import program_spans as ps


def read(run):
    return ps.device_ms(run, lambda spans, d: spans.phase(d) == "backward")
