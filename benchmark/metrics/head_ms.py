"""Device ms per traced step of the fp32 head and its cross-entropy: the
kernels launched under the program's `model.head` range (the forward, and
the recompute under `remat_head`) or `model.head.grad` (its backward)."""

from benchmark import program_spans as ps

HEAD = frozenset((ps.HEAD, ps.HEAD_GRAD))


def read(run):
    return ps.device_ms(run, lambda spans, d: not HEAD.isdisjoint(spans.chain(d)))
