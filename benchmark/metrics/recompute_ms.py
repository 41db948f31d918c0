"""Device ms per traced step of forward work run again in the backward: the
kernels under a checkpointed layer body (`model.layer`) or the head
(`model.head`) that were launched inside `train.backward`."""

from benchmark import program_spans as ps

REDONE = frozenset((ps.LAYER, ps.HEAD))


def read(run):
    return ps.device_ms(run, lambda spans, d: (spans.phase(d) == "backward"
                                               and not REDONE.isdisjoint(spans.chain(d))))
