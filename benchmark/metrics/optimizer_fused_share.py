"""The share of parameter elements the optimizer's fused kernels updated in
a step, averaged over the traced window: the program's counter
`train.optimizer.fused_share`, one host event a step (1.0 where clip and
AdamW ran as the fused multi-tensor pass over every parameter; a program
without the counter has nothing to read)."""

from statistics import fmean

from benchmark import moe_spans

FUSED_SHARE = "train.optimizer.fused_share"


def read(run):
    if run.trace is None:
        return None
    values = moe_spans.counter_values(run.trace, FUSED_SHARE)
    return fmean(values) if values else None
