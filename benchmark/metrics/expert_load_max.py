"""The busiest expert's (token, choice) pairs over the mean, T k / E, of each
layer and step, averaged over the traced window: the program's counter
`model.moe.expert_load_max`, one host event a layer and step."""

from statistics import fmean

from benchmark import moe_spans


def read(run):
    if run.trace is None:
        return None
    values = moe_spans.counter_values(run.trace, moe_spans.EXPERT_LOAD)
    return fmean(values) if values else None
