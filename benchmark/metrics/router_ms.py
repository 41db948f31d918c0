"""Device ms per traced step of the expert layer's routing, forward and
recompute: the kernels under the program's `model.moe.route` range (router
product, softmax, top-k, the sort and group offsets, the aux sums)."""

from benchmark import moe_spans


def read(run):
    return moe_spans.device_ms(run, frozenset((moe_spans.ROUTE,)))
