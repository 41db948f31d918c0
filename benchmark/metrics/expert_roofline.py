"""The grouped expert products' share of their roofline, in percent: over the
traced window's calls (the program's `model.moe.experts` ranges, forward and
recompute, and `model.moe.experts.grad`, backward), the least time the card
could take (the cell's model family's `expert_bound_s`: for each call the
max of its FLOPs at the dense bf16 peak and its bytes at the HBM peak), over
the device time of every kernel under those ranges. Calls are counted by
range, not by kernel name, so it reads the same work whatever implements
the products; None for a family without `expert_bound_s`."""

from benchmark import moe_spans, yardstick


def read(run):
    t = run.trace
    bound = getattr(run.family, "expert_bound_s", None)
    if t is None or bound is None:
        return None
    flops_peak = yardstick.peak(yardstick.PEAK_BF16_FLOPS, run.device_name)
    bytes_peak = yardstick.peak(yardstick.PEAK_BYTES_PER_S, run.device_name)
    if flops_peak is None or bytes_peak is None:
        return None
    calls = moe_spans.expert_calls(t)
    if calls["ns"] == 0:
        return None
    bound_s = bound(run.dims, run.batch, run.seq, run.dtype_bytes, calls, flops_peak,
                    bytes_peak)
    return 100.0 * bound_s / (calls["ns"] / 1e9)
