"""Model FLOPs of the traced window's steps (yardstick.FLOPS_RULE) over the
traced window's seconds and the card's dense bf16 peak, in percent. The
same peak whatever the dtype, so no implementation can read over 100."""

from benchmark import yardstick


def read(run):
    if run.trace is None or run.steps == 0:
        return None
    peak = yardstick.peak(yardstick.PEAK_BF16_FLOPS, run.device_name)
    if peak is None:
        return None
    flops = yardstick.flops_per_step(run.dims, yardstick.count_params(run.dims)[1],
                                     run.batch, run.seq)
    return 100.0 * flops * run.steps / run.trace.window_s / peak
