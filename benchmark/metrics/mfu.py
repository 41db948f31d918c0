"""Model FLOPs of the traced window's steps (the cell's model family's
`flops_per_step`) over the traced window's seconds and the card's dense
bf16 peak, in percent. The same peak whatever the dtype, so no
implementation can read over 100."""

from benchmark import yardstick


def read(run):
    if run.trace is None or run.steps == 0:
        return None
    peak = yardstick.peak(yardstick.PEAK_BF16_FLOPS, run.device_name)
    if peak is None:
        return None
    flops = run.family.flops_per_step(run.dims, run.batch, run.seq)
    return 100.0 * flops * run.steps / run.trace.window_s / peak
