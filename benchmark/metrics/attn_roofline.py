"""The attention kernels' share of their roofline, in percent: over the
traced window's calls of the flash ops, the least time the card could take
(the cell's model family's `attention_bound_s`: for each call the max of
its FLOPs at the dense bf16 peak and its bytes at the HBM peak), over the
device time of every kernel that the profiler links to one of those ops.
Linked by op, not by kernel name, so it reads the same work whatever
implements it."""

from benchmark import yardstick

OPS = {f"training_operator_tpu_torch::{k}": k
       for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def read(run):
    t = run.trace
    if t is None:
        return None
    flops_peak = yardstick.peak(yardstick.PEAK_BF16_FLOPS, run.device_name)
    bytes_peak = yardstick.peak(yardstick.PEAK_BYTES_PER_S, run.device_name)
    if flops_peak is None or bytes_peak is None:
        return None
    kernel_ns = 0
    calls = {}
    for d in t.device:
        call = t.under(d, OPS)
        if call is not None:
            kernel_ns += d.end - d.start
            calls.setdefault(OPS[t.host[call].name], set()).add(call)
    if kernel_ns == 0:
        return None
    # Correlation ids grow with each launch: sorted, they are in launch order.
    bound_s = run.family.attention_bound_s(run.dims, run.batch, run.seq, run.dtype_bytes,
                                           {op: sorted(ids) for op, ids in calls.items()},
                                           flops_peak, bytes_peak)
    return 100.0 * bound_s / (kernel_ns / 1e9)
