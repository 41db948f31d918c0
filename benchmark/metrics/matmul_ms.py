"""Device ms per traced step of the cuBLAS products (yardstick.kernel_family,
by kernel name): the model's weight products and the head."""

from benchmark import yardstick


def read(run):
    if run.trace is None or run.steps == 0:
        return None
    ns = sum(d.end - d.start for d in run.trace.device
             if yardstick.kernel_family(d.name) == "matmul (cuBLAS)")
    return ns / 1e6 / run.steps if ns else None
