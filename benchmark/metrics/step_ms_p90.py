"""The 90th percentile of the window's step times: each step is the
interval between the CUDA events recorded on the stream at consecutive step
boundaries, so a wait for data or the host counts."""

import statistics


def read(run):
    if len(run.step_ms) < 2:
        return None
    return statistics.quantiles(run.step_ms, n=10, method="inclusive")[-1]
