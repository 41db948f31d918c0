"""Host ms per step blocked in the feed's `next()` (the DataLoader and its
prefetch) during the window, by the host clock around the call."""


def read(run):
    if not run.data_wait_s:
        return None
    return 1e3 * sum(run.data_wait_s) / len(run.data_wait_s)
