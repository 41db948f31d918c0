"""The traced window's share in which no operation ran on the card, in
percent: 1 - the union of the device operations' intervals over the
window."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
