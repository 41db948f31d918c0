"""Host ms per traced step in the program's outermost `data.next` ranges on
the window's thread: the gather's wait, slicing, pinning and the launch of
the copies to the card, without the feed's prefetch queue around them."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if t is None or run.steps == 0 or not t.device:
        return None
    lo, hi = t.window
    ns = sum(op.end - op.start for op in t.host.values()
             if op.name == ps.DATA and op.thread == t.main_thread and lo <= op.start < hi
             and ps.DATA not in t.chain(op.parent))
    return ns / 1e6 / run.steps if ns else None
