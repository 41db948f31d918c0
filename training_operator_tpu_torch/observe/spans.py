"""Named ranges inside the train step, for torch.profiler.

The trainer marks where each layer's work happens with profiler ranges:
the step and its forward, backward and optimizer (`train.*`), the head and
each checkpointed layer body (`model.*`) and the production of each batch
(`data.next`). A profiler records them in the same trace as the device's
kernels, on one clock, and links every kernel to the host op that launched
it, so a reader of the trace can put each kernel, and each idle gap, down
to the range the host was in.

On a card, the trace's overhead events for a full command buffer carry the
correlation id of an op open on the caller's thread, mostly the innermost
one or a user annotation, and a reader that keys host events by that id
loses the op to them. So the ranges are ops of function scope, not
user annotations (`_Range`), and `train.backward`, inside which the caller
only waits while autograd's device thread launches the backward, holds a
range `train.backward.wait` that takes those events in its place.

A range that must cover a region's backward (`backward_span`) opens in one
autograd node and closes in a later one, both on the thread that runs the
backward's nodes, which on a card is autograd's device thread and not the
caller's.

The profiler being on is the only switch: with none active (one check,
`torch.autograd._profiler_enabled()`), `span` opens no range and
`backward_span` adds no autograd node, and neither allocates.

The dropless MoE layer (trainer/moe.py) has ranges of its own (`MOE_NAMES`):
`model.moe` over the layer's forward and its recompute, `model.moe.grad`
over its backward, and inside them `model.moe.route` (router product,
softmax, top-k, sort and group offsets, the aux sums), `model.moe.experts`
(the grouped products) and `model.moe.experts.grad` (their backward).
`model.moe.permute` (`MOE_PERMUTE`, beside `MOE_NAMES`) covers each of the
token permutation's four calls: the dispatch and the combine inside
`model.moe`, their backwards inside each one's own autograd node, inside
`model.moe.grad`.

Counters: a device value that a layer computes only while the train step
collects them (`counting`: during the forward, and only with a profiler
active), gathered with one host sync at the end of the step
(`emit_counts`) and written into the trace as host events named
`<counter>=<value>` (`counter_event`). `EXPERT_LOAD` is the busiest
expert's (token, choice) pairs over the mean, E / (T k) times the largest
count, once a layer and step. A value the host already holds is written
at once by `host_count`, with no sync: `OPTIMIZER_FUSED_SHARE`, the share
of parameter elements the optimizer's fused kernels updated (trainer/
adamw.py), once a step.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, List, Optional, Tuple

import torch

STEP = "train.step"
FORWARD = "train.forward"
BACKWARD = "train.backward"
BACKWARD_WAIT = "train.backward.wait"
OPTIMIZER = "train.optimizer"
HEAD = "model.head"
HEAD_GRAD = "model.head.grad"
LAYER = "model.layer"
DATA = "data.next"
NAMES = (STEP, FORWARD, BACKWARD, BACKWARD_WAIT, OPTIMIZER, HEAD, HEAD_GRAD, LAYER, DATA)
MOE = "model.moe"
MOE_GRAD = "model.moe.grad"
MOE_ROUTE = "model.moe.route"
MOE_EXPERTS = "model.moe.experts"
MOE_EXPERTS_GRAD = "model.moe.experts.grad"
MOE_NAMES = (MOE, MOE_GRAD, MOE_ROUTE, MOE_EXPERTS, MOE_EXPERTS_GRAD)
MOE_PERMUTE = "model.moe.permute"
EXPERT_LOAD = "model.moe.expert_load_max"
OPTIMIZER_FUSED_SHARE = "train.optimizer.fused_share"

# The step's counters while it collects them: (name, 0-d device tensor).
_COUNTS: ContextVar[Optional[List[Tuple[str, torch.Tensor]]]] = ContextVar(
    "training_operator_tpu_torch_counts", default=None)

_OFF = contextlib.nullcontext()


class _Range:
    """One profiler range, an op of function scope (see the module
    docstring): a context manager, or a handle that `_Open` enters and
    `_Close` exits."""

    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name
        self.record = None

    def __enter__(self):
        self.record = torch._C._profiler._RecordFunctionFast(self.name)
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        record, self.record = self.record, None
        record.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager: a profiler range `name` over its body while a
    profiler is active; otherwise a shared null context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Range(name)


class _Open(torch.autograd.Function):
    """Identity on the region's outputs; its backward, the region's first
    node to run, enters the range."""

    @staticmethod
    def forward(ctx, handle, *outs):
        ctx.handle = handle
        ctx.set_materialize_grads(False)
        views = tuple(t.view_as(t) for t in outs)
        return views if len(views) > 1 else views[0]

    @staticmethod
    def backward(ctx, *grads):
        ctx.handle.__enter__()
        return (None, *grads)


class _Close(torch.autograd.Function):
    """Identity on the region's inputs; its backward runs once every input's
    gradient is formed, the region's last node, and exits the range."""

    @staticmethod
    def forward(ctx, handle, *inputs):
        ctx.handle = handle
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in inputs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.handle.__exit__()
        return (None, *grads)


def backward_span(name: str, fn: Callable[..., torch.Tensor], *inputs: torch.Tensor):
    """`fn(*inputs)` (a tensor or a tuple of tensors), its backward covered
    by a profiler range `name` while a profiler is active and autograd
    records: from the first of the region's backward nodes (the outputs') to
    the last (the inputs'). Identities in value; with no profiler,
    `fn(*inputs)` and nothing more."""
    if not (torch.autograd._profiler_enabled() and torch.is_grad_enabled()):
        return fn(*inputs)
    handle = _Range(name)
    inner = _Close.apply(handle, *inputs)
    out = fn(*inner)
    return _Open.apply(handle, *out) if isinstance(out, tuple) else _Open.apply(handle, out)


@contextlib.contextmanager
def _collect():
    counts: List[Tuple[str, torch.Tensor]] = []
    token = _COUNTS.set(counts)
    try:
        yield counts
    finally:
        _COUNTS.reset(token)


def collect_counts():
    """A context manager: while a profiler is active, collects the
    counters its body computes and yields their list; otherwise the shared
    null context, yielding None."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _collect()


def counting() -> bool:
    """Whether a counter computed now would be kept (`collect_counts`)."""
    return _COUNTS.get() is not None


def count(name: str, value: torch.Tensor) -> None:
    """Keeps a 0-d device value of counter `name` while collecting."""
    counts = _COUNTS.get()
    if counts is not None:
        counts.append((name, value.detach().float()))


def counter_event(name: str, value: float) -> str:
    return f"{name}={value!r}"


def host_count(name: str, value: float) -> None:
    """Writes a host value of counter `name` into the trace as an empty
    range `<name>=<value>` while a profiler is active. It takes a Python
    number, never a device tensor, so it reads nothing from the card."""
    if not isinstance(value, (int, float)):
        raise TypeError(f"counter {name} takes a host number; got {type(value).__name__}")
    if torch.autograd._profiler_enabled():
        with _Range(counter_event(name, float(value))):
            pass


def emit_counts(counts: Optional[List[Tuple[str, torch.Tensor]]]) -> None:
    """Writes the collected counters into the trace, each as an empty range
    `<name>=<value>`, after one host sync for all of them."""
    if not counts:
        return
    values = torch.stack([v for _, v in counts]).tolist()
    for (name, _), value in zip(counts, values):
        host_count(name, value)
