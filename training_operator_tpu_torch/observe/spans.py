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
"""

from __future__ import annotations

import contextlib
from typing import Callable

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
    """Identity on the region's output; its backward, the region's first
    node to run, enters the range."""

    @staticmethod
    def forward(ctx, handle, out):
        ctx.handle = handle
        ctx.set_materialize_grads(False)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        ctx.handle.__enter__()
        return None, grad


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


def backward_span(name: str, fn: Callable[..., torch.Tensor], *inputs: torch.Tensor
                  ) -> torch.Tensor:
    """`fn(*inputs)`, its backward covered by a profiler range `name` while a
    profiler is active and autograd records: from the first of the region's
    backward nodes (the output's) to the last (the inputs'). Identities in
    value; with no profiler, `fn(*inputs)` and nothing more."""
    if not (torch.autograd._profiler_enabled() and torch.is_grad_enabled()):
        return fn(*inputs)
    handle = _Range(name)
    inner = _Close.apply(handle, *inputs)
    return _Open.apply(handle, fn(*inner))
