"""The readers of the program's ranges (program_spans.py) on a hand-made
trace of one step as a card records it: the caller's thread opens the step,
its forward, backward and optimizer; autograd's device thread runs the
backward's nodes, the recompute of a checkpointed layer and of the head, and
the head's gradient under `model.head.grad`, a range that opened in one node
and closed in another and so has no parent."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

from benchmark import program_spans
from benchmark.device_trace import DeviceOp, HostOp, Trace, _nest
from benchmark.metrics import reader
from benchmark.tiny import REPO

MS = 1_000_000  # ns
MAIN, AUTOGRAD = 7, 9
READERS = ("forward_ms", "backward_ms", "optimizer_ms", "head_ms", "recompute_ms",
           "data_host_ms")
DEVICE = ("forward_ms", "backward_ms", "optimizer_ms", "head_ms", "recompute_ms")


def _host():
    ops = [
        ("bench.window", 0, 100, MAIN),
        ("bench.data", 1, 4, MAIN),
        ("data.next", 1, 3, MAIN),
        ("data.next", 1.5, 2.5, MAIN),  # nested: counts once, as the outer one
        ("aten::copy_", 2, 2.2, MAIN),
        ("bench.step", 4, 90, MAIN),
        ("train.step", 4, 90, MAIN),
        ("train.forward", 5, 30, MAIN),
        ("model.layer", 6, 10, MAIN),
        ("model.layer", 7, 9, MAIN),  # _add_mlp inside _out_and_mlp
        ("aten::mm", 7.5, 8, MAIN),
        ("model.head", 20, 25, MAIN),
        ("aten::mm", 21, 22, MAIN),
        ("train.backward", 31, 70, MAIN),
        ("model.head.grad", 32, 40, AUTOGRAD),
        ("autograd::engine::evaluate_function: LogsumexpBackward0", 33, 36, AUTOGRAD),
        ("model.head", 33.5, 35, AUTOGRAD),
        ("aten::mm", 34, 34.5, AUTOGRAD),
        ("autograd::engine::evaluate_function: MmBackward0", 36.5, 38.5, AUTOGRAD),
        ("aten::mm", 37, 38, AUTOGRAD),
        ("autograd::engine::evaluate_function: CheckpointFunctionBackward", 44, 52, AUTOGRAD),
        ("model.layer", 45, 50, AUTOGRAD),
        ("aten::mm", 46, 47, AUTOGRAD),
        ("autograd::engine::evaluate_function: MmBackward0", 54, 57, AUTOGRAD),
        ("aten::mm", 55, 56, AUTOGRAD),
        ("train.optimizer", 71, 88, MAIN),
        ("aten::mul_", 72, 73, MAIN),
        ("bench.log", 91, 99, MAIN),
        ("aten::_local_scalar_dense", 92, 98, MAIN),
    ]
    return {i: HostOp(name, round(s * MS), round(e * MS), tid)
            for i, (name, s, e, tid) in enumerate(ops, start=1)}


def _id(host, name, start_ms):
    return next(i for i, op in host.items() if op.name == name and op.start == start_ms * MS)


# Each kernel: (launching op, its start in ms), its device ms, and the
# metrics it counts in.
KERNELS = {
    "data copy": (("aten::copy_", 2), 0.25, set()),
    "layer forward": (("aten::mm", 7.5), 2, {"forward_ms"}),
    "head forward": (("aten::mm", 21), 3, {"forward_ms", "head_ms"}),
    "head recompute": (("aten::mm", 34), 5, {"backward_ms", "head_ms", "recompute_ms"}),
    "head gradient": (("aten::mm", 37), 7, {"backward_ms", "head_ms"}),
    "layer recompute": (("aten::mm", 46), 11, {"backward_ms", "recompute_ms"}),
    "layer gradient": (("aten::mm", 55), 13, {"backward_ms"}),
    "optimizer": (("aten::mul_", 72), 17, {"optimizer_ms"}),
    "loss read": (("aten::_local_scalar_dense", 92), 0.5, set()),
}


def _trace(kernels=tuple(KERNELS)) -> Trace:
    host = _host()
    by_thread = _nest(host)
    device, t = [], 1 * MS
    for name in kernels:
        (op, start), ms, _ = KERNELS[name]
        device.append(DeviceOp(name, t, t + round(ms * MS), _id(host, op, start)))
        t += round(ms * MS)
    return Trace(window=(0, 100 * MS), device=device, host=host, main_thread=MAIN,
                 _by_thread=by_thread)


def _run(trace, steps=1):
    return SimpleNamespace(trace=trace, steps=steps)


def _read(name, run):
    return reader(REPO, name)(run)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_each_kernel_counts_in_the_metrics_its_ranges_name(kernel):
    ms, want = KERNELS[kernel][1:]
    run = _run(_trace([kernel]))
    got = {name: _read(name, run) for name in DEVICE}
    assert {name for name, v in got.items() if v is not None} == want
    for name in want:
        assert got[name] == pytest.approx(ms)


def test_nested_ranges_count_a_kernel_once():
    run = _run(_trace(), steps=2)
    assert _read("forward_ms", run) == pytest.approx((2 + 3) / 2)
    assert _read("backward_ms", run) == pytest.approx((5 + 7 + 11 + 13) / 2)
    assert _read("optimizer_ms", run) == pytest.approx(17 / 2)
    assert _read("head_ms", run) == pytest.approx((3 + 5 + 7) / 2)
    assert _read("recompute_ms", run) == pytest.approx((5 + 11) / 2)


def test_phases_survive_ranges_lost_to_overhead_events():
    """The trace's overhead events for a full command buffer carry the id of
    an op open on the caller's thread, and `from_profiler` keeps the last
    event of an id: a `train.forward` or `train.optimizer` range can be
    replaced so. The phases follow from `train.step` and `train.backward`."""
    t = _trace()
    want = {name: _read(name, _run(t)) for name in DEVICE}
    host = dict(t.host)
    for name, start in (("train.forward", 5), ("train.optimizer", 71)):
        cid = _id(host, name, start)
        host[cid] = HostOp("Command Buffer Full", host[cid].start + MS // 2,
                           host[cid].start + MS, MAIN)
    host = {i: dataclasses.replace(op, parent=None) for i, op in host.items()}
    _nest(host)
    got = {name: _read(name, _run(dataclasses.replace(t, host=host))) for name in DEVICE}
    assert got == pytest.approx(want)


def test_the_head_gradient_range_has_no_parent():
    t = _trace()
    grad = _id(t.host, "model.head.grad", 32)
    assert t.host[grad].parent is None
    mm = _id(t.host, "aten::mm", 34)
    assert t.chain(mm)[-1] == "model.head.grad"
    assert program_spans.Spans(t).phase(t.device[3]) == "backward"


def test_data_host_ms_takes_the_outermost_span():
    t = _trace()
    assert _read("data_host_ms", _run(t)) == pytest.approx(2.0)
    assert _read("data_host_ms", _run(t, steps=4)) == pytest.approx(0.5)
    # A span on another thread is not the window's.
    host = dict(t.host)
    host[99] = HostOp("data.next", 10 * MS, 20 * MS, AUTOGRAD)
    assert _read("data_host_ms", _run(dataclasses.replace(t, host=host))) == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_device_ops_or_ranges(name):
    assert _read(name, _run(None)) is None
    assert _read(name, _run(dataclasses.replace(_trace(), device=[]))) is None
    assert _read(name, _run(_trace(), steps=0)) is None
    # A program without the ranges: the same kernels, none of its names.
    t = _trace()
    bare = {i: dataclasses.replace(op, parent=None) for i, op in t.host.items()
            if op.name not in program_spans.NAMES}
    _nest(bare)
    assert _read(name, _run(dataclasses.replace(t, host=bare))) is None


def test_the_names_are_the_ports():
    from training_operator_tpu_torch.observe import spans

    assert program_spans.NAMES == frozenset(spans.NAMES)
