"""The expert layer's permutation metric (metrics/permute_ms.py) on the CPU:
on a hand-made trace of one step as a card records it, it reads the device
time of the kernels under `model.moe.permute` (dispatch and combine in the
forward and the recompute, their backwards in the layer's backward), which
`moe_ms` counts too; None without the range, as on a program that lacks it;
and the name is the program's."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

from benchmark.device_trace import DeviceOp, HostOp, Trace, _nest
from benchmark.metrics import reader
from benchmark.tiny import REPO

MS = 1_000_000
MAIN, AUTOGRAD = 7, 9
PERMUTE = "model.moe.permute"


def _host():
    ops = [
        ("bench.window", 0, 100, MAIN),
        ("train.step", 1, 90, MAIN),
        ("train.forward", 2, 30, MAIN),
        ("model.moe", 3, 20, MAIN),
        ("model.moe.route", 4, 6, MAIN),
        ("aten::topk", 4.5, 5, MAIN),
        (PERMUTE, 7, 9, MAIN),
        ("moe_scatter", 7.5, 8, MAIN),
        ("model.moe.experts", 10, 14, MAIN),
        ("aten::_grouped_mm", 11, 12, MAIN),
        (PERMUTE, 15, 17, MAIN),
        ("moe_gather_sum", 15.5, 16, MAIN),
        ("train.backward", 31, 80, MAIN),
        ("autograd::engine::evaluate_function: _OpenBackward", 32, 33, AUTOGRAD),
        ("model.moe.grad", 32.5, 70, AUTOGRAD),
        ("autograd::engine::evaluate_function: _CombineBackward", 34, 50, AUTOGRAD),
        ("model.moe", 35, 45, AUTOGRAD),  # the recompute
        (PERMUTE, 36, 37, AUTOGRAD),
        ("moe_scatter", 36.2, 36.5, AUTOGRAD),
        (PERMUTE, 40, 41, AUTOGRAD),
        ("moe_gather_sum", 40.2, 40.5, AUTOGRAD),
        (PERMUTE, 46, 48, AUTOGRAD),
        ("moe_scatter", 46.5, 47, AUTOGRAD),
        ("autograd::engine::evaluate_function: _DispatchBackward", 55, 60, AUTOGRAD),
        (PERMUTE, 56, 58, AUTOGRAD),
        ("moe_gather_sum", 56.5, 57, AUTOGRAD),
        ("autograd::engine::evaluate_function: _CloseBackward", 65, 71, AUTOGRAD),
        ("train.optimizer", 81, 89, MAIN),
        ("aten::mul_", 82, 83, MAIN),
    ]
    return {i: HostOp(name, round(s * MS), round(e * MS), tid)
            for i, (name, s, e, tid) in enumerate(ops, start=1)}


# Each kernel: (launching op, its start in ms), its device ms, and whether it
# is one of the permutation's.
KERNELS = [
    (("aten::topk", 4.5), 0.5, False),
    (("moe_scatter", 7.5), 0.25, True),
    (("aten::_grouped_mm", 11), 2.0, False),
    (("moe_gather_sum", 15.5), 0.25, True),
    (("moe_scatter", 36.2), 0.25, True),
    (("moe_gather_sum", 40.2), 0.25, True),
    (("moe_scatter", 46.5), 0.5, True),
    (("moe_gather_sum", 56.5), 0.25, True),
    (("aten::mul_", 82), 3.0, False),
]


def _trace(host=None) -> Trace:
    host = host or _host()
    by_thread = _nest(host)
    device, t = [], 1 * MS
    for (name, start), ms, _ in KERNELS:
        op = next(i for i, h in host.items() if h.name == name and h.start == round(start * MS))
        device.append(DeviceOp(name, t, t + round(ms * MS), op))
        t += round(ms * MS)
    return Trace(window=(0, 100 * MS), device=device, host=host, main_thread=MAIN,
                 _by_thread=by_thread)


def _read(name, trace, steps=1):
    return reader(REPO, name)(SimpleNamespace(trace=trace, steps=steps))


@pytest.mark.parametrize("steps", [1, 2])
def test_permute_ms_reads_the_kernels_under_the_range(steps):
    want = sum(ms for _, ms, permute in KERNELS if permute)
    assert _read("permute_ms", _trace(), steps) == pytest.approx(want / steps)
    # The layer's metric holds them too: the range lies inside its ranges.
    layer = sum(ms for (name, _), ms, _ in KERNELS if name != "aten::mul_")
    assert _read("moe_ms", _trace(), steps) == pytest.approx(layer / steps)


def test_permute_ms_is_none_without_the_range():
    assert _read("permute_ms", None) is None
    t = _trace()
    bare = {i: dataclasses.replace(op, parent=None) for i, op in t.host.items()
            if op.name != PERMUTE}
    _nest(bare)
    assert _read("permute_ms", dataclasses.replace(t, host=bare)) is None
    assert _read("moe_ms", dataclasses.replace(t, host=bare)) is not None


def test_the_name_is_the_programs():
    from benchmark.metrics import permute_ms
    from training_operator_tpu_torch.observe import spans

    assert permute_ms.PERMUTE == spans.MOE_PERMUTE == PERMUTE
