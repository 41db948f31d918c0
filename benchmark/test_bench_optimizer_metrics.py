"""The optimizer's fused-share reader (metrics/optimizer_fused_share.py) on
the CPU: the mean of the program's `train.optimizer.fused_share` events in a
hand-made trace, and None on an untraced run or a trace without them (the
program before the fused kernels)."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark.device_trace import HostOp, Trace, _nest
from benchmark.metrics import reader
from benchmark.tiny import REPO

MS = 1_000_000
MAIN = 7


def _trace(shares) -> Trace:
    ops = [("bench.window", 0, 100), ("train.step", 1, 40), ("train.optimizer", 30, 39),
           ("train.step", 41, 80), ("train.optimizer", 70, 79)]
    ops += [(f"train.optimizer.fused_share={v!r}", 38 + 40 * i, 38 + 40 * i)
            for i, v in enumerate(shares)]
    host = {i: HostOp(name, s * MS, e * MS, MAIN) for i, (name, s, e) in enumerate(ops, 1)}
    return Trace(window=(0, 100 * MS), device=[], host=host, main_thread=MAIN,
                 _by_thread=_nest(host))


def _read(trace):
    return reader(REPO, "optimizer_fused_share")(SimpleNamespace(trace=trace, steps=2))


def test_the_share_is_the_mean_of_the_step_events():
    assert _read(_trace([1.0, 1.0])) == pytest.approx(1.0)
    assert _read(_trace([1.0, 0.5])) == pytest.approx(0.75)


@pytest.mark.parametrize("trace", [None, "no events"])
def test_nothing_to_read_without_the_counter(trace):
    assert _read(_trace([]) if trace else None) is None


def test_the_share_lists_the_training_cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "optimizer_fused_share")
    assert set(entry["workloads"]) <= {w["name"] for w in bench["workloads"]}
    assert {"mistral7b_v03_stage8.seq4k", "olmoe_1b7b_stage8.seq4k"} <= set(entry["workloads"])
    assert (entry["layer"], entry["moves"], entry["unit"]) == ("optimizer", "tokens_per_s",
                                                               "ratio")
