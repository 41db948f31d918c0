"""The OLMoE family (families/olmoe.py) and the expert layer's readers
(moe_spans.py, metrics/moe_ms.py, router_ms.py, expert_roofline.py,
expert_load_max.py) on the CPU: the published configuration counted and
refused where the port cannot run it, the arithmetic by hand, the readers
on a hand-made trace of one step as a card records it, None without the
ranges, and a tiny OLMoE cell through the harness, correct and not under
its planted faults."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import families, run, spec
from benchmark.device_trace import DeviceOp, HostOp, Trace, _nest
from benchmark.metrics import reader
from benchmark.tiny import LIMITS, REPO, make_root

OLMOE = families.load(REPO, "olmoe")
CONFIG = json.loads((REPO / "benchmark/configs/olmoe_1b7b_stage8.json").read_text())
MS = 1_000_000
MAIN, AUTOGRAD = 7, 9
READERS = ("moe_ms", "router_ms", "expert_roofline", "expert_load_max")


def _with(**keys):
    c = json.loads(json.dumps(CONFIG))
    c["config"].update(keys)
    return c


def test_the_published_configuration():
    dims = OLMOE.dims(CONFIG)
    assert dims == dict(vocab_size=50304, d_model=2048, n_layers=8, n_heads=16, n_kv_heads=16,
                        d_ff=1024, max_seq_len=4096, rope_theta=10000, n_experts=64,
                        n_experts_per_tok=8, router_aux_coef=0.01, rms_norm_eps=1e-5)
    assert OLMOE.count_params(dims) == (3_562_604_544, 641_009_664)
    assert CONFIG["params"] == {"total": 3_562_604_544, "products": 641_009_664}
    # Per layer: attention 16,777,216, router 131,072, experts 402,653,184,
    # four norms 8,192.
    shapes = OLMOE.param_shapes(dims)
    per_layer = sum(__import__("math").prod(s[1:]) for n, s in shapes.items()
                    if n.startswith("layers."))
    assert per_layer == 16_777_216 + 131_072 + 402_653_184 + 8_192
    entry = next(c for c in json.loads((REPO / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == CONFIG["name"])
    assert entry["reduced"] == CONFIG["reduced"] == sorted(CONFIG["published"])


@pytest.mark.parametrize("keys,match", [
    (dict(norm_topk_prob=True), "norm_topk_prob"),
    (dict(clip_qkv=8.0), "clip_qkv"),
    (dict(rope_scaling={"type": "linear", "factor": 2.0}), "rope_scaling"),
    (dict(n_shared_experts=2), "n_shared_experts"),
    (dict(rms_norm_eps=1e-6), "rms_norm_eps"),
])
def test_what_the_port_cannot_run_is_refused(keys, match):
    with pytest.raises(ValueError, match=match):
        OLMOE.dims(_with(**keys))


def test_the_dense_decoder_refuses_olmoe():
    with pytest.raises(ValueError, match="num_experts"):
        families.load(REPO, "decoder").dims(CONFIG)


def test_flops_and_expert_work_by_hand():
    dims = OLMOE.dims(CONFIG)
    assert OLMOE.flops_per_step(dims, 4, 4096) == 16384 * (6 * 641_009_664
                                                          + 6 * 8 * 4096 * 2048)
    w = OLMOE.expert_work(dims, 4, 4096, 2)
    rows = 16384 * 8
    assert w["flops"] == 2 * rows * 3 * 2048 * 1024
    assert w["bytes"] == 2 * (3 * 64 * 2048 * 1024 + 2 * rows * 2048)
    one = max(w["flops"] / 989e12, w["bytes"] / 3.35e12)
    assert one == w["flops"] / 989e12  # compute-bound at this size
    calls = {"forward": 16, "backward": 8}
    assert OLMOE.expert_bound_s(dims, 4, 4096, 2, calls, 989e12, 3.35e12) == \
        pytest.approx(one * 32)


def _host():
    ops = [
        ("bench.window", 0, 100, MAIN),
        ("train.step", 4, 90, MAIN),
        ("train.forward", 5, 30, MAIN),
        ("model.layer", 6, 20, MAIN),
        ("model.moe", 7, 19, MAIN),
        ("model.moe.route", 8, 10, MAIN),
        ("aten::mm", 8.5, 9, MAIN),
        ("aten::topk", 9.2, 9.5, MAIN),
        ("model.moe.experts", 11, 16, MAIN),
        ("aten::_grouped_mm", 12, 13, MAIN),
        ("aten::_grouped_mm", 14, 15, MAIN),
        ("aten::index_select", 17, 18, MAIN),
        ("train.backward", 31, 70, MAIN),
        ("autograd::engine::evaluate_function: _OpenBackward", 32, 33, AUTOGRAD),
        ("model.moe.grad", 32.5, 60, AUTOGRAD),
        ("autograd::engine::evaluate_function: MulBackward0", 34, 45, AUTOGRAD),
        ("model.moe", 35, 44, AUTOGRAD),  # the recompute
        ("model.moe.route", 36, 37, AUTOGRAD),
        ("aten::mm", 36.2, 36.5, AUTOGRAD),
        ("model.moe.experts", 38, 42, AUTOGRAD),
        ("aten::_grouped_mm", 39, 40, AUTOGRAD),
        ("autograd::engine::evaluate_function: _OpenBackward", 46, 47, AUTOGRAD),
        ("model.moe.experts.grad", 46.5, 55, AUTOGRAD),
        ("autograd::engine::evaluate_function: GroupedMmBackward0", 48, 52, AUTOGRAD),
        ("aten::_grouped_mm", 49, 50, AUTOGRAD),
        ("aten::_grouped_mm", 50.5, 51.5, AUTOGRAD),
        ("autograd::engine::evaluate_function: _CloseBackward", 54, 56, AUTOGRAD),
        ("autograd::engine::evaluate_function: _DispatchBackward", 56.5, 58, AUTOGRAD),
        ("aten::index_select", 57, 57.5, AUTOGRAD),
        ("autograd::engine::evaluate_function: _CloseBackward", 59, 61, AUTOGRAD),
        ("autograd::engine::evaluate_function: MmBackward0", 62, 64, AUTOGRAD),
        ("aten::mm", 62.5, 63.5, AUTOGRAD),
        ("train.optimizer", 71, 80, MAIN),
        ("aten::mul_", 72, 73, MAIN),
        ("model.moe.expert_load_max=1.5", 85, 85, MAIN),
        ("model.moe.expert_load_max=2.5", 86, 86, MAIN),
    ]
    return {i: HostOp(name, round(s * MS), round(e * MS), tid)
            for i, (name, s, e, tid) in enumerate(ops, start=1)}


# Each kernel: (launching op, its start in ms), its device ms, and whether it
# is the layer's (moe), the router's, and the expert products' call.
KERNELS = [
    (("aten::mm", 8.5), 1.0, "route"),
    (("aten::topk", 9.2), 0.5, "route"),
    (("aten::_grouped_mm", 12), 2.0, "forward"),
    (("aten::_grouped_mm", 14), 2.0, "forward"),
    (("aten::index_select", 17), 0.5, "layer"),
    (("aten::mm", 36.2), 1.0, "route"),
    (("aten::_grouped_mm", 39), 2.0, "recompute"),
    (("aten::_grouped_mm", 49), 4.0, "backward"),
    (("aten::_grouped_mm", 50.5), 4.0, "backward"),
    (("aten::index_select", 57), 0.5, "layer"),
    (("aten::mm", 62.5), 3.0, None),
    (("aten::mul_", 72), 5.0, None),
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


def _run(trace, steps=1):
    dims = dict(OLMOE.dims(CONFIG), n_layers=1)
    return SimpleNamespace(trace=trace, steps=steps, family=OLMOE, dims=dims, batch=4,
                           seq=4096, dtype_bytes=2, device_name="NVIDIA H100 80GB HBM3")


def _read(name, run):
    return reader(REPO, name)(run)


def test_the_layer_and_router_ms():
    moe = sum(ms for _, ms, kind in KERNELS if kind is not None)
    assert _read("moe_ms", _run(_trace())) == pytest.approx(moe)
    assert _read("moe_ms", _run(_trace(), steps=2)) == pytest.approx(moe / 2)
    assert _read("router_ms", _run(_trace())) == pytest.approx(2.5)


def test_the_expert_roofline_counts_calls_by_range():
    from benchmark import moe_spans

    t = _trace()
    calls = moe_spans.expert_calls(t)
    assert calls == {"forward": 2, "backward": 1, "ns": round(14.0 * MS)}
    run_ = _run(t)
    bound = OLMOE.expert_bound_s(run_.dims, 4, 4096, 2, calls, 989e12, 3.35e12)
    assert _read("expert_roofline", run_) == pytest.approx(100 * bound / 14e-3)
    # An unknown card, or a family without the bound: nothing to read.
    assert _read("expert_roofline", SimpleNamespace(**{**vars(run_), "device_name": "cpu"})) \
        is None
    assert _read("expert_roofline", SimpleNamespace(
        **{**vars(run_), "family": families.load(REPO, "decoder")})) is None


def test_the_load_counter_is_averaged():
    assert _read("expert_load_max", _run(_trace())) == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_the_ranges(name):
    from benchmark import moe_spans

    assert _read(name, _run(None)) is None
    t = _trace()
    names = {moe_spans.MOE, moe_spans.MOE_GRAD, moe_spans.ROUTE, moe_spans.EXPERTS,
             moe_spans.EXPERTS_GRAD}
    bare = {i: dataclasses.replace(op, parent=None) for i, op in t.host.items()
            if op.name not in names and not op.name.startswith(moe_spans.EXPERT_LOAD)}
    _nest(bare)
    assert _read(name, _run(dataclasses.replace(t, host=bare))) is None


def test_the_names_are_the_ports():
    from benchmark import moe_spans
    from training_operator_tpu_torch.observe import spans

    assert (moe_spans.MOE, moe_spans.MOE_GRAD, moe_spans.ROUTE, moe_spans.EXPERTS,
            moe_spans.EXPERTS_GRAD) == spans.MOE_NAMES
    assert moe_spans.EXPERT_LOAD == spans.EXPERT_LOAD
    assert spans.counter_event(spans.EXPERT_LOAD, 1.25).startswith(moe_spans.EXPERT_LOAD + "=")


def _olmoe_root(tmp_path) -> Path:
    """The tiny cell's root with a second cell, `olmoe.t`, of a 2-layer
    OLMoE (d 64, 4 heads, 16 experts of 32, top-4) in fp32: in bf16 a
    near-tied token's top-k choice follows the last bits of its hidden
    state."""
    root = make_root(tmp_path)
    bench = root / "benchmark"
    config = json.loads(json.dumps(CONFIG))
    config["config"].update(hidden_size=64, intermediate_size=32, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=4, vocab_size=256,
                            num_experts=16, num_experts_per_tok=4)
    config["name"], config["run"]["dtype"] = "olmoe", "float32"
    (bench / "configs" / "olmoe.json").write_text(json.dumps(config))
    (bench / "limits" / "olmoe.t.json").write_text(json.dumps(LIMITS))
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["configs"].append({"name": "olmoe", "source": "tests",
                                  "file": "benchmark/configs/olmoe.json", "reduced": [],
                                  "why": "tests"})
    bench_json["workloads"].append({"name": "olmoe.t", "config": "olmoe", "traffic": "tiny",
                                    "chips": 1, "why": "tests"})
    for m in bench_json["per_layer"]:
        m["workloads"].append("olmoe.t")
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root


def _unchanged(monkeypatch):
    from training_operator_tpu_torch.trainer import train

    monkeypatch.setattr(train.AdamW, "update",
                        lambda self, grads, state, params, mesh=None, specs=None:
                        train.global_norm(grads))


def _half_batch(monkeypatch):
    from training_operator_tpu_torch.trainer import train

    whole = train.loss_fn
    monkeypatch.setattr(train, "loss_fn", lambda model, batch, config=None: whole(
        model, {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}, config))


@pytest.mark.parametrize("fault", [None, _half_batch, _unchanged])
def test_a_tiny_olmoe_cell_runs_through_the_harness(tmp_path, monkeypatch, fault):
    cell = spec.load_cell(_olmoe_root(tmp_path), "olmoe.t")
    assert cell.family.__name__ == "benchmark_family_olmoe"
    if fault is not None:
        fault(monkeypatch)
    result = run.run_cell(cell, 2**31 + 9, 0.5, fault is None, "cpu")
    assert result["correct"] is (fault is None), result["checks"]
    if fault is None:
        # The CPU trace has no device ops; the counter is a host event.
        assert result["metrics"]["expert_load_max"]["value"] >= 1.0
