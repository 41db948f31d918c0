"""The dropless MoE layer's profiler ranges and its counter (observe/spans.py,
trainer/moe.py) on the CPU: absent, with no counter computed and no node
added, with no profiler; a traced step bit-identical to an untraced one;
each `model.moe*` range once a layer where its work runs; and one
`model.moe.expert_load_max` event a layer and step, with its value."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from training_operator_tpu_torch.observe import spans
from training_operator_tpu_torch.trainer import moe
from training_operator_tpu_torch.trainer.model import TransformerConfig, loss_fn
from training_operator_tpu_torch.trainer.train import (
    init_train_state,
    make_example_batch,
    make_optimizer,
    make_train_step,
)

CONFIG = TransformerConfig(vocab_size=96, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
                           d_ff=16, max_seq_len=8, remat_policy="save_attn_qkv",
                           remat_head=True, attn_impl="xla", n_experts=8, n_experts_per_tok=2,
                           moe_router="dropless", qk_norm=True, rms_norm_eps=1e-5)
MARKERS = {"_OpenBackward", "_CloseBackward"}


def _state():
    optimizer = make_optimizer(warmup_steps=1, total_steps=10)
    state = init_train_state(CONFIG, optimizer, torch.Generator().manual_seed(0), device="cpu")
    return state, make_train_step(CONFIG, optimizer, device="cpu")


def _batch():
    return make_example_batch(CONFIG, 2, 8, torch.Generator().manual_seed(1), device="cpu")


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


def _ranges(prof):
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()), key=lambda r: r[1])


def _inside(r, outer):
    return r[3] == outer[3] and outer[1] <= r[1] and r[2] <= outer[2]


def _named(rows, name):
    return [r for r in rows if r[0] == name]


def test_no_profiler_no_range_no_counter_and_no_marker_node(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened or a counter kept with no profiler active")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(moe, "count", refuse)
    with spans.collect_counts() as counts:
        assert counts is None and not spans.counting()
    state, step = _state()
    loss = loss_fn(state.model, _batch(), CONFIG)
    assert not _graph_nodes(loss) & MARKERS
    step(state, _batch())


def test_a_traced_step_is_bit_identical_to_an_untraced_one():
    (plain, step), batch = _state(), _batch()
    traced, _ = _state()
    for _ in range(2):
        plain, want = step(plain, batch)
        with profile(activities=[ProfilerActivity.CPU]):
            traced, got = step(traced, batch)
        assert torch.equal(got["loss"], want["loss"])
        assert torch.equal(got["grad_norm"], want["grad_norm"])
    for (name, p), q in zip(traced.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(traced.opt_state.nu[name], plain.opt_state.nu[name]), name


@pytest.fixture(scope="module")
def traced_step():
    state, step = _state()
    batch = _batch()
    state, _ = step(state, batch)
    loads = []
    route = moe.route_topk

    def recording(x, router, config):
        out = route(x, router, config)
        loads.append(float(out[2].max()) * config.n_experts / out[1].numel())
        return out

    moe.route_topk = recording
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, batch)
    finally:
        moe.route_topk = route
    return prof, loads


def test_each_moe_range_opens_once_a_layer_in_forward_recompute_and_backward(traced_step):
    rows = _ranges(traced_step[0])
    (forward,), (backward,) = _named(rows, spans.FORWARD), _named(rows, spans.BACKWARD)
    L = CONFIG.n_layers
    for name in (spans.MOE, spans.MOE_ROUTE, spans.MOE_EXPERTS):
        found = _named(rows, name)
        assert sum(_inside(r, forward) for r in found) == L, name
        assert sum(_inside(r, backward) for r in found) == L, name  # the recompute
        assert len(found) == 2 * L, name
    for name in (spans.MOE_GRAD, spans.MOE_EXPERTS_GRAD):
        found = _named(rows, name)
        assert len(found) == L and all(_inside(r, backward) for r in found), name
    # Route and products inside the layer's range; the products' backward
    # inside the layer's backward.
    layers = _named(rows, spans.MOE)
    for name in (spans.MOE_ROUTE, spans.MOE_EXPERTS):
        assert all(any(_inside(r, o) for o in layers) for r in _named(rows, name)), name
    grads = _named(rows, spans.MOE_GRAD)
    assert all(any(_inside(r, o) for o in grads) for r in _named(rows, spans.MOE_EXPERTS_GRAD))


def test_the_products_gradients_lie_under_their_range(traced_step):
    """Every grouped product of the backward (a plain `mm` on the CPU) with
    an operand of the expert width runs under `model.moe.experts.grad`:
    two a product (dA, dB), three products a layer; the recompute's three
    lie outside it."""
    rows = _ranges(traced_step[0])
    (backward,) = _named(rows, spans.BACKWARD)
    grads = _named(rows, spans.MOE_EXPERTS_GRAD)
    experts = _named(rows, spans.MOE_EXPERTS)
    inside = outside = 0
    for e in traced_step[0].profiler.kineto_results.events():
        r = (e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
        if e.name() != "aten::mm" or not _inside(r, backward):
            continue
        if any(_inside(r, g) for g in grads):
            inside += 1
        elif any(_inside(r, x) for x in experts):
            outside += 1
    E = CONFIG.n_experts
    assert inside == CONFIG.n_layers * 3 * 2 * E
    assert outside == CONFIG.n_layers * 3 * E


def test_one_load_event_a_layer_and_step_with_its_value(traced_step):
    prof, loads = traced_step
    prefix = spans.EXPERT_LOAD + "="
    events = [r for r in _ranges(prof) if r[0].startswith(prefix)]
    # The forward's routing counts; the recompute's, identical, do not.
    assert len(loads) == 2 * CONFIG.n_layers
    assert sorted(float(r[0][len(prefix):]) for r in events) == sorted(loads[:CONFIG.n_layers])
    (step,), (optimizer,) = _named(_ranges(prof), spans.STEP), _named(_ranges(prof),
                                                                      spans.OPTIMIZER)
    assert all(_inside(r, step) and r[1] >= optimizer[2] for r in events)
    assert spans.counter_event(spans.EXPERT_LOAD, 1.5) == "model.moe.expert_load_max=1.5"


def test_counters_are_kept_only_while_collecting():
    value = torch.tensor(2.0)
    spans.count(spans.EXPERT_LOAD, value)  # not collecting: dropped
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.collect_counts() as counts:
            assert spans.counting()
            spans.count(spans.EXPERT_LOAD, value)
        assert not spans.counting()
        spans.emit_counts(counts)
    assert len(counts) == 1
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("model.moe.expert_load_max=2.0") == 1


def test_the_permutation_range_covers_its_four_calls_inside_the_layers(traced_step):
    """`model.moe.permute` opens once a layer for each of the four calls:
    the dispatch and the combine inside `model.moe` in the forward and again
    in the recompute, their backwards inside `model.moe.grad` alone. Every op
    under it is also under the ranges `moe_ms` reads (moe_spans.LAYER), in
    the benchmark's own nesting of a trace."""
    from benchmark import device_trace, moe_spans

    rows = _ranges(traced_step[0])
    (forward,), (backward,) = _named(rows, spans.FORWARD), _named(rows, spans.BACKWARD)
    found = _named(rows, spans.MOE_PERMUTE)
    L = CONFIG.n_layers
    assert sum(_inside(r, forward) for r in found) == 2 * L
    assert sum(_inside(r, backward) for r in found) == 4 * L  # recompute and backward
    assert len(found) == 6 * L
    layers, grads = _named(rows, spans.MOE), _named(rows, spans.MOE_GRAD)
    in_layer = [any(_inside(r, o) for o in layers) for r in found]
    assert sum(in_layer) == 4 * L
    # The backward's two, and the recompute's, which the backward runs.
    assert sum(any(_inside(r, o) for o in grads) and not inside
               for r, inside in zip(found, in_layer)) == 2 * L
    host = {e.correlation_id(): device_trace.HostOp(e.name(), e.start_ns(), e.end_ns(),
                                                    e.start_thread_id())
            for e in traced_step[0].profiler.kineto_results.events()
            if e.correlation_id() and e.start_thread_id() == e.end_thread_id()}
    device_trace._nest(host)
    trace = device_trace.Trace(window=(0, 0), device=[], host=host, main_thread=0)
    under = [op for op in host if spans.MOE_PERMUTE in trace.chain(op)[1:]]
    assert len(under) > 6 * L
    assert all(moe_spans.LAYER & set(trace.chain(op)) for op in under)
