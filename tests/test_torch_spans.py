"""The train step's profiler ranges (observe/spans.py) on the CPU: absent, and
no autograd node added, with no profiler; identities in value with one; and
each where its layer's work runs, on a 2-layer decoder under `save_attn_qkv`
and `remat_head` with plain attention."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from training_operator_tpu_torch.observe import spans
from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset, prefetch
from training_operator_tpu_torch.trainer.model import TransformerConfig, loss_fn
from training_operator_tpu_torch.trainer.train import (
    init_train_state,
    make_example_batch,
    make_optimizer,
    make_train_step,
)

# The vocab is no other width of the model or the batch, so the head's
# products are the only ones with an operand of its size.
CONFIG = TransformerConfig(vocab_size=96, d_model=32, n_layers=2, n_heads=2, n_kv_heads=1,
                           d_ff=64, max_seq_len=8, remat_policy="save_attn_qkv",
                           remat_head=True, attn_impl="xla")
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
    """(name, start, end, thread) of every event, in start order."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()), key=lambda r: r[1])


def _inside(r, outer):
    return r[3] == outer[3] and outer[1] <= r[1] and r[2] <= outer[2]


def _named(rows, name):
    return [r for r in rows if r[0] == name]


def test_no_profiler_no_range_and_no_marker_node(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler active")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert spans.span(spans.STEP) is spans.span(spans.DATA)
    state, _ = _state()
    loss = loss_fn(state.model, _batch(), CONFIG)
    assert not _graph_nodes(loss) & MARKERS
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        loss = loss_fn(state.model, _batch(), CONFIG)
    assert _graph_nodes(loss) >= MARKERS


def test_a_traced_step_is_bit_identical_to_an_untraced_one():
    (plain, step), batch = _state(), _batch()
    traced, _ = _state()
    plain, want = step(plain, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, got = step(traced, batch)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for (name, p), q in zip(traced.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(traced.opt_state.mu[name], plain.opt_state.mu[name]), name


@pytest.fixture(scope="module")
def traced_step():
    state, step = _state()
    batch = _batch()
    state, _ = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with record_function("bench.window"):
            step(state, batch)
    return prof


def test_one_step_records_each_range(traced_step):
    rows = _ranges(traced_step)
    for name in (spans.STEP, spans.FORWARD, spans.BACKWARD, spans.BACKWARD_WAIT,
                 spans.OPTIMIZER, spans.HEAD_GRAD):
        assert len(_named(rows, name)) == 1, name
    (step,), (forward,), (backward,), (wait,) = (_named(rows, n) for n in (
        spans.STEP, spans.FORWARD, spans.BACKWARD, spans.BACKWARD_WAIT))
    for r in _named(rows, spans.FORWARD) + _named(rows, spans.BACKWARD) + _named(
            rows, spans.OPTIMIZER):
        assert _inside(r, step), r
    assert _inside(wait, backward)
    head = _named(rows, spans.HEAD)
    assert len(head) == 2
    assert _inside(head[0], forward) and _inside(head[1], backward)
    # The recompute runs inside the head's backward.
    assert _inside(head[1], _named(rows, spans.HEAD_GRAD)[0])


def test_each_layer_body_opens_once_in_the_forward_and_again_in_the_recompute(traced_step):
    rows = _ranges(traced_step)
    layers = _named(rows, spans.LAYER)
    outermost = [r for r in layers if not any(o is not r and _inside(r, o) for o in layers)]
    (forward,), (backward,) = _named(rows, spans.FORWARD), _named(rows, spans.BACKWARD)
    assert sum(_inside(r, forward) for r in outermost) == CONFIG.n_layers
    assert sum(_inside(r, backward) for r in outermost) == CONFIG.n_layers
    assert len(outermost) == 2 * CONFIG.n_layers


def test_the_heads_backward_products_lie_under_its_gradient_range(traced_step):
    events = [e for e in traced_step.profiler.kineto_results.events()]
    (grad,) = _named(_ranges(traced_step), spans.HEAD_GRAD)
    (backward,) = _named(_ranges(traced_step), spans.BACKWARD)
    head_mm, under = [], []
    for e in events:
        if e.name() != "aten::mm":
            continue
        r = (e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
        if _inside(r, grad):
            under.append(r)
        if _inside(r, backward) and any(CONFIG.vocab_size in s for s in e.shapes()):
            head_mm.append(r)
    # The recompute's logits, dX and dW; and no other product.
    assert len(head_mm) == 3
    assert sorted(head_mm) == sorted(under)


@pytest.mark.parametrize("use_native", [False, None])
def test_each_batch_is_one_data_range(use_native):
    ds = TokenDataset.synthetic(CONFIG.vocab_size, 8, num_rows=20, seed=3)
    loader = DataLoader(ds, batch_size=4, device="cpu", use_native=use_native)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = list(prefetch(loader.epoch(0), size=2))
    assert len(batches) == 5
    assert len(_named(_ranges(prof), spans.DATA)) == 5


def test_profile_phases_follow_the_ranges(traced_step):
    """The benchmark's per-layer readers (benchmark/metrics, on
    device_trace.from_profiler and program_spans.Spans) on the CPU step's
    own host ranges, one device op of 1 ms laid under each of its weight
    products (`aten::mm`): 7 a layer and the head's in the forward; the
    head's logits again, with the output projection and the MLP's three of
    each layer, in the recompute; the head's 4 (forward, recompute, dX,
    dW); none in the optimizer; every one in one of the forward, the
    backward and the optimizer."""
    from types import SimpleNamespace

    from benchmark import device_trace, program_spans
    from benchmark.metrics import reader
    from benchmark.tiny import REPO

    trace = device_trace.from_profiler(traced_step)
    assert not trace.device
    ms = 1_000_000
    trace.device = [device_trace.DeviceOp("mm", op.start, op.start + ms, cid)
                    for cid, op in trace.host.items() if op.name == "aten::mm"]

    def read(name, steps=1):
        return reader(REPO, name)(SimpleNamespace(trace=trace, steps=steps))

    assert read("forward_ms") == 7 * CONFIG.n_layers + 1
    assert read("recompute_ms") == 4 * CONFIG.n_layers + 1
    assert read("head_ms") == 4
    assert read("optimizer_ms") is None
    assert read("forward_ms") + read("backward_ms") == len(trace.device)
    spans = program_spans.Spans(trace)
    assert all(spans.phase(d) in ("forward", "backward") for d in trace.device)
    assert read("head_ms", steps=2) == 2
