"""Clip + AdamW's dispatch between the fused kernels and the loop
(trainer/adamw.py, trainer/train.py) on the CPU: what the kernels refuse,
the loop's results bit for bit on CPU tensors, the error for tensors off
the CPU that the kernels refuse, the kernels' table, and the counter of
the share the kernels updated. The kernels themselves are held to the
loop on the card (tests/test_torch_cuda.py)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from training_operator_tpu_torch.observe import spans
from training_operator_tpu_torch.trainer import adamw, kernels
from training_operator_tpu_torch.trainer.model import TransformerConfig
from training_operator_tpu_torch.trainer.train import (
    AdamW,
    global_norm,
    init_train_state,
    make_example_batch,
    make_optimizer,
    make_train_step,
)

SHARE_PREFIX = spans.OPTIMIZER_FUSED_SHARE + "="


@pytest.fixture
def no_kernels(monkeypatch):
    """Fails any call that would reach the kernels' library."""

    def refuse():
        raise AssertionError("the kernels were called for tensors they do not take")

    monkeypatch.setattr(kernels, "load", refuse)
    adamw.reset_launches()
    yield
    assert adamw.launches == {"sumsq": 0, "update": 0}


def _loop_update(opt, grads, state, params):
    """The loop as the port ran it for every tensor before the kernels,
    copied: the reference the dispatch must leave untouched on the CPU."""
    g_norm = torch.sqrt(sum(t.float().square().sum() for t in grads.values()))
    clip = g_norm >= opt.clip_norm
    lr = opt.schedule(state.count)
    state.count += 1
    bc1 = 1.0 - torch.tensor(opt.b1, dtype=torch.float32) ** state.count
    bc2 = 1.0 - torch.tensor(opt.b2, dtype=torch.float32) ** state.count
    for name, whole in params.items():
        parts = -(-whole.numel() // adamw.UPDATE_CHUNK)
        for p, g, mu, nu in zip(*(t.chunk(parts) for t in (
                whole, grads[name], state.mu[name], state.nu[name]))):
            g = torch.where(clip, g / g_norm * opt.clip_norm, g)
            mu.mul_(opt.b1).add_(g, alpha=1.0 - opt.b1)
            nu.mul_(opt.b2).addcmul_(g, g, value=1.0 - opt.b2)
            upd = (mu / bc1.item()) / ((nu / bc2.item()).sqrt_() + opt.eps)
            upd.add_(p, alpha=opt.weight_decay)
            p.add_(upd, alpha=-lr)
    return g_norm


def _tensors(kind, seed):
    """Parameters and gradients of the kind the kernels refuse: bf16, or
    fp32 stored transposed (non-contiguous), or plain fp32 on the CPU."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"w": (6, 10), "b": (10,), "e": (3, 4, 5)}

    def make(shape):
        t = torch.randn(shape, generator=g)
        if kind == "non-contiguous" and len(shape) == 2:
            t = t.t().contiguous().t()
        return t.to(torch.bfloat16) if kind == "bfloat16" else t

    return {n: make(s) for n, s in shapes.items()}, {n: make(s) for n, s in shapes.items()}


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below-clip", "above-clip"])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "non-contiguous"])
def test_refused_tensors_take_the_loop_bit_for_bit(no_kernels, kind, scale):
    params, grads = _tensors(kind, 0)
    grads = {n: g * scale for n, g in grads.items()}
    twin = {n: p.clone() for n, p in params.items()}
    opt = AdamW(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    state, ref_state = opt.init(params), opt.init(twin)
    if kind == "non-contiguous":
        assert not params["w"].is_contiguous() and not state.mu["w"].is_contiguous()
    for _ in range(3):
        norm = opt.update(grads, state, params)
        ref_norm = _loop_update(opt, grads, ref_state, twin)
        assert torch.equal(norm, ref_norm)
        for n in params:
            for got, want in ((params[n], twin[n]), (state.mu[n], ref_state.mu[n]),
                              (state.nu[n], ref_state.nu[n])):
                assert torch.equal(got, want), n
    assert state.count == ref_state.count == 3


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "non-contiguous"])
def test_the_cpu_global_norm_is_the_loops(no_kernels, kind):
    _, grads = _tensors(kind, 1)
    want = torch.sqrt(sum(t.float().square().sum() for t in grads.values()))
    assert torch.equal(global_norm(grads), want)


@pytest.mark.parametrize("case,reason", [
    ("cpu", "not on one CUDA device"),
    ("bfloat16", "not float32"),
    ("transposed", "not contiguous"),
    ("shape", "shapes differ"),
    ("gradient alone", "not on one CUDA device"),
])
def test_refusal_names_what_the_kernels_do_not_take(case, reason):
    p = torch.zeros(4, 6)
    four = {"cpu": (p, p, p, p), "bfloat16": (p, p.bfloat16(), p, p),
            "transposed": (p.t(), p.t().contiguous(), p.t(), p.t()),
            "shape": (p, p.reshape(6, 4), p, p), "gradient alone": (p,)}[case]
    assert adamw.refusal(*four) == reason


@pytest.mark.parametrize("case,reason", [
    ("bfloat16", "not float32"),
    ("transposed", "not contiguous"),
    ("shape", "shapes differ"),
    ("meta", "not on one CUDA device"),
    ("cpu and meta", "not on one CUDA device"),
])
def test_tensors_off_the_cpu_that_the_kernels_refuse_raise(no_kernels, case, reason):
    """Only CPU tensors take the loop: a tensor elsewhere (here `meta`, which
    a CPU test can make) that the kernels refuse raises, naming the
    parameter and why, in `fused`, `global_norm` and `AdamW.update`."""
    p = torch.zeros(4, 6, device="meta")
    four = {"bfloat16": (p, p.bfloat16(), p, p),
            "transposed": (p.t(), p.t().contiguous(), p.t(), p.t()),
            "shape": (p, p.reshape(6, 4), p, p), "meta": (p, p, p, p),
            "cpu and meta": (torch.zeros(4, 6), p, p, p)}[case]
    with pytest.raises(ValueError, match=f"^w: .*refused: {reason}$"):
        adamw.fused("w", *four)
    params, grads = {"w": four[0]}, {"w": four[1]}
    opt = AdamW()
    state = opt.init(params)
    state.mu["w"], state.nu["w"] = four[2], four[3]
    with pytest.raises(ValueError, match="^w: "):
        global_norm(grads)
    with pytest.raises(ValueError, match="^w: "):
        opt.update(grads, state, params)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "non-contiguous"])
def test_cpu_tensors_take_the_loop(kind):
    params, grads = _tensors(kind, 2)
    assert not any(adamw.fused(n, params[n], grads[n], params[n], params[n]) for n in params)
    assert not any(adamw.fused(n, g) for n, g in grads.items())


def test_the_table_has_a_row_a_tensor_and_chunks_over_all():
    n = adamw.CHUNK
    ps = [torch.zeros(s) for s in (3, 0, 2 * n + 1, n)]
    gs, mus, nus = ([torch.zeros_like(p) for p in ps] for _ in range(3))
    rows, chunks = adamw.table_rows(list(zip(ps, gs, mus, nus)))
    assert len(adamw.COLUMNS) == 6 and all(len(r) == 6 for r in rows)
    assert [r[4:] for r in rows] == [[3, 0], [0, 1], [2 * n + 1, 1], [n, 4]]
    assert chunks == 5
    assert rows[2][:4] == [ps[2].data_ptr(), gs[2].data_ptr(), mus[2].data_ptr(),
                           nus[2].data_ptr()]
    # The norm's table holds the gradients alone.
    rows, chunks = adamw.table_rows([(None, g, None, None) for g in gs])
    assert [r[:4] for r in rows] == [[0, g.data_ptr(), 0, 0] for g in gs] and chunks == 5


@pytest.mark.parametrize("bad", ["p", "g", "mu", "nu"])
def test_the_table_refuses_mismatched_shapes(bad):
    four = {k: torch.zeros(4, 6) for k in ("p", "g", "mu", "nu")}
    four[bad] = torch.zeros(24)
    with pytest.raises(ValueError, match="differ in shape"):
        adamw.table_rows([tuple(four.values())])


def test_the_update_refuses_a_norm_it_cannot_read():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="one float32"):
        adamw.update([p], [p], [p], [p], torch.zeros(2), clip_norm=1.0, lr=0.0, b1=0.9,
                     b2=0.999, bc1=0.1, bc2=0.001, eps=1e-8, weight_decay=0.0)


def test_host_count_writes_one_event_and_reads_no_tensor(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.host_count(spans.OPTIMIZER_FUSED_SHARE, 0.75)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("train.optimizer.fused_share=0.75") == 1
    assert len([n for n in names if n.startswith(SHARE_PREFIX)]) == 1
    # A device value would need a sync to format: refused.
    with pytest.raises(TypeError, match="host number"):
        spans.host_count(spans.OPTIMIZER_FUSED_SHARE, torch.tensor(1.0))

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler active")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    spans.host_count(spans.OPTIMIZER_FUSED_SHARE, 1.0)


def test_a_traced_step_writes_its_fused_share_once(no_kernels):
    config = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
                               d_ff=64, max_seq_len=8, attn_impl="xla")
    optimizer = make_optimizer(warmup_steps=1, total_steps=10)
    state = init_train_state(config, optimizer, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(config, optimizer, device="cpu")
    batch = make_example_batch(config, 2, 8, torch.Generator().manual_seed(1), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, batch)
    events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events())
    shares = [name for _, name in events if name.startswith(SHARE_PREFIX)]
    # On the CPU every tensor takes the loop.
    assert shares == [SHARE_PREFIX + "0.0"] * 2
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == spans.OPTIMIZER)
    starts = [t for t, name in events if name.startswith(SHARE_PREFIX)]
    assert len(ranges) == 2 and all(a <= t <= b for t, (a, b) in zip(starts, ranges))
