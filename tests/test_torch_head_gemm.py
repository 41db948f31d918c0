"""The head's fp32 product op (trainer/head_gemm.py) on the CPU.

On CPU tensors the op takes the plain product, so the port's CPU tests see
`x @ W` bit for bit; on the card it launches the 3xTF32 kernel
(tests/test_torch_cuda.py). Here: the op against the test's own `x @ W`
with autograd, every head entry routed through the op with and without
`remat_head`, the launch counters, and the kernel's plan at the benchmark
cells' shapes and the tiny test shapes.
"""

import math
from dataclasses import astuple

import pytest
import torch

from training_operator_tpu_torch.trainer import head_gemm
from training_operator_tpu_torch.trainer import model as pt_model

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
            max_seq_len=32, dtype=torch.float32)


def _pair(shape_x, v, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape_x, generator=g)
    w = torch.randn(shape_x[-1], v, generator=g)
    return x, w


@pytest.mark.parametrize("shape_x", [(37, 48), (3, 13, 48)])
def test_op_on_cpu_is_x_at_w_bit_for_bit(shape_x):
    """Forward and both gradients at a ragged shape (T=37, D=48, V=101)
    equal autograd's own x @ W exactly."""
    x, w = _pair(shape_x, 101)
    dl = torch.randn(*shape_x[:-1], 101, generator=torch.Generator().manual_seed(1))
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = xa @ wa
    want.backward(dl)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = head_gemm.head_matmul(xb, wb)
    got.backward(dl)
    assert torch.equal(got, want)
    assert torch.equal(xb.grad, xa.grad)
    assert torch.equal(wb.grad, wa.grad)


def test_op_gradient_only_where_asked():
    x, w = _pair((37, 48), 101)
    w.requires_grad_()
    head_gemm.head_matmul(x, w).sum().backward()
    assert x.grad is None and w.grad is not None


@pytest.fixture
def counted(monkeypatch):
    """Calls of each product's plain version, the op's CPU path."""
    calls = dict.fromkeys(head_gemm.PRODUCTS, 0)
    for product in head_gemm.PRODUCTS:
        name = f"head_{product}_plain"
        plain = getattr(head_gemm, name)

        def wrapped(*args, _plain=plain, _product=product):
            calls[_product] += 1
            return _plain(*args)

        monkeypatch.setattr(head_gemm, name, wrapped)
    head_gemm.reset_launches()
    return calls


def _model(remat_head):
    config = pt_model.TransformerConfig(**TINY, remat_head=remat_head)
    torch.manual_seed(0)
    return pt_model.Transformer(config, device="cpu"), config


def _tokens(b=2, s=16):
    g = torch.Generator().manual_seed(3)
    return torch.randint(0, TINY["vocab_size"], (b, s + 1), generator=g)


@pytest.mark.parametrize("remat_head", [False, True])
@pytest.mark.parametrize("entry", ["head_logits", "forward", "head_nll", "final_nll", "loss_fn"])
def test_head_entries_route_through_the_op(counted, entry, remat_head):
    """Every way into the fp32 head runs the op: the logits once, and in a
    backward dX and dW once each, plus the recompute's logits under
    remat_head where the head is checkpointed (final_nll, loss_fn)."""
    model, config = _model(remat_head)
    rows = _tokens()
    tokens, targets = rows[:, :-1], rows[:, 1:]
    x = pt_model.backbone(model, tokens).detach().requires_grad_()
    if entry == "head_logits":
        out = pt_model._head_logits(x, model.lm_head).sum()
    elif entry == "forward":
        out = pt_model.forward(model, tokens).sum()
    elif entry == "head_nll":
        out = pt_model._head_nll(x, model.lm_head, targets).sum()
    elif entry == "final_nll":
        out = pt_model.final_nll(x, model.ln_f, model.lm_head, targets, config).sum()
    else:
        out = pt_model.loss_fn(model, {"tokens": tokens, "targets": targets})
    assert counted == {"logits": 1, "dx": 0, "dw": 0}
    out.backward()
    recompute = int(remat_head and entry in ("final_nll", "loss_fn"))
    assert counted == {"logits": 1 + recompute, "dx": 1, "dw": 1}
    assert model.lm_head.grad is not None


def test_launch_counters_stay_zero_on_cpu():
    model, _ = _model(True)
    rows = _tokens()
    head_gemm.reset_launches()
    pt_model.loss_fn(model, {"tokens": rows[:, :-1], "targets": rows[:, 1:]}).backward()
    assert head_gemm.launches == {"logits": 0, "dx": 0, "dw": 0}


def test_op_refuses_mixed_devices():
    x, w = _pair((4, 8), 16)
    with pytest.raises(ValueError, match="all lie on the CPU or all on the card"):
        head_gemm.head_logits(x, w.to("meta"))


# The benchmark cells' (T, D, V): Mistral-7B stage at 4 x 4096 and 1 x
# 32768 tokens, InternLM2-1.8B at 4 x 4096 and 1 x 16384; then the tiny
# shapes the tests send the card (vocab 256, 512 and 101).
CELL_SHAPES = [(16384, 4096, 32768), (16384, 2048, 92544), (32768, 4096, 32768),
               (16384, 2048, 92544)]
TINY_SHAPES = [(37, 48, 101), (64, 32, 256), (300, 96, 512), (1, 1, 1), (129, 130, 257)]


@pytest.mark.parametrize("shape", CELL_SHAPES + TINY_SHAPES)
@pytest.mark.parametrize("product", head_gemm.PRODUCTS)
def test_plan_covers_the_cells_and_the_tiny_shapes(product, shape):
    t, d, v = shape
    p = head_gemm.plan(product, t, d, v)
    m, n, k = p.m, p.n, p.k
    assert sorted((m, n, k)) == sorted((t, d, v)) and m * n * k == t * d * v
    # Tiles cover C exactly once.
    assert p.tiles == math.ceil(m / head_gemm.TILE) * math.ceil(n / head_gemm.TILE)
    # Chunks: none past CHUNK_MAX, and as even as the k blocks allow.
    blocks = math.ceil(k / head_gemm.BLOCK_K)
    assert 1 <= p.chunk * head_gemm.BLOCK_K <= head_gemm.CHUNK_MAX
    chunks = math.ceil(blocks * head_gemm.BLOCK_K / head_gemm.CHUNK_MAX)  # the fewest
    assert p.chunk == math.ceil(blocks / chunks)
    assert 1 <= p.group <= math.ceil(m / head_gemm.TILE)


def test_plan_at_the_cells():
    """The orientation the kernel needs (the K-major operand in shared
    memory) and the longest sums: dX sums over the vocabulary."""
    per_chunk = head_gemm.CHUNK_MAX // head_gemm.BLOCK_K
    assert astuple(head_gemm.plan("logits", 16384, 4096, 32768)) == (
        32768, 16384, 4096, per_chunk, 11, 256 * 128)
    assert astuple(head_gemm.plan("dx", 16384, 2048, 92544)) == (
        16384, 2048, 92544, per_chunk, 11, 128 * 16)
    assert astuple(head_gemm.plan("dw", 32768, 4096, 32768)) == (
        32768, 4096, 32768, per_chunk, 11, 256 * 32)
    assert head_gemm.plan("dx", 37, 48, 101).chunk == 4  # 4 blocks of 32, one chunk
    with pytest.raises(ValueError):
        head_gemm.plan("dq", 1, 1, 1)
    with pytest.raises(ValueError):
        head_gemm.plan("dx", 0, 4, 4)


@pytest.mark.parametrize("call", [
    lambda x, w, dl: head_gemm.head_logits(x.double(), w.double()),
    lambda x, w, dl: head_gemm.head_logits(x[:, :-1], w),
    lambda x, w, dl: head_gemm.head_dx(dl, w[:, :-1]),
    lambda x, w, dl: head_gemm.head_dw(x[:-1], dl),
    lambda x, w, dl: head_gemm.head_logits(x, w[None]),
    None,
], ids=["float64", "logits_d", "dx_d", "dw_rows", "w_3d", "valid"])
def test_wrappers_check_shapes_before_the_kernel(monkeypatch, call):
    """The card's path checks dtype and shapes before it hands the kernel
    pointers: meta tensors sent down it (as if on the card) raise there,
    and valid ones reach the launch."""
    launched = []
    monkeypatch.setattr(head_gemm, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(head_gemm, "_launch", lambda product, *args: launched.append(product))
    x, w, dl = (t.to("meta") for t in (*_pair((6, 8), 16), torch.randn(6, 16)))
    if call is None:
        head_gemm.head_logits(x, w), head_gemm.head_dx(dl, w), head_gemm.head_dw(x, dl)
        assert launched == ["logits", "dx", "dw"]
    else:
        with pytest.raises(ValueError, match="float32|do not match"):
            call(x, w, dl)
        assert not launched
