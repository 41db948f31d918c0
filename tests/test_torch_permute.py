"""The dropless expert layer's permutation wrappers (trainer/permute.py) and
their CPU path (trainer/moe.py's `_Dispatch` and `_Combine`) on the CPU: what
the card's kernels refuse raises with the reason, before any kernel loads,
and nothing on a device other than the CPU falls back to the torch ops; on
the CPU the two Functions are the plain torch ops bit for bit, forward and
backward, with no launch counted. The kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import pytest
import torch

from training_operator_tpu_torch.trainer import kernels, moe, permute

T, K, D, ROWS = 6, 2, 16, 6 * 2 + 4 * 4


def _call(**over):
    """A scatter of [T, D] bf16 rows with a gate and y, everything right
    unless `over` replaces it."""
    g = torch.Generator().manual_seed(0)
    args = dict(src=torch.randn(T, D, generator=g).bfloat16(),
                dest=torch.randperm(ROWS, generator=g)[:T * K].view(T, K),
                rows=ROWS, gate=torch.rand(T, K, generator=g),
                y=torch.randn(ROWS, D, generator=g).bfloat16())
    args.update(over)
    return args


CASES = {
    "src not bf16": (dict(src=torch.zeros(T, D)), "rows not bfloat16"),
    "y not bf16": (dict(y=torch.zeros(ROWS, D, dtype=torch.float16)), "rows not bfloat16"),
    "dest not int64": (dict(dest=torch.zeros(T, K, dtype=torch.int32)), "dest not int64"),
    "gate not fp32": (dict(gate=torch.zeros(T, K, dtype=torch.bfloat16)), "gate not float32"),
    "src transposed": (dict(src=torch.zeros(D, T, dtype=torch.bfloat16).t()),
                       "not contiguous"),
    "dest flat": (dict(dest=torch.zeros(T * K, dtype=torch.int64)), "dest not \\[T, k\\]"),
    "k past 32": (dict(dest=torch.zeros(T, 33, dtype=torch.int64),
                       gate=torch.zeros(T, 33)), "dest not \\[T, k\\]"),
    "gate shape": (dict(gate=torch.zeros(T, K + 1)), "gate and dest shapes differ"),
    "y width": (dict(y=torch.zeros(ROWS, D + 8, dtype=torch.bfloat16)), "one D"),
    "src tokens": (dict(src=torch.zeros(T + 1, D, dtype=torch.bfloat16)),
                   "src and dest differ in tokens"),
    "y rows": (dict(y=torch.zeros(ROWS + 1, D, dtype=torch.bfloat16)),
               "y's rows are not the output's"),
    "width not 16-byte": (dict(src=torch.zeros(T, 12, dtype=torch.bfloat16),
                               y=torch.zeros(ROWS, 12, dtype=torch.bfloat16)),
                          "16-byte units"),
    "src unaligned": (dict(src=torch.zeros(T * D + 1, dtype=torch.bfloat16)[1:].view(T, D)),
                      "16-byte units"),
    "on the CPU": (dict(), "not on one CUDA device"),
    "mixed devices": (dict(dest=torch.zeros(T, K, dtype=torch.int64, device="meta")),
                      "not on one CUDA device"),
}


@pytest.fixture
def no_build(monkeypatch):
    def refuse():
        raise AssertionError("a refused call reached the kernels")

    monkeypatch.setattr(kernels, "load", refuse)
    permute.reset_launches()
    yield
    assert permute.launches == {"scatter": 0, "gather_sum": 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_scatter_refuses_with_the_reason(no_build, case):
    over, reason = CASES[case]
    with pytest.raises(ValueError, match=f"^scatter: .*refused: .*{reason}"):
        permute.scatter(**_call(**over))


@pytest.mark.parametrize("case", ["dest not int64", "gate not fp32", "gate shape", "k past 32",
                                  "on the CPU", "mixed devices"])
def test_the_gather_sum_refuses_with_the_reason(no_build, case):
    over, reason = CASES[case]
    args = _call(**over)
    with pytest.raises(ValueError, match=f"^gather_sum: .*refused: .*{reason}"):
        permute.gather_sum(args["y"], args["dest"], args["gate"])


def test_a_gate_without_y_is_refused(no_build):
    with pytest.raises(ValueError, match="gate and y together"):
        permute.scatter(**_call(y=None))


def test_tensors_off_the_cpu_never_take_the_torch_ops(no_build):
    """A call with any tensor off the CPU goes to the kernels' wrappers,
    which refuse mixed devices: the Functions do not fall back."""
    meta = torch.zeros(T, D, dtype=torch.bfloat16, device="meta")
    dest = torch.arange(T * K)
    assert permute.fused(meta, dest) and not permute.fused(dest.float(), dest)
    with pytest.raises(ValueError, match="not on one CUDA device"):
        moe._Dispatch.apply(meta, dest, ROWS, K)
    with pytest.raises(ValueError, match="not on one CUDA device"):
        moe._Combine.apply(torch.zeros(ROWS, D, dtype=torch.bfloat16, device="meta"),
                           torch.zeros(T, K), dest)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_on_the_cpu_the_functions_are_the_torch_ops_bit_for_bit(dtype):
    """`_Dispatch` and `_Combine` on CPU tensors against the plain torch ops
    under autograd: outputs and every gradient equal, no launch counted."""
    g = torch.Generator().manual_seed(3)
    dest = torch.randperm(ROWS, generator=g)[:T * K]
    x = torch.randn(T, D, generator=g).to(dtype)
    gate = torch.rand(T, K, generator=g)
    w = torch.randn(D, D, generator=g).to(dtype)
    dout = torch.randn(T, D, generator=g).to(dtype)

    def run(dispatch, combine):
        leaves = [t.clone().requires_grad_() for t in (x, gate)]
        xs = dispatch(leaves[0])
        out = combine(torch.tanh(xs @ w), leaves[1])
        out.backward(dout)
        return [xs, out] + [t.grad for t in leaves]

    permute.reset_launches()
    got = run(lambda x: moe._Dispatch.apply(x, dest, ROWS, K),
              lambda y, gate: moe._Combine.apply(y, gate, dest))
    want = run(lambda x: _plain_dispatch_op(x, dest),
               lambda y, gate: moe.plain_combine(y, gate, dest))
    assert permute.launches == {"scatter": 0, "gather_sum": 0}
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    named = torch.zeros(ROWS, dtype=torch.bool)
    named[dest] = True
    assert not got[0][~named].any()


def _plain_dispatch_op(x, dest):
    """The dispatch and its backward as the plain functions, through
    autograd (the layer's `_Dispatch` before the kernels)."""

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return moe.plain_dispatch(x, dest, ROWS, K)

        @staticmethod
        def backward(ctx, grad):
            return moe.plain_dispatch_backward(grad, dest, K)

    return Plain.apply(x)
