"""The port's flash attention against the JAX package's Pallas kernels.

Inputs come from numpy with a fixed seed and go to both sides. The JAX side
runs its Pallas kernels in interpret mode on the CPU; the port's wrappers,
given CPU tensors, run their plain PyTorch versions (the CUDA kernels run
only on the card: chip_smoke.py and tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import attention as jax_attention
from training_operator_tpu.trainer import flash as jax_flash
from training_operator_tpu_torch.trainer import attention as pt_attention
from training_operator_tpu_torch.trainer import flash as pt_flash


def _inputs(seed, shape, n=3):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(autouse=True)
def _pin_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.mark.parametrize(
    "shape,causal",
    [((2, 256, 4, 64), True), ((2, 256, 4, 64), False), ((1, 200, 2, 64), True),
     ((1, 256, 2, 256), True), ((1, 256, 2, 256), False), ((1, 200, 2, 256), True)],
)
def test_forward_matches_pallas(shape, causal):
    q, k, v = _inputs(0, shape)
    exp_out, exp_lse = jax_flash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 128, 128, True
    )
    got_out, got_lse = pt_flash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal
    )
    s = shape[1]
    assert tuple(got_lse.shape) == (shape[0] * shape[2], s, 1)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(exp_out), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(exp_lse)[:, :s], atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (1, 200, 2, 64), (1, 128, 2, 256)])
def test_gradients_match_pallas(shape):
    """The autograd rule (plain dq and dk/dv on the CPU) against jax.grad of
    the Pallas flash kernels; distinct q/k/v so every gradient path counts."""
    q, k, v = _inputs(1, shape)
    exp = jax.grad(
        lambda a, b, c: (jax_flash.flash_attention(a, b, c, True, 128, 128, True) ** 2).sum(),
        argnums=(0, 1, 2),
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (pt_flash.flash_attention(tq, tk, tv, True) ** 2).sum().backward()
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), exp, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, err_msg=name)


@pytest.mark.parametrize("shape", [(4097, 32, 16, 64), (1, 4096, 8, 256), (2, 1000, 4, 128),
                                   (1, 64, 65536, 64)])
def test_what_auto_sends_the_kernels_they_take(shape):
    """`auto` sends a CUDA tensor to the kernels whenever `kernel_supports`
    says they take it, so the wrappers' own checks must then pass: head_dim
    256, and batch*heads above 65535 (4097 x 16 = 65552, 1 x 65536), which
    the dk/dv launch once could not put in its grid. Meta tensors carry the
    shapes without memory."""
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert pt_flash.kernel_supports(q)
    pt_flash._check_kernel_inputs(q, q, q, q)


@pytest.mark.parametrize("head_dim,dtype", [(96, torch.bfloat16), (512, torch.bfloat16),
                                            (64, torch.float32), (256, torch.float16)])
def test_kernel_checks_refuse_what_the_kernels_do_not_take(head_dim, dtype):
    q = torch.empty((1, 64, 2, head_dim), dtype=dtype, device="meta")
    assert not pt_flash.kernel_supports(q)
    with pytest.raises(ValueError, match="the flash kernels take"):
        pt_flash._check_kernel_inputs(q, q, q)


def test_lse_carries_no_gradient():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(2, (1, 64, 2, 64)))
    out, lse = pt_flash.flash_attention_with_lse(q, k, v)
    assert out.requires_grad and not lse.requires_grad


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_gqa_through_dispatcher(impl):
    """kv heads < q heads: the port's dispatcher (repeat_interleave on the
    head axis) against the JAX dispatcher's XLA path."""
    rng = np.random.RandomState(3)
    q = rng.standard_normal((2, 128, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
    exp = jax_attention.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=None, causal=True, impl="xla"
    )
    got = pt_attention.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, impl=impl
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5)


def test_plain_versions_agree_with_each_other():
    """dq, dk, dv from the plain kernel versions equal autograd through the
    plain attention path (fp32, same inputs)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, (2, 96, 2, 64), n=4))
    out, lse = pt_flash.flash_fwd_plain(q, k, v, True)
    delta = (do * out).sum(-1).permute(0, 2, 1).reshape(4, 96)
    dq = pt_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, True)
    dk, dv = pt_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    ref = pt_attention.plain_attention(tq, tk, tv, causal=True)
    torch.testing.assert_close(out, ref.detach(), atol=1e-5, rtol=1e-5)
    gq, gk, gv = torch.autograd.grad(ref, (tq, tk, tv), do)
    for got, want in ((dq, gq), (dk, gk), (dv, gv)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_wrappers_refuse_mixed_devices_and_unknown_impl():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError):
        pt_attention.attention(q, q, q, impl="nope")
    # Without a sequence axis "ring" and "ulysses" take the single-device
    # path, as the JAX dispatcher does: its plain path, on any mesh-less call.
    x = _inputs(7, (1, 8, 2, 64), n=1)[0]
    want = np.asarray(jax_attention.attention(*(jnp.asarray(x),) * 3, impl="ring"))
    for impl in ("ring", "ulysses"):
        got = pt_attention.attention(*(torch.from_numpy(x),) * 3, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=impl)
    meta = torch.zeros(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError):
        pt_flash.flash_fwd(q, meta, q)
