"""The port's flagship decoder against the JAX model on the CPU.

A tiny config (vocab 256, d_model 128, 2 layers, 4 heads over 2 kv heads,
d_ff 256, seq 128). JAX initialises the parameters; the weight bridge
carries them into the port; both see the same numpy batch. On the CPU both
sides take their plain attention path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import model as jax_model
from training_operator_tpu_torch.trainer import model as pt_model
from training_operator_tpu_torch.trainer.convert import flatten_tree, load_jax_params

TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=256, max_seq_len=128)
BATCH, SEQ = 2, 128


@pytest.fixture(autouse=True)
def _pin_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def configs(**kw):
    jcfg = jax_model.TransformerConfig(**{**TINY, "dtype": jnp.float32, **kw})
    pcfg = pt_model.TransformerConfig(**{**TINY, "dtype": torch.float32, **kw})
    return jcfg, pcfg


def numpy_batch(seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[1, SEQ // 2:] = 0.0  # a masked tail, so the masked mean is exercised
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


def jax_params(jcfg):
    return jax_model.init_params(jcfg, jax.random.PRNGKey(0))


def port_model(pcfg, params):
    model = pt_model.Transformer(pcfg, device="cpu")
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat,remat_head", [(True, True), (False, False)])
def test_loss_and_grads_match_fp32(remat, remat_head):
    jcfg, pcfg = configs(remat=remat, remat_head=remat_head)
    params = jax_params(jcfg)
    batch = numpy_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    exp_loss, exp_grads = jax.value_and_grad(jax_model.loss_fn)(params, jbatch, jcfg)

    model = port_model(pcfg, params)
    loss = pt_model.loss_fn(model, torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(exp_loss), rtol=1e-4)
    exp = flatten_tree(jax.tree.map(np.asarray, exp_grads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(exp)
    for name in exp:
        # rtol 1e-4 as stated; atol at 1e-4 of the leaf's largest entry
        # covers entries that are sums cancelling to near zero, where the
        # two frameworks' summation orders differ in the last bits.
        scale = np.abs(exp[name]).max()
        np.testing.assert_allclose(got[name], exp[name], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_forward_logits_match():
    jcfg, pcfg = configs(remat=False)
    params = jax_params(jcfg)
    batch = numpy_batch(1)
    exp = jax_model.forward(params, jnp.asarray(batch["tokens"]), jcfg)
    got = pt_model.forward(port_model(pcfg, params), torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=1e-4, atol=1e-4)


def test_loss_matches_bf16():
    """bf16 compute: the two frameworks round the bf16 activations at
    different places (fused XLA ops vs eager torch ops), so the loss is held
    to 1e-3 relative and the gradients to 5e-2 of each leaf's largest entry
    (bf16 keeps 8 bits, ~4e-3 relative per rounding, compounded over two
    layers)."""
    jcfg, pcfg = configs(remat=True)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    params = jax_params(jcfg)
    batch = numpy_batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    exp_loss, exp_grads = jax.value_and_grad(jax_model.loss_fn)(params, jbatch, jcfg)
    model = port_model(pcfg, params)
    loss = pt_model.loss_fn(model, torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(exp_loss), rtol=1e-3)
    exp = flatten_tree(jax.tree.map(np.asarray, exp_grads))
    for name, p in model.named_parameters():
        scale = np.abs(exp[name]).max()
        np.testing.assert_allclose(p.grad.numpy(), exp[name], atol=5e-2 * scale, err_msg=name)


def test_rms_norm_and_rope_match():
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    np.testing.assert_allclose(
        pt_model._rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jax_model._rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        pt_model._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 10000.0).numpy(),
        np.asarray(jax_model._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize(
    "kw,exc",
    [
        ({"n_experts": 4}, NotImplementedError),
        ({"remat_policy": "save_attn_qkv"}, NotImplementedError),
        ({"remat_policy": "bogus"}, ValueError),
        ({"n_heads": 3}, ValueError),
    ],
)
def test_config_refuses_what_is_not_ported(kw, exc):
    _, pcfg = configs(**kw)
    with pytest.raises(exc):
        pt_model.Transformer(pcfg, device="cpu")


def test_init_params_distribution():
    """Scaled-normal init: unit-scale embedding, d^-0.5 projections, the
    residual outputs shrunk by sqrt(2L), norm scales at one."""
    _, pcfg = configs()
    model = pt_model.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    p = dict(model.named_parameters())
    std = 128 ** -0.5
    assert abs(p["embed"].std().item() - 1.0) < 0.05
    assert abs(p["layers.wq"].std().item() - std) < 0.05 * std
    assert abs(p["layers.w2"].std().item() - std / 2.0) < 0.05 * std
    assert torch.all(p["layers.ln1"] == 1) and torch.all(p["ln_f"] == 1)
