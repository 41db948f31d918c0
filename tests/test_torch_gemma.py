"""A decoder of the Gemma-2B family (head_dim 256, one kv head) against JAX.

`bench.gemma2b_config` is chip_smoke.py phase 13's model: Gemma-2B's widths
on the repo's decoder. Here a small model of the same family (vocab 1024,
d_model 512, 2 heads of 256 over one kv head, d_ff 1024, 2 layers, seq 128,
`save_attn_qkv` + `remat_head`) is held to the JAX model on the CPU: JAX
initialises the parameters, the weight bridge carries them into the port,
and both see the same numpy batch. With `attn_impl="flash"` JAX runs its
Pallas kernels at head_dim 256 in interpret mode and the port the kernels'
plain versions; with "auto" both take their plain attention paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import model as jax_model
from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch.trainer import bench
from training_operator_tpu_torch.trainer import model as pt_model
from training_operator_tpu_torch.trainer import train as pt_train
from training_operator_tpu_torch.trainer.convert import (
    adam_moments_from_jax,
    flatten_tree,
    load_jax_params,
)

SMALL = dict(vocab_size=1024, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1,
             d_ff=1024, max_seq_len=128, remat=True, remat_policy="save_attn_qkv",
             remat_head=True)
BATCH, SEQ = 2, 128


@pytest.fixture(autouse=True)
def _pin_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def jax_config(pcfg, dtype=jnp.float32):
    """The JAX TransformerConfig with the same fields as the port's (those
    the JAX config lacks at their defaults, where the models agree)."""
    defaults = pt_model.TransformerConfig()
    assert all(getattr(pcfg, n) == getattr(defaults, n) for n in pt_model.PORT_ONLY_FIELDS)
    fields = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)
              if f.name != "dtype" and f.name not in pt_model.PORT_ONLY_FIELDS}
    return jax_model.TransformerConfig(**fields, dtype=dtype)


def configs(**kw):
    pcfg = pt_model.TransformerConfig(**{**SMALL, "dtype": torch.float32, **kw})
    return jax_config(pcfg), pcfg


def numpy_batch(seed):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, SMALL["vocab_size"], size=(BATCH, SEQ + 1)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[0, SEQ // 3:] = 0.0  # a masked tail, so the masked mean is exercised
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


def _close(got, want, name):
    # rtol 1e-4; atol at 1e-4 of the leaf's largest entry, for entries that
    # are sums cancelling to near zero (test_torch_model's tolerances).
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_loss_and_grads_match_jax(impl):
    jcfg, pcfg = configs(attn_impl=impl)
    assert pcfg.head_dim == 256
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    batch = numpy_batch(0)
    exp_loss, exp_grads = jax.value_and_grad(jax_model.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    model = load_jax_params(pt_model.Transformer(pcfg, device="cpu"),
                            jax.tree.map(np.asarray, params))
    loss = pt_model.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(exp_loss), rtol=1e-4)
    exp = flatten_tree(jax.tree.map(np.asarray, exp_grads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(exp)
    for name in exp:
        _close(got[name], exp[name], name)


def test_adamw_step_matches_optax():
    """Clip + AdamW steps with the Pallas kernels interpreted on the JAX
    side: loss, gradient norm, parameters and both moments. As in
    test_torch_train, warmup_steps=1: step 1 runs at rate 0 and fills the
    moments, step 2 moves the parameters at the peak rate. (A first Adam
    step at a rate above 0 moves each parameter by about the rate times the
    sign of its gradient, so a gradient that is summation noise on both
    sides moves it either way.)"""
    jcfg, pcfg = configs(attn_impl="flash")
    jopt = jax_train.make_optimizer(warmup_steps=1, total_steps=10)
    jstate = jax_train.init_train_state(jcfg, jopt, jax.random.PRNGKey(1))
    popt = pt_train.make_optimizer(warmup_steps=1, total_steps=10)
    model = load_jax_params(pt_model.Transformer(pcfg, device="cpu"),
                            jax.tree.map(np.asarray, jstate.params))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    pstate = pt_train.TrainState(step=0, model=model,
                                 opt_state=popt.init(dict(model.named_parameters())))
    jstep = jax_train.make_train_step(jcfg, jopt)
    pstep = pt_train.make_train_step(pcfg, popt, device="cpu")
    for i in range(2):
        batch = numpy_batch(1 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    exp_params = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    mu, nu, count = adam_moments_from_jax(jax.tree.map(np.asarray, jstate.opt_state))
    assert count == pstate.opt_state.count == 2
    for name, p in pstate.params.items():
        _close(p.detach().numpy(), exp_params[name], name)
        _close(pstate.opt_state.mu[name].numpy(), mu[name].numpy(), "mu " + name)
        _close(pstate.opt_state.nu[name].numpy(), nu[name].numpy(), "nu " + name)
    moved = max((p.detach() - start[n]).abs().max().item() for n, p in pstate.params.items())
    assert moved > 1e-4


def test_gemma2b_config_counts_its_parameters():
    """Phase 13's configuration: 3,030,460,416 parameters on the port's meta
    model and in jax.eval_shape of the JAX init with the same fields, of
    which 2,506,172,416 in products (the embedding is a gather)."""
    config, batch, seq = bench.gemma2b_config()
    assert (config.head_dim, config.n_kv_heads, batch, seq) == (256, 1, 1, 4096)
    total, products = bench._count_params(pt_model.Transformer(config, "meta"))
    assert (total, products) == (3_030_460_416, 2_506_172_416)
    jcfg = jax_config(config, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda key: jax_model.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == total
