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
        ({"n_experts": -1}, ValueError),
        ({"pipeline_microbatches": -2}, ValueError),
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


POLICIES = ("full", "save_attn", "save_attn_qkv", "mlp_only", "save_dots")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(policy):
    """Each remat policy against jax.value_and_grad under the same policy:
    the loss and every gradient leaf, fp32, at the tolerance stated in
    test_loss_and_grads_match_fp32."""
    jcfg, pcfg = configs(remat=True, remat_head=True, remat_policy=policy)
    params = jax_params(jcfg)
    batch = numpy_batch(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    exp_loss, exp_grads = jax.value_and_grad(jax_model.loss_fn)(params, jbatch, jcfg)
    model = port_model(pcfg, params)
    loss = pt_model.loss_fn(model, torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(exp_loss), rtol=1e-4)
    exp = flatten_tree(jax.tree.map(np.asarray, exp_grads))
    for name, p in model.named_parameters():
        scale = np.abs(exp[name]).max()
        np.testing.assert_allclose(p.grad.numpy(), exp[name], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("policy,per_layer", [("full", 2), ("save_dots", 2), ("save_attn", 1),
                                              ("save_attn_qkv", 1), ("mlp_only", 1)])
def test_remat_policy_flash_forward_calls(policy, per_layer, monkeypatch):
    """The port's counterpart of the JAX save_attn test: with the flash path
    (its plain version on the CPU), one training step calls the forward 2L
    times under "full" and "save_dots" (each layer's recompute runs it
    again) and L times where the policy keeps its outputs or runs attention
    outside the checkpoint. The gradients do not change."""
    from training_operator_tpu_torch.trainer import flash as pt_flash

    calls = []
    plain = pt_flash.flash_fwd_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(pt_flash, "flash_fwd_plain", counted)
    params = jax_params(configs()[0])
    batch = torch_batch(numpy_batch(4))
    grads = {}
    for pol in ("full", policy):
        _, pcfg = configs(attn_impl="flash", remat_policy=pol)
        model = port_model(pcfg, params)
        calls.clear()
        pt_model.loss_fn(model, batch).backward()
        grads[pol] = {n: p.grad for n, p in model.named_parameters()}
        count = len(calls)
    assert count == per_layer * TINY["n_layers"]
    for name, g in grads[policy].items():
        torch.testing.assert_close(g, grads["full"][name], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy,per_layer", [("full", 2), ("save_dots", 2), ("save_attn", 1),
                                              ("save_attn_qkv", 1), ("mlp_only", 1)])
def test_remat_policy_plain_forward_calls(policy, per_layer, monkeypatch):
    """The same on the plain attention path (attn_impl "xla"), as JAX names
    "attn_out" on every backend: under "save_attn" and "save_attn_qkv" the
    plain attention output is computed once per layer per step, not again in
    the backward. The gradients do not change."""
    from training_operator_tpu_torch.trainer import attention as pt_attention

    calls = []
    plain = pt_attention.plain_attention_fwd

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(pt_attention, "plain_attention_fwd", counted)
    params = jax_params(configs()[0])
    batch = torch_batch(numpy_batch(4))
    grads = {}
    for pol in ("full", policy):
        _, pcfg = configs(attn_impl="xla", remat_policy=pol)
        model = port_model(pcfg, params)
        calls.clear()
        pt_model.loss_fn(model, batch).backward()
        grads[pol] = {n: p.grad for n, p in model.named_parameters()}
        count = len(calls)
    assert count == per_layer * TINY["n_layers"]
    for name, g in grads[policy].items():
        torch.testing.assert_close(g, grads["full"][name], rtol=1e-5, atol=1e-6)


def test_unknown_remat_policy_rejected():
    _, pcfg = configs(remat_policy="save_atn")
    with pytest.raises(ValueError, match="remat_policy"):
        pt_model.init_params(pcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        pt_model.layer_body(pcfg, torch.zeros(1, 1))


def test_flagship_fp32_config_counts_the_flagships_parameters():
    """chip_smoke.py phase 14's model, bench.flagship_fp32_config: the
    flagship with dtype float32 and every other field, the batch and the
    sequence the flagship's; the same parameters on the port's meta model
    and in jax.eval_shape of the JAX init with the same fields and
    dtype=jnp.float32."""
    from training_operator_tpu_torch.trainer import bench

    config, batch, seq = bench.flagship_fp32_config()
    flagship, batch_bf16, seq_bf16 = bench.flagship_config()
    assert config.dtype == torch.float32 and flagship.dtype == torch.bfloat16
    assert dataclasses.replace(config, dtype=torch.bfloat16) == flagship
    assert (batch, seq) == (batch_bf16, seq_bf16) == (8, 2048)
    total = bench._count_params(pt_model.Transformer(config, "meta"))[0]
    assert total == bench._count_params(pt_model.Transformer(flagship, "meta"))[0]
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)
              if f.name != "dtype"}
    jcfg = jax_model.TransformerConfig(**fields, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda key: jax_model.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == total
