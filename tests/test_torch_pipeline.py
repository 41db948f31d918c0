"""The port's GPipe pipeline against the JAX package's, on the CPU.

One world of 4 gloo processes (rank bodies in torch_mesh_workers.py, which
imports no JAX) on pipeline=2,data=2 runs the dense model (vocab 256,
d_model 128, 4 layers, 8 heads over 4 kv heads, d_ff 256, batches of
8 x 32, fp32) for 3 steps with 4 microbatches and with
`pipeline_microbatches=0` (one per stage), held to JAX's unpipelined step,
as the JAX pipeline test holds its own (tests/test_trainer.py:201-210);
`save_attn` against `full` in the pipeline (:334-348); the refusals; a
checkpoint written on the pipeline mesh read unsharded, and one written
unsharded read on the pipeline mesh. The same world runs
pipeline=2,expert=2 with 2 experts, held to JAX's pipelined loss and
gradients on the same virtual-device mesh: the MoE capacity counts each
microbatch, so the unpipelined numbers differ. This process runs the
loopback transport on the same MoE case.

Tolerances: loss and grad norm rtol 1e-5, parameters, mu and nu after 3
steps rtol 1e-4, atol 1e-6 (tests/test_torch_mesh.py); gradients rtol 1e-4
with atol 1e-4 of each leaf's largest entry (tests/test_torch_model.py);
save_attn against full 1e-5 (the JAX test's); the loopback against the
process group rtol 1e-5 (the same sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from test_torch_mesh import TINY, _assert_state_close, port_config
from training_operator_tpu.trainer import mesh as jax_mesh
from training_operator_tpu.trainer import model as jax_model
from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch import graft_entry
from training_operator_tpu_torch.trainer import distributed, pipeline
from training_operator_tpu_torch.trainer.checkpoint import Checkpointer
from training_operator_tpu_torch.trainer.convert import (
    adam_moments_from_jax,
    flatten_tree,
    load_jax_params,
)
from training_operator_tpu_torch.trainer.mesh import MeshSpec, build_mesh
from training_operator_tpu_torch.trainer.model import Transformer, loss_fn

AXES = {"pipeline": 2, "data": 2}
MOE_AXES = {"pipeline": 2, "expert": 2}
DENSE = dict(TINY, n_layers=4)
CONFIGS = {"pm4": dict(remat=False, pipeline_microbatches=4),
           "pm0": dict(remat=False, pipeline_microbatches=0),
           "full": dict(remat=True, remat_policy="full", pipeline_microbatches=4),
           "save_attn": dict(remat=True, remat_policy="save_attn", pipeline_microbatches=4)}
# Capacity factor 1: some tokens drop, and which depends on whether the
# capacity counts a microbatch (the pipeline) or the whole batch.
MOE = dict(TINY, n_experts=2, expert_capacity=1.0, pipeline_microbatches=2)


def _batch(seed, b):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 256, size=(b, 33)).astype(np.int32)
    mask = np.ones((b, 32), np.float32)
    mask[1, 20:] = 0.0
    mask[6 % b, 3:] = 0.0
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


BATCHES = [_batch(30 + i, 8) for i in range(3)]
MOE_BATCH = _batch(40, 4)


def _state_numpy(state):
    mu, nu, _ = adam_moments_from_jax(jax.tree.map(np.asarray, state.opt_state))
    full = {"params." + k: v for k, v in
            flatten_tree(jax.tree.map(np.asarray, state.params)).items()}
    full.update({"mu." + k: v.numpy() for k, v in mu.items()})
    full.update({"nu." + k: v.numpy() for k, v in nu.items()})
    return full


@pytest.fixture(scope="module")
def ref():
    """JAX: the dense model's unpipelined steps and loss (the pipeline does
    not change its math), and the MoE model's pipelined loss and gradients
    on pipeline=2,expert=2."""
    cpu = jax.devices("cpu")
    out = {}
    with jax.default_device(cpu[0]):
        jcfg = jax_model.TransformerConfig(**DENSE, dtype=jnp.float32, remat=False)
        opt = jax_train.make_optimizer(warmup_steps=1, total_steps=50)
        state = jax_train.init_train_state(jcfg, opt, jax.random.PRNGKey(0), None)
        out["params"] = jax.tree.map(np.asarray, state.params)
        out["loss"] = float(jax_model.loss_fn(
            state.params, {k: jnp.asarray(v) for k, v in BATCHES[0].items()}, jcfg))
        step = jax_train.make_train_step(jcfg, opt, None)
        steps = []
        for b in BATCHES:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            steps.append((float(m["loss"]), float(m["grad_norm"])))
        out["dense"] = {"steps": steps, "state": _state_numpy(state)}

        mcfg = jax_model.TransformerConfig(**MOE, dtype=jnp.float32, remat=False)
        mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(MOE_AXES), cpu)
        params = jax_model.init_params(mcfg, jax.random.PRNGKey(1))
        out["moe_params"] = jax.tree.map(np.asarray, params)
        batch = {k: jnp.asarray(v) for k, v in MOE_BATCH.items()}
        fn = jax.jit(jax.value_and_grad(lambda p, b: jax_model.loss_fn(p, b, mcfg, mesh)))
        loss, grads = fn(params, batch)
        flat = float(jax_model.loss_fn(params, batch, mcfg))
        out["moe"] = {"loss": float(loss), "flat_loss": flat,
                      "grads": flatten_tree(jax.tree.map(np.asarray, grads))}
    return out


def dense_config(**kw):
    return dataclasses.replace(port_config(**kw), n_layers=DENSE["n_layers"])


def moe_config():
    return port_config(**{k: v for k, v in MOE.items() if k not in TINY}, remat=False)


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The port's world, and the unsharded checkpoint it restores."""
    tmp = tmp_path_factory.mktemp("pipe")
    configs = {name: dense_config(**kw) for name, kw in CONFIGS.items()}
    flat_ckpt = str(tmp / "flat")
    state = workers.sharded_state(configs["pm4"], ref["params"], None)
    workers.train(state, configs["pm4"], BATCHES[:1])
    Checkpointer(flat_ckpt).save(state)
    ranks = distributed.spawn(workers.pipeline_world, 4, (
        AXES, configs, ref["params"], BATCHES,
        (MOE_AXES, moe_config(), ref["moe_params"], MOE_BATCH), str(tmp / "ckpt"),
        flat_ckpt))
    return ranks, str(tmp / "ckpt"), workers.gathered(state)


@pytest.mark.parametrize("config", ["pm4", "pm0"])
def test_pipeline_steps_match_unpipelined_jax(ref, world, config):
    """3 steps on pipeline=2,data=2 with 4 microbatches, and with one per
    stage (pipeline_microbatches=0), equal JAX's unpipelined steps."""
    ranks, _, _ = world
    for out in ranks:
        np.testing.assert_allclose(out[config]["steps"], ref["dense"]["steps"], rtol=1e-5)
        np.testing.assert_allclose(out[config]["loss"], ref["loss"], rtol=1e-5)
    _assert_state_close(ranks[0][config]["state"], ref["dense"]["state"])


def test_save_attn_in_the_pipeline_equals_full(world):
    ranks, _, _ = world
    for out in ranks:
        assert abs(out["save_attn"]["loss"] - out["full"]["loss"]) < 1e-5
        np.testing.assert_allclose(out["save_attn"]["steps"], out["full"]["steps"], rtol=1e-5)


def test_loader_gives_each_rank_its_block_of_every_microbatch(world):
    """On pipeline=2,data=2 with 4 microbatches of 2 rows, data rank r holds
    row r of each (mesh.batch_rows): rows r, 2 + r, 4 + r, 6 + r of the
    unsharded loader's batch; pipeline peers hold the same rows."""
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset

    ranks, _, _ = world
    rows = np.random.RandomState(3).randint(0, 256, size=(24, 33)).astype(np.int32)
    whole = [b["tokens"].numpy() for _, b in zip(range(2), DataLoader(
        TokenDataset(rows), 8, device="cpu"))]
    for rank, out in enumerate(ranks):
        data = rank % 2  # rank = pipeline x 2 + data
        for i in range(2):
            assert np.array_equal(out["loader"][i], whole[i][data::2]), (rank, i)


def test_pipeline_refusals(ref, world):
    ranks, _, _ = world
    for out in ranks:
        assert out["refusals"] == {
            "batch": "batch 6 not divisible by microbatches 4",
            "microbatch": "microbatch of 1 rows does not split over the batch axes "
                          "('data', 'fsdp', 'expert') (2 shards)",
            "n_layers": "n_layers=3 not divisible by pipeline=2",
        }
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_mesh(MeshSpec({"pipeline": 2, "sequence": 2, "data": 2}), "cpu")
    model = pipeline.loopback(load_jax_params(Transformer(moe_config(), "cpu"),
                                              ref["moe_params"]), 2)
    batch = {k: torch.from_numpy(v[:3]) for k, v in MOE_BATCH.items()}
    with pytest.raises(ValueError, match="batch 3 not divisible by microbatches 2"):
        loss_fn(model, batch)


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name in want:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_pipelined_moe_matches_jax_pipelined(ref, world):
    """pipeline=2,expert=2 with 2 experts and 2 microbatches: the loss and
    every gradient equal JAX's pipelined ones; the unpipelined loss is
    another number (capacity per microbatch)."""
    ranks, _, _ = world
    want = ref["moe"]
    for out in ranks:
        np.testing.assert_allclose(out["moe"]["loss"], want["loss"], rtol=1e-5)
    _assert_grads_close(ranks[0]["moe"]["grads"], want["grads"])
    assert abs(want["loss"] - want["flat_loss"]) > 1e-4


def test_loopback_equals_the_process_group(ref, world):
    """The two stages in this process (pipeline.loopback) give the process
    group's loss and gradients on the same MoE case."""
    ranks, _, _ = world
    model = pipeline.loopback(load_jax_params(Transformer(moe_config(), "cpu"),
                                              ref["moe_params"]), 2)
    loss = loss_fn(model, {k: torch.from_numpy(v) for k, v in MOE_BATCH.items()})
    loss.backward()
    group = ranks[0]["moe"]
    np.testing.assert_allclose(loss.item(), group["loss"], rtol=1e-5)
    for name, p in model.named_parameters():
        scale = np.abs(group["grads"][name]).max()
        np.testing.assert_allclose(p.grad.numpy(), group["grads"][name], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_pipeline_checkpoint_restores_across_meshes(world):
    """Written on pipeline=2,data=2 after the pm4 steps, read unsharded; and
    written unsharded, read on pipeline=2,data=2: every parameter and
    moment bit for bit."""
    ranks, ckpt, flat_saved = world
    restored = workers.restore(None, dense_config(**CONFIGS["pm4"]), ckpt, BATCHES[0])
    saved = ranks[0]["pm4"]["state"]
    assert set(restored["state"]) == set(saved)
    for key in saved:
        assert np.array_equal(restored["state"][key], saved[key]), key
    assert restored["step"] == 3 and np.isfinite(restored["loss"])
    onto = ranks[0]["restored"]
    for key in flat_saved:
        assert np.array_equal(onto["state"][key], flat_saved[key]), key
    assert onto["step"] == 1


def test_dryrun_multichip_runs_pass_2(capsys):
    """dryrun_multichip(8): passes 1-3, pass 2 on pipeline=2,expert=2,
    tensor=2 with the MoE config, each within 5e-3 of the single-process
    loss; no pass is reported as not run."""
    passes = graft_entry.dryrun_multichip(8)
    assert [p["mesh"] for p in passes][1] == {"pipeline": 2, "data": 1, "fsdp": 1,
                                              "expert": 2, "sequence": 1, "tensor": 2}
    assert len(passes) == 3
    printed = capsys.readouterr().out
    assert "pp/ep" in printed and "not run" not in printed
