"""The port's switch MoE and expert parallelism against the JAX package's.

Single process: the MoE layer (moe.moe_mlp) against the JAX `_moe_mlp`, and
the MoE model's loss and gradients against `jax.value_and_grad(loss_fn)`
under every remat policy. Then one world of 4 gloo processes (rank bodies
in torch_mesh_workers.py, which imports no JAX): three sharded steps on
expert=2,data=2, expert=2,fsdp=2 and expert=2,sequence=2 against JAX's
sharded steps on the same virtual-device meshes, the MoE layer on
expert=2,data=2 where one rank's tokens drop only because the ranks before
it filled the expert, and the checkpoint written on expert=2,data=2
restored unsharded (expert=1).

Tolerances: the layer in fp32 rtol 1e-5 (atol 1e-6); in bf16 atol 2e-2
times the largest output (the expert products round to bf16 after
accumulating in another order than XLA's: one bf16 step is 2^-8 of the
value). The kept set exactly; the aux rtol 1e-6 (its sums of
probabilities run in another order). The model as tests/test_torch_model.py
holds the dense one: loss rtol 1e-4, gradients rtol 1e-4 with atol 1e-4 of
each leaf's largest entry. The sharded steps as tests/test_torch_mesh.py:
loss and grad norm rtol 1e-5; parameters, mu and nu after 3 steps rtol
1e-4, atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from test_torch_mesh import BATCHES, TINY, _assert_state_close
from training_operator_tpu.trainer import mesh as jax_mesh
from training_operator_tpu.trainer import model as jax_model
from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch.trainer import distributed, moe
from training_operator_tpu_torch.trainer import model as pt_model
from training_operator_tpu_torch.trainer.convert import (
    adam_moments_from_jax,
    flatten_tree,
    load_jax_params,
)

E = 4
MOE = dict(TINY, n_experts=E)
CASES = {"expert_data": {"expert": 2, "data": 2},
         "expert_fsdp": {"expert": 2, "fsdp": 2},
         "expert_sequence": {"expert": 2, "sequence": 2}}
POLICIES = ("none", "full", "mlp_only", "save_attn", "save_attn_qkv", "save_dots")
D, F = 64, 96


def configs(**kw):
    jcfg = jax_model.TransformerConfig(**MOE, dtype=jnp.float32, **kw)
    pcfg = pt_model.TransformerConfig(**MOE, dtype=torch.float32, **kw)
    return jcfg, pcfg


def layer_weights(seed: int, n_experts: int, force: int = -1):
    """Router [D, E] and expert stacks; `force` >= 0 adds a large router
    column so that nearly every token chooses that expert."""
    rng = np.random.RandomState(seed)
    lp = {"router": rng.standard_normal((D, n_experts)).astype(np.float32) * 0.3,
          "w1": rng.standard_normal((n_experts, D, F)).astype(np.float32) * 0.1,
          "w3": rng.standard_normal((n_experts, D, F)).astype(np.float32) * 0.1,
          "w2": rng.standard_normal((n_experts, F, D)).astype(np.float32) * 0.1}
    if force >= 0:
        lp["router"][:, force] += 8.0
    return lp


def hidden(seed: int, shape=(2, 32, D)):
    # A positive mean, so a large router column wins for every token.
    return (np.random.RandomState(seed).standard_normal(shape) + 1.0).astype(np.float32)


def layer_config(dtype="float32", n_experts=E):
    kw = dict(vocab_size=256, d_model=D, n_layers=1, n_heads=4, n_kv_heads=4, d_ff=F,
              n_experts=n_experts)
    return (jax_model.TransformerConfig(**kw, dtype=getattr(jnp, dtype)),
            pt_model.TransformerConfig(**kw, dtype=getattr(torch, dtype)))


def jax_layer(h, lp, jcfg):
    with jax.default_device(jax.devices("cpu")[0]):
        out, aux = jax_model._moe_mlp(jnp.asarray(h).astype(jcfg.dtype),
                                      {k: jnp.asarray(v) for k, v in lp.items()}, jcfg, None)
        return np.asarray(out.astype(jnp.float32)), float(aux)


def port_layer(h, lp, pcfg):
    t = {k: torch.from_numpy(v) for k, v in lp.items()}
    x = torch.from_numpy(h).to(pcfg.dtype)
    out, aux = moe.moe_mlp(x, t["router"], {k: t[k] for k in ("w1", "w3", "w2")}, pcfg)
    keep = moe.route(x, t["router"], pcfg)[3].view(h.shape[:2])
    return out.float().numpy(), aux.item(), keep.numpy()


# ----------------------------------------------------------------------
# The layer against JAX _moe_mlp
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(dtype):
    jcfg, pcfg = layer_config(dtype)
    h, lp = hidden(0), layer_weights(1, E)
    want, want_aux = jax_layer(h, lp, jcfg)
    got, aux, _ = port_layer(h, lp, pcfg)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def test_overflowing_expert_keeps_jax_tokens():
    """A forced router column sends almost every token to expert 2, whose
    queue holds cap = int(1.25 * 64 / 4) = 20: the tokens at places 20 and
    on drop. A dropped token's row is exactly 0 on both sides, so JAX's
    kept set is its non-zero rows; the port's must be the same set."""
    jcfg, pcfg = layer_config()
    h, lp = hidden(2), layer_weights(3, E, force=2)
    want, want_aux = jax_layer(h, lp, jcfg)
    got, aux, keep = port_layer(h, lp, pcfg)
    jax_kept = np.abs(want).max(-1) > 0
    assert 0 < (~jax_kept).sum() and keep.sum() <= 20 + 3 * 20
    assert np.array_equal(keep, jax_kept)
    assert np.array_equal(np.abs(got).max(-1) > 0, keep)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)


def test_route_holds_a_given_choice():
    """route's `choice` (chip_smoke.py phase 9 pins one attention path's
    routing onto the other's): the argmax itself changes nothing; another
    choice takes each token's probability of that expert and recounts
    the queues."""
    _, pcfg = layer_config()
    h, lp = torch.from_numpy(hidden(6)), layer_weights(7, E, force=1)
    router = torch.from_numpy(lp["router"])
    free = moe.route(h, router, pcfg)
    same = moe.route(h, router, pcfg, choice=free[0])
    for a, b in zip(free, same):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    other = (free[0] + 1) % E
    choice, gate, place, keep, _, cap = moe.route(h, router, pcfg, choice=other)
    probs = torch.softmax(h.reshape(-1, D) @ router, -1)
    assert torch.equal(choice, other)
    torch.testing.assert_close(gate, probs.gather(1, other[:, None])[:, 0])
    for e in range(E):
        mine = other == e
        assert torch.equal(place[mine], torch.arange(int(mine.sum())))
    assert torch.equal(keep, place < cap)


# ----------------------------------------------------------------------
# The MoE model against jax.value_and_grad(loss_fn)
# ----------------------------------------------------------------------

def _numpy_batch(seed=0, b=2, s=64):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, MOE["vocab_size"], size=(b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[1, s // 2:] = 0.0
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


@pytest.fixture(scope="module")
def model_ref():
    jcfg, _ = configs(remat=False)
    with jax.default_device(jax.devices("cpu")[0]):
        params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        batch = _numpy_batch()
        loss, grads = jax.value_and_grad(jax_model.loss_fn)(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            flatten_tree(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_model_matches_jax(model_ref, policy):
    """The loss (cross-entropy + 0.01 x the layers' mean aux) and every
    gradient, router and expert stacks included, under each remat policy
    (the JAX numbers are the same under every policy)."""
    params, batch, want_loss, want = model_ref
    _, pcfg = configs(remat=policy != "none",
                      remat_policy="full" if policy == "none" else policy)
    model = load_jax_params(pt_model.Transformer(pcfg, device="cpu"), params)
    loss = pt_model.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want) and "layers.router" in got
    for name in want:
        scale = np.abs(want[name]).max()
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_moe_param_shapes_specs_and_bridge():
    """param_shapes and param_specs carry the router and the expert stacks
    as the JAX init and param_specs do; the bridge refuses a dense tree for
    a MoE model."""
    jcfg, pcfg = configs()
    with jax.default_device(jax.devices("cpu")[0]):
        params = flatten_tree(jax.tree.map(np.asarray, jax_model.init_params(
            jcfg, jax.random.PRNGKey(0))))
        dense = jax_model.init_params(dataclasses.replace(jcfg, n_experts=0),
                                      jax.random.PRNGKey(0))
    assert {n: v.shape for n, v in params.items()} == pt_model.param_shapes(pcfg)
    jspecs = flatten_tree(jax_model.param_specs(jcfg))
    pspecs = pt_model.param_specs(pcfg)
    assert set(pspecs) == set(jspecs)
    for name, jspec in jspecs.items():
        assert pspecs[name] == tuple(() if e is None else (e,) if isinstance(e, str)
                                     else tuple(e) for e in jspec), name
    with pytest.raises(ValueError, match="missing \\['layers.router'\\]"):
        load_jax_params(pt_model.Transformer(pcfg, device="cpu"),
                        jax.tree.map(np.asarray, dense))


# ----------------------------------------------------------------------
# Expert parallelism on 4 ranks against JAX's sharded steps
# ----------------------------------------------------------------------

def _filled_by_earlier_ranks():
    """(h, lp) for the layer on expert=2,data=2 with 2 experts, 4 rows of 8
    (one row per rank): cap = int(1.25 * 32 / 2) = 20 and every token
    chooses expert 0, so ranks 0 and 1 take places 0-15, rank 2 keeps 4 of
    its 8 tokens and rank 3 none, though neither alone has more than 8."""
    return hidden(4, (4, 8, D)), layer_weights(5, 2, force=0)


@pytest.fixture(scope="module")
def ref():
    cpu = jax.devices("cpu")
    out = {}
    jcfg, _ = configs(remat=False)
    with jax.default_device(cpu[0]):
        for name, axes in CASES.items():
            mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(axes), cpu)
            opt = jax_train.make_optimizer(warmup_steps=1, total_steps=50)
            state = jax_train.init_train_state(jcfg, opt, jax.random.PRNGKey(0), mesh)
            out.setdefault("params", jax.tree.map(np.asarray, state.params))
            step = jax_train.make_train_step(jcfg, opt, mesh)
            steps = []
            for b in BATCHES:
                b = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                                   jax_mesh.batch_sharding(mesh))
                state, m = step(state, b)
                steps.append((float(m["loss"]), float(m["grad_norm"])))
            mu, nu, _ = adam_moments_from_jax(jax.tree.map(np.asarray, state.opt_state))
            full = {"params." + k: v for k, v in
                    flatten_tree(jax.tree.map(np.asarray, state.params)).items()}
            full.update({"mu." + k: v.numpy() for k, v in mu.items()})
            full.update({"nu." + k: v.numpy() for k, v in nu.items()})
            out[name] = {"steps": steps, "state": full}
    h, lp = _filled_by_earlier_ranks()
    out["filled"] = jax_layer(h, lp, layer_config(n_experts=2)[0])
    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("moe") / "ckpt")
    _, pcfg = configs(remat=False)
    h, lp = _filled_by_earlier_ranks()
    layer_cases = {"filled": ({"expert": 2, "data": 2}, layer_config(n_experts=2)[1], h, lp)}
    ranks = distributed.spawn(workers.moe_world, 4, (
        {name: (axes, pcfg) for name, axes in CASES.items()}, layer_cases, ref["params"],
        BATCHES, ckpt))
    return ranks, ckpt


@pytest.mark.parametrize("case", list(CASES))
def test_expert_parallel_steps_match_jax(ref, world, case):
    ranks, _ = world
    for out in ranks:
        np.testing.assert_allclose(out[case]["steps"], ref[case]["steps"], rtol=1e-5)
    _assert_state_close(ranks[0][case]["state"], ref[case]["state"])
    moved = np.abs(ranks[0][case]["state"]["params.layers.w1"] - ref["params"]["layers"]["w1"])
    assert moved.max() > 1e-4  # steps 2 and 3 moved the expert stacks


def test_tokens_drop_because_earlier_ranks_filled_the_expert(ref, world):
    ranks, _ = world
    want, want_aux = ref["filled"]
    kept = np.zeros(want.shape[:2], bool)
    for rank, out in enumerate(ranks):
        got = out["layer"]["filled"]
        where = got["where"]
        kept[where] = got["keep"]
        np.testing.assert_allclose(got["out"], want[where], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["aux"], want_aux, rtol=1e-6)
    assert np.array_equal(kept, np.abs(want).max(-1) > 0)
    assert kept.sum(1).tolist() == [8, 8, 4, 0]


def test_expert_checkpoint_restores_on_expert1(world):
    """Written on expert=2,data=2, restored unsharded (expert=1): every
    parameter and moment bit for bit, and the next step runs."""
    ranks, ckpt = world
    _, pcfg = configs(remat=False)
    restored = workers.restore(None, pcfg, ckpt, BATCHES[0])
    saved = ranks[0]["expert_data"]["state"]
    assert set(restored["state"]) == set(saved)
    for key in saved:
        assert np.array_equal(restored["state"][key], saved[key]), key
    assert restored["step"] == restored["count"] == 3 and np.isfinite(restored["loss"])
