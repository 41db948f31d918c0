"""The port's sequence parallelism (ring, Ulysses) against the JAX package's.

The JAX side runs in this process on virtual-device CPU meshes; the port
runs one world of 4 gloo processes (distributed.spawn, a file store) whose
rank bodies are in torch_mesh_workers.py (seq_world), and, for the
loopback ring, this process alone.

Tolerances: attention outputs atol 2e-5 (JAX's own ring test), gradients
atol 1e-5, all fp32. The sharded steps as in test_torch_mesh.py: loss and
grad norm rtol 1e-5; parameters, mu and nu after 3 steps rtol 1e-4, atol
1e-6. Ring against Ulysses in the port: rtol 1e-5 on the losses (JAX holds
its two to 2e-3, tests/test_trainer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from test_torch_mesh import B, BATCHES, ROWS, TINY, _assert_state_close, port_config
from training_operator_tpu.trainer import attention as jax_attention
from training_operator_tpu.trainer import mesh as jax_mesh
from training_operator_tpu.trainer import model as jax_model
from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch.trainer import attention as pt_attention
from training_operator_tpu_torch.trainer import distributed
from training_operator_tpu_torch.trainer import flash as pt_flash
from training_operator_tpu_torch.trainer.convert import adam_moments_from_jax, flatten_tree

# name -> (mesh axes, [B, S, H, D], impl, causal, seed); the JAX tests'
# shapes (tests/test_trainer.py TestRingAttention, TestUlyssesAttention).
CASES = {
    "ring_sequence4_causal": ({"sequence": 4}, (2, 32, 4, 8), "ring", True, 0),
    "ring_sequence4": ({"sequence": 4}, (2, 32, 4, 8), "ring", False, 0),
    "ring_sequence2_tensor2": ({"sequence": 2, "tensor": 2}, (2, 32, 4, 8), "ring", True, 1),
    "ring_data2_sequence2": ({"data": 2, "sequence": 2}, (4, 16, 4, 8), "ring", True, 2),
    "ulysses_causal": ({"sequence": 2, "tensor": 2}, (2, 64, 4, 16), "ulysses", True, 3),
    "ulysses": ({"sequence": 2, "tensor": 2}, (2, 64, 4, 16), "ulysses", False, 3),
}
SEQ_AXES = {"sequence": 2, "fsdp": 2}
IMPLS = ("ring", "ulysses")


def _jax_mesh(axes):
    return jax_mesh.build_mesh(jax_mesh.MeshSpec(axes), jax.devices("cpu"))


@pytest.fixture(scope="module")
def ref():
    """JAX: each attention case's output and gradients (of sum(out * dO)),
    then 3 sharded steps on sequence=2,fsdp=2 under ring and Ulysses."""
    out = {"attn": {}}
    with jax.default_device(jax.devices("cpu")[0]):
        for name, (axes, shape, impl, causal, seed) in CASES.items():
            mesh = _jax_mesh(axes)
            fn = jax_attention.ulysses_attention if impl == "ulysses" else \
                jax_attention.ring_attention
            q, k, v, do = (jnp.asarray(x) for x in workers.attention_inputs(seed, shape))
            o, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, mesh, causal=causal), q, k, v)
            out["attn"][name] = (np.asarray(o), [np.asarray(g) for g in vjp(do)])
        mesh = _jax_mesh(SEQ_AXES)
        for impl in IMPLS:
            jcfg = jax_model.TransformerConfig(**TINY, dtype=jnp.float32, remat=False,
                                               attn_impl=impl)
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
            out[impl] = {"steps": steps, "state": full}
    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("seq") / "ckpt")
    configs = {impl: port_config(remat=False, attn_impl=impl) for impl in IMPLS}
    ranks = distributed.spawn(workers.seq_world, 4, (CASES, configs, ref["params"], BATCHES,
                                                     ROWS, ckpt))
    return ranks, ckpt


# ----------------------------------------------------------------------
# Ring and Ulysses attention against JAX's, forward and gradients
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_attention_matches_jax(ref, world, case):
    ranks, _ = world
    want_out, want_grads = ref["attn"][case]
    for out in ranks:
        got = out["attn"][case]
        where = got["where"]
        np.testing.assert_allclose(got["out"], want_out[where], atol=2e-5)
        for name, g, w in zip(("dq", "dk", "dv"), got["grads"], want_grads):
            np.testing.assert_allclose(g, w[where], atol=1e-5, err_msg=name)


def test_ulysses_refuses_heads_that_do_not_split(world):
    ranks, _ = world
    for out in ranks:
        assert out["heads"] == ("ulysses needs heads (2) divisible by sequence x tensor "
                                "axis sizes (2 x 2)")


# ----------------------------------------------------------------------
# Training on sequence=2,fsdp=2
# ----------------------------------------------------------------------

def test_loader_splits_rows_and_positions(world):
    """On sequence=2,fsdp=2 rank (f, s) gets rows f and positions s of each
    global batch (the JAX batch_sharding, P(BATCH_AXES, "sequence")); the
    blocks tile the unsharded loader's batch. A sequence that does not
    split raises."""
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset

    ranks, _ = world
    whole = [b for _, b in zip(range(2), DataLoader(TokenDataset(ROWS), B, device="cpu"))]
    for i, batch in enumerate(whole):
        for name, t in batch.items():
            rows = [np.concatenate([ranks[2 * f + s]["loader"][i][name] for s in range(2)], 1)
                    for f in range(2)]
            assert np.array_equal(np.concatenate(rows, 0), t.numpy()), name
    for out in ranks:
        assert out["odd_sequence"] == ("sequence of 15 positions does not split over "
                                       "sequence=2")

@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_steps_match_jax(ref, world, impl):
    ranks, _ = world
    for out in ranks:
        np.testing.assert_allclose(out[impl]["steps"], ref[impl]["steps"], rtol=1e-5)
    _assert_state_close(ranks[0][impl]["state"], ref[impl]["state"])


def test_ring_and_ulysses_train_alike(world):
    ranks, _ = world
    np.testing.assert_allclose(ranks[0]["ring"]["steps"], ranks[0]["ulysses"]["steps"],
                               rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("policy,per_layer", [("full", 2), ("save_attn", 1),
                                              ("save_attn_qkv", 1)])
def test_remat_keeps_the_sequence_parallel_output(world, impl, policy, per_layer):
    """Under save_attn and save_attn_qkv the ring's and Ulysses' outputs
    are kept: one attention forward per layer per step (the ring's per-rank
    body, Ulysses' inner attention op), two under "full", whose recompute
    runs it again (JAX tests/test_trainer.py TestRematNames). The step is
    the same as without remat."""
    ranks, _ = world
    for out in ranks:
        calls, step = out["remat"][(impl, policy)]
        assert calls == per_layer * TINY["n_layers"]
        np.testing.assert_allclose(step, out["remat"][(impl, "none")][1], rtol=1e-5)


# ----------------------------------------------------------------------
# Checkpoint: written on sequence=2,fsdp=2, restored onto fsdp=4 and unsharded
# ----------------------------------------------------------------------

@pytest.mark.parametrize("target", ["fsdp=4", "unsharded"])
def test_sequence_checkpoint_restores_elsewhere(world, target):
    ranks, ckpt = world
    if target == "unsharded":
        restored = [workers.restore(None, port_config(remat=False, attn_impl="ring"), ckpt,
                                    BATCHES[0])]
    else:
        restored = [out["fsdp4"] for out in ranks]
    saved = ranks[0]["saved"]
    got = restored[0]["state"]
    assert set(got) == set(saved)
    for key in saved:
        assert np.array_equal(got[key], saved[key]), key
    for out in restored:
        assert out["step"] == out["count"] == 3
        np.testing.assert_allclose(out["loss"], ranks[0]["next"], rtol=1e-5)


# ----------------------------------------------------------------------
# The loopback ring: the per-rank body for NS ranks in one process
# ----------------------------------------------------------------------

def _split(x, ns):
    return [c.contiguous() for c in x.chunk(ns, 1)]


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_loopback_ring_matches_plain(ns, causal, monkeypatch):
    """The loopback ring equals the unsplit plain attention, forward and
    gradients (the CPU side of chip_smoke.py phase 8), and runs the block
    schedule: NS(NS+1)/2 forward, dq and dk/dv calls under a causal mask,
    NS of them causal (the diagonal), NS^2 without one."""
    q, k, v, do = (torch.from_numpy(x) for x in workers.attention_inputs(5, (2, 32, 4, 8)))
    calls = {name: [] for name in ("flash_fwd_plain", "flash_bwd_dq_plain",
                                   "flash_bwd_dkv_plain")}
    for name, got in calls.items():
        original = getattr(pt_flash, name)

        def wrapper(*args, _original=original, _got=got):
            _got.append(bool(args[-1]))
            return _original(*args)

        monkeypatch.setattr(pt_flash, name, wrapper)
    outs, lses, dqs, dks, dvs = pt_attention.ring_loopback(
        _split(q, ns), _split(k, ns), _split(v, ns), _split(do, ns), causal)
    monkeypatch.undo()
    blocks = ns * (ns + 1) // 2 if causal else ns * ns
    for name, got in calls.items():
        assert len(got) == blocks and sum(got) == (ns if causal else 0), name
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = pt_attention.plain_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(want, leaves, do)
    torch.testing.assert_close(torch.cat(outs, 1), want.detach(), atol=2e-5, rtol=0)
    _, want_lse = pt_flash.flash_fwd_plain(q, k, v, causal)
    got_lse = torch.cat([x.reshape(2, 4, -1) for x in lses], 2).reshape(want_lse.shape)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-5, rtol=0)
    for name, got, w in zip(("dq", "dk", "dv"), (dqs, dks, dvs), grads):
        torch.testing.assert_close(torch.cat(got, 1), w, atol=1e-5, rtol=0, msg=name)
