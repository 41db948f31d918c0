"""The port's sharded trainer against the JAX package's, on the CPU.

A tiny config (vocab 256, d_model 128, 2 layers, 8 heads over 4 kv heads,
d_ff 256, seq 32, batch 4) in fp32. The JAX side runs in this process on a
virtual-device mesh fsdp=2,tensor=2 (its sharded step, train.py:129-153);
the port runs the same mesh as 4 gloo processes (distributed.spawn, a file
store, so parallel test workers never race for a port), from the JAX
parameters carried over as numpy. The rank bodies are in
torch_mesh_workers.py, which imports no JAX.

Tolerances: loss and grad norm rtol 1e-5 (the same fp32 sums in another
order); parameters, mu and nu after 3 steps rtol 1e-4, atol 1e-6 (Adam
divides by sqrt(nu), which magnifies the last bits of a small gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_mesh_workers as workers
from training_operator_tpu.trainer import mesh as jax_mesh
from training_operator_tpu.trainer import model as jax_model
from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch.trainer import distributed
from training_operator_tpu_torch.trainer.convert import adam_moments_from_jax, flatten_tree
from training_operator_tpu_torch.trainer.mesh import AXIS_ORDER, MeshSpec, build_mesh
from training_operator_tpu_torch.trainer.model import (
    TransformerConfig,
    loss_fn,
    param_placements,
    param_specs,
)

TINY = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=256, max_seq_len=32)
B, S = 4, 32
AXES = {"fsdp": 2, "tensor": 2}
CONFIGS = {"plain": dict(remat=False),
           "save_attn_qkv": dict(remat=True, remat_policy="save_attn_qkv", remat_head=True)}


def numpy_batch(seed, zeros=(0, 0, 0, 0)):
    """A global batch; row i's mask zeroes its last zeros[i] positions."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, TINY["vocab_size"], size=(B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    for i, z in enumerate(zeros):
        mask[i, S - z:] = 0.0
    return {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": mask}


BATCHES = [numpy_batch(10 + i, zeros=(0, 5, 9, 0)) for i in range(3)]
# Rank rows {0, 1} and {2, 3} (fsdp=2): 61 positions count on rank 0, 3 on
# rank 2, so the mean of the two ranks' own means is far from the global one.
MASK_BATCH = numpy_batch(20, zeros=(3, 0, 31, 30))
ROWS = np.random.RandomState(3).randint(0, 256, size=(24, S + 1)).astype(np.int32)


def port_config(**kw):
    return TransformerConfig(**TINY, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def ref():
    """The JAX sharded run: initial parameters and their shards per device,
    then 3 steps under each config."""
    cpu = jax.devices("cpu")
    out = {}
    with jax.default_device(cpu[0]):
        mesh = jax_mesh.build_mesh(jax_mesh.MeshSpec(AXES), cpu)
        for name, kw in CONFIGS.items():
            jcfg = jax_model.TransformerConfig(**TINY, dtype=jnp.float32, **kw)
            opt = jax_train.make_optimizer(warmup_steps=1, total_steps=50)
            state = jax_train.init_train_state(jcfg, opt, jax.random.PRNGKey(0), mesh)
            if name == "plain":
                out["params"] = jax.tree.map(np.asarray, state.params)
                devices = list(mesh.devices.flat)  # rank r sits where device r does
                out["shards"] = {
                    pname: {devices.index(s.device): np.asarray(s.data)
                            for s in leaf.addressable_shards}
                    for pname, leaf in flatten_tree(state.params).items()
                }
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
        jcfg = jax_model.TransformerConfig(**TINY, dtype=jnp.float32)
        out["mask_loss"] = float(jax_model.loss_fn(
            out["params"], {k: jnp.asarray(v) for k, v in MASK_BATCH.items()}, jcfg))
    return out


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """The port's run on 4 ranks (one world; see torch_mesh_workers.world)."""
    ckpt = str(tmp_path_factory.mktemp("remesh") / "ckpt")
    configs = {name: port_config(**kw) for name, kw in CONFIGS.items()}
    ranks = distributed.spawn(workers.world, 4, (AXES, configs, ref["params"], BATCHES,
                                                 MASK_BATCH, ROWS, ckpt))
    return ranks, ckpt


def _assert_state_close(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)


# ----------------------------------------------------------------------
# MeshSpec and build_mesh: the JAX wire format and factorization, no fallback
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s", ["data=2,fsdp=2,tensor=2", " fsdp=4 , tensor=2", "",
                               "pipeline=2,expert=2,tensor=2", "sequence=4"])
def test_mesh_spec_parses_like_jax(s):
    got, want = MeshSpec.from_string(s), jax_mesh.MeshSpec.from_string(s)
    assert got.dims() == want.dims() and got.size() == want.size()
    assert AXIS_ORDER == jax_mesh.AXIS_ORDER


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_for_devices_matches_jax(n):
    assert MeshSpec.for_devices(n).dims() == jax_mesh.MeshSpec.for_devices(n).dims()


def test_param_specs_are_the_jax_table():
    """The port's specs, tensor dim by tensor dim, equal the JAX
    PartitionSpecs (model.py:103-136), and the DTensor placements follow
    them: Shard(d) on each mesh axis that shards dim d."""
    jspecs = flatten_tree(jax_model.param_specs(jax_model.TransformerConfig(**TINY)))
    pspecs = param_specs(port_config())
    assert set(pspecs) == set(jspecs)
    for name, jspec in jspecs.items():
        want = tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e)
                     for e in jspec)
        assert pspecs[name] == want, name
        placements = param_placements(name)
        for i, axis in enumerate(AXIS_ORDER):
            dims = [d for d, axes in enumerate(want) if axis in axes]
            assert placements[i] == (Shard(dims[0]) if dims else Replicate()), (name, axis)


@pytest.mark.parametrize("axes,item", [({"pipeline": 2, "sequence": 2}, 12)])
def test_mesh_refuses_axes_not_ported(axes, item):
    """pipeline excludes sequence (ROADMAP item 12), as the JAX pipeline
    does (pipeline.py:56-60); the port refuses the mesh itself."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_mesh(MeshSpec(axes), "cpu")


def test_mesh_refuses_what_the_world_cannot_fill():
    with pytest.raises(ValueError, match="unknown mesh axis"):
        MeshSpec({"model": 2})
    with pytest.raises(ValueError, match="needs 2 processes, the world has 1"):
        build_mesh(MeshSpec({"fsdp": 2}), "cpu")


# ----------------------------------------------------------------------
# fsdp=2,tensor=2 on 4 ranks against JAX's sharded step
# ----------------------------------------------------------------------

def test_local_shards_equal_the_jax_shards(ref, world):
    ranks, _ = world
    for rank, out in enumerate(ranks):
        want = {"pipeline": 0, "data": 0, "fsdp": rank // 2, "expert": 0, "sequence": 0,
                "tensor": rank % 2}
        assert out["coords"] == want
        assert set(out["shards"]) == set(ref["shards"])
        for name, shard in out["shards"].items():
            expected = ref["shards"][name][rank]
            assert shard.shape == expected.shape, name
            assert np.array_equal(shard, expected), name


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_steps_match_jax(ref, world, config):
    ranks, _ = world
    for out in ranks:  # the global loss and norm on every rank
        np.testing.assert_allclose(out[config]["steps"], ref[config]["steps"], rtol=1e-5)
    _assert_state_close(ranks[0][config]["state"], ref[config]["state"])
    moved = max(np.abs(ranks[0][config]["state"]["params." + n] - ref["params"][n]).max()
                for n in ("embed", "lm_head"))
    assert moved > 1e-4  # steps 2 and 3 ran at a real learning rate


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sharded_matches_the_single_process_port(ref, world, config):
    ranks, _ = world
    pcfg = port_config(**CONFIGS[config])
    state = workers.sharded_state(pcfg, ref["params"], None)
    steps = workers.train(state, pcfg, BATCHES)
    np.testing.assert_allclose(ranks[0][config]["steps"], steps, rtol=1e-5)
    _assert_state_close(ranks[0][config]["state"], workers.gathered(state))


def test_sharded_init_holds_only_the_shards(world):
    """init_train_state and template_train_state on the mesh allocate the
    rank's shards (parameters, mu and nu) and at most one whole parameter
    besides, never the whole model (the JAX init into its shards); the
    sharded init is the unsharded init's shards."""
    ranks, _ = world
    for out in ranks:
        init = out["init"]
        bound = 3 * init["shards"] + init["largest"]
        assert init["init"] <= bound, init
        assert init["template"] <= bound, init
        assert init["equal"]


def test_uneven_mask_loss_is_the_global_masked_mean(ref, world):
    ranks, _ = world
    model = workers.sharded_state(port_config(), ref["params"], None).model
    with torch.no_grad():
        batch = {k: torch.from_numpy(v) for k, v in MASK_BATCH.items()}
        single = loss_fn(model, batch).item()
    for out in ranks:
        np.testing.assert_allclose(out["mask_loss"], single, rtol=1e-5)
        np.testing.assert_allclose(out["mask_loss"], ref["mask_loss"], rtol=1e-5)
    # The mean of the two batch shards' own means is another number.
    with torch.no_grad():
        halves = [loss_fn(model, {k: v[i:i + 2] for k, v in batch.items()}).item()
                  for i in (0, 2)]
    assert abs(np.mean(halves) - single) > 1e-3


def test_loader_tensor_peers_share_rows_and_cover_the_batch(world):
    ranks, _ = world
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset

    whole = [b["tokens"].numpy() for _, b in
             zip(range(2), DataLoader(TokenDataset(ROWS), B, device="cpu"))]
    for i in range(2):
        for f in range(2):  # ranks 2f and 2f+1 differ in tensor only
            assert np.array_equal(ranks[2 * f]["loader"][i], ranks[2 * f + 1]["loader"][i])
        got = np.concatenate([ranks[0]["loader"][i], ranks[2]["loader"][i]])
        assert np.array_equal(got, whole[i])


def test_refusals_on_the_mesh(world):
    ranks, _ = world
    for out in ranks:
        assert out["refusals"] == {
            "heads": "n_kv_heads=1 does not split over tensor=2",
            "drop_last": "drop_last=False is incompatible with a sharded mesh",
            "loader_batch": "batch_size 3 does not split over the batch axes "
                            "('data', 'fsdp', 'expert') (2 shards)",
            "batch": "batch of 3 rows does not split over the batch axes "
                     "('data', 'fsdp', 'expert') (2 shards)",
        }


def test_checkpoint_decisions_under_the_process_group(ref, world, tmp_path):
    """Every rank takes the single-process Checkpointer's decisions on the
    same save calls, and the disk ends the same: rank 0 renames, deletes
    and puts back, the others wait at its barriers."""
    import os

    ranks, ckpt = world
    state = workers.sharded_state(port_config(), ref["params"], None)
    single = workers.checkpoint_calls(state, str(tmp_path / "ckpt"))
    for out in ranks:
        assert out["ckpt_calls"] == single
    listing = sorted(os.listdir(ckpt + "-calls"))
    assert listing == sorted(os.listdir(tmp_path / "ckpt")) == ["4", "6"]
    assert not [n for n in os.listdir(os.path.dirname(ckpt)) if ".stale." in n]


# ----------------------------------------------------------------------
# Re-mesh restore: saved on fsdp=2,tensor=2, restored on fsdp=2 and unsharded
# ----------------------------------------------------------------------

@pytest.mark.parametrize("target", ["fsdp=2", "unsharded"])
def test_remesh_restore(world, target):
    ranks, ckpt = world
    pcfg = port_config()
    if target == "unsharded":
        restored = [workers.restore(None, pcfg, ckpt, BATCHES[0])]
    else:
        restored = distributed.spawn(workers.restore, 2,
                                     ({"fsdp": 2}, pcfg, ckpt, BATCHES[0]))
    saved = ranks[0]["saved"]
    got = restored[0]["state"]
    assert set(got) == set(saved)
    for key in saved:
        assert np.array_equal(got[key], saved[key]), key
    for out in restored:
        assert out["step"] == out["count"] == 3
        np.testing.assert_allclose(out["loss"], ranks[0]["next"], rtol=1e-5)


def test_step_refuses_a_state_on_another_mesh(ref):
    pcfg = port_config()
    state = workers.sharded_state(pcfg, ref["params"], None)
    step = workers.make_train_step(pcfg, workers.optimizer(), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="mesh is not the step's"):
        step(state, {k: torch.from_numpy(v) for k, v in BATCHES[0].items()})
