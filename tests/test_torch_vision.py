"""The port's vision family against the JAX package's, on the CPU.

The config of TestVisionFamily (image 16, convs of 8 and 16 channels,
dense 32). The same numpy inputs (random images, so neither square
symmetry nor a constant hides a wrong flatten order) go through
training_operator_tpu.trainer.vision and training_operator_tpu_torch's
vision.py, the parameters carried over by convert.vision_params_from_jax.

Tolerances, relative Frobenius norm (||port - jax|| / ||jax||) per tensor:
- fp32: 1e-5 on the logits, the loss, the gradients, and the parameters and
  momentum trace after 5 SGD steps (the same fp32 sums in another order);
- bf16: 2e-2 on the logits (both round the conv and dense inputs, weights
  and outputs to bf16, 2^-9 relative each, possibly at other places);
- the 4-rank world (data=2, fsdp=2, gloo) against JAX's single-device
  steps: 1e-5, as fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_workers as workers
from training_operator_tpu.trainer import vision as jax_vision
from training_operator_tpu_torch.trainer import distributed
from training_operator_tpu_torch.trainer import vision
from training_operator_tpu_torch.trainer.convert import (
    sgd_state_from_jax,
    vision_params_from_jax,
)
from training_operator_tpu_torch.trainer.train import SGD

SMALL = dict(image_size=16, channels=(8, 16), dense=32)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(dtype="fp32", **kw):
    jdt, pdt = DTYPES[dtype]
    return (jax_vision.VisionConfig(**{**SMALL, **kw}, dtype=jdt),
            vision.VisionConfig(**{**SMALL, **kw}, dtype=pdt))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_vision.init_vision_params(jcfg, jax.random.PRNGKey(seed)))


def port_params(tree):
    return {k: v.requires_grad_() for k, v in vision_params_from_jax(tree).items()}


def numpy_batch(seed, n=8, size=16):
    rng = np.random.RandomState(seed)
    return {"images": rng.randn(n, size, size, 1).astype(np.float32),
            "labels": rng.randint(0, 10, size=n).astype(np.int32)}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {"images": torch.tensor(batch["images"]),
            "labels": torch.tensor(batch["labels"]).long()}


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 2e-2)])
def test_forward_and_loss_match_jax(dtype, tol):
    jcfg, pcfg = configs(dtype)
    tree = jax_params(jcfg)
    batch = numpy_batch(0)
    want = np.asarray(jax_vision.vision_forward(tree, jnp.asarray(batch["images"]), jcfg))
    with torch.no_grad():
        got = vision.vision_forward(port_params(tree), to_torch(batch)["images"], pcfg)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    assert rel(got.numpy(), want) <= tol
    want_loss = float(jax_vision.vision_loss_fn(tree, to_jax(batch), jcfg))
    with torch.no_grad():
        got_loss = vision.vision_loss_fn(port_params(tree), to_torch(batch), pcfg).item()
    assert abs(got_loss - want_loss) <= tol * abs(want_loss)


def test_flatten_order_is_jax_nhwc():
    """The dense layer sees the pooled activations in (h, w, c) order: a
    w_dense that reads only one flattened position gives the JAX logits,
    and the same logits only if the port flattens as JAX does."""
    jcfg, pcfg = configs()
    tree = jax_params(jcfg)
    w = np.zeros_like(tree["w_dense"])
    w[5, :] = 1.0  # flattened position 5: (h 0, w 0, c 5) in NHWC, (c 0, h 1, w 1) in NCHW
    tree = {**tree, "w_dense": w}
    batch = numpy_batch(1)
    want = np.asarray(jax_vision.vision_forward(tree, jnp.asarray(batch["images"]), jcfg))
    with torch.no_grad():
        got = vision.vision_forward(port_params(tree), to_torch(batch)["images"], pcfg)
    assert rel(got.numpy(), want) <= 1e-5


def test_gradients_match_jax():
    jcfg, pcfg = configs()
    tree = jax_params(jcfg)
    batch = numpy_batch(2)
    want = vision_params_from_jax(jax.tree.map(
        np.asarray, jax.grad(jax_vision.vision_loss_fn)(tree, to_jax(batch), jcfg)))
    params = port_params(tree)
    loss = vision.vision_loss_fn(params, to_torch(batch), pcfg)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for name, g in grads.items():
        assert rel(g.numpy(), want[name].numpy()) <= 1e-5, name


def test_sgd_matches_optax_on_random_tensors():
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    opt = optax.sgd(0.1, momentum=0.9)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    params = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    sgd = SGD(0.1, momentum=0.9)
    state = sgd.init(params)
    for i in range(5):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}
        upd, js = opt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = optax.apply_updates(jp, upd)
        sgd.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, params)
        if i == 0:  # the first trace is the gradient itself
            np.testing.assert_array_equal(state.trace["a"].numpy(), grads["a"])
    for k in tree:
        assert rel(params[k].numpy(), np.asarray(jp[k])) <= 1e-6
        assert rel(state.trace[k].numpy(), np.asarray(js[0].trace[k])) <= 1e-6


def test_five_sgd_momentum_steps_match_optax():
    jcfg, pcfg = configs()
    tree = jax_params(jcfg)
    jb = jax_vision.synthetic_mnist(jax.random.PRNGKey(1), 64, jcfg)
    batch = {k: np.asarray(v) for k, v in jb.items()}
    opt = optax.sgd(0.1, momentum=0.9)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    jstep = jax_vision.make_vision_train_step(jcfg, opt)
    sgd = SGD(0.1, momentum=0.9)
    params = port_params(tree)
    state = sgd.init(params)
    step = vision.make_vision_train_step(pcfg, sgd, device="cpu")
    for _ in range(5):
        jp, js, jm = jstep(jp, js, jb)
        params, state, m = step(params, state, to_torch(batch))
        assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert m["accuracy"].item() == pytest.approx(float(jm["accuracy"]), abs=1e-7)
    want = vision_params_from_jax(jax.tree.map(np.asarray, jp))
    want_trace = sgd_state_from_jax(jax.tree.map(np.asarray, js)).trace
    for name in want:
        assert rel(params[name].detach().numpy(), want[name].numpy()) <= 1e-5, name
        assert rel(state.trace[name].numpy(), want_trace[name].numpy()) <= 1e-5, name


def test_weight_bridge_layout():
    jcfg, pcfg = configs()
    tree = jax_params(jcfg)
    params = vision_params_from_jax(tree)
    assert {n: tuple(p.shape) for n, p in params.items()} == vision.param_shapes(pcfg)
    # HWIO [kh, kw, i, o] -> OIHW [o, i, kh, kw]
    assert params["conv2"][3, 5, 0, 2].item() == tree["conv2"][0, 2, 5, 3]
    np.testing.assert_array_equal(params["w_dense"].numpy(), tree["w_dense"])
    with pytest.raises(ValueError, match="trace"):
        sgd_state_from_jax((object(),))


def test_init_matches_jax_shapes_and_scale():
    jcfg, pcfg = configs()
    params = vision.init_vision_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    want = vision_params_from_jax(jax_params(jcfg))
    for name, p in params.items():
        assert p.shape == want[name].shape and p.dtype == torch.float32 and p.requires_grad
        if name.startswith("b"):
            assert not p.any()
    # He normal over the fan-in 3 x 3 x 8 of conv2.
    assert params["conv2"].std().item() == pytest.approx((2.0 / 72) ** 0.5, rel=0.1)


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "default"])
def test_synthetic_patch_mask_equals_jax(kw):
    """Given JAX's labels, the port's patch is JAX's (its images less JAX's
    own noise), exactly."""
    jcfg = jax_vision.VisionConfig(**kw)
    pcfg = vision.VisionConfig(**kw)
    key = jax.random.PRNGKey(1)
    jb = jax_vision.synthetic_mnist(key, 64, jcfg)
    _, k_noise = jax.random.split(key)
    noise = 0.1 * jax.random.normal(
        k_noise, (64, jcfg.image_size, jcfg.image_size, jcfg.in_channels), jnp.float32)
    want = np.asarray(jb["images"] - noise) > 0.5
    labels = torch.tensor(np.asarray(jb["labels"])).long()
    got = vision.digit_patches(labels, pcfg)
    np.testing.assert_array_equal(got.numpy() > 0.5, want)
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    out = vision.synthetic_mnist(torch.Generator().manual_seed(1), 64, pcfg)
    assert out["images"].shape == (64, pcfg.image_size, pcfg.image_size, 1)
    assert out["labels"].dtype == torch.int64
    noise = out["images"] - vision.digit_patches(out["labels"], pcfg)
    assert noise.std().item() == pytest.approx(0.1, rel=0.1)


def test_learns_synthetic_digits():
    """TestVisionFamily.test_learns_synthetic_digits on the port: bf16, batch
    64, above 0.9 accuracy within 40 steps."""
    _, pcfg = configs("bf16")
    out = vision.train_synthetic(pcfg, steps=40, batch=64, device="cpu", log=lambda _: None)
    assert out["accuracies"][-1] > 0.9, out["accuracies"]
    assert np.isfinite(out["losses"]).all()
    assert "step_ms" not in out


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, pcfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.init_vision_params(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.make_vision_train_step(pcfg, SGD())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.main([])


def test_step_refuses_a_batch_on_another_device():
    _, pcfg = configs()
    step = vision.make_vision_train_step(pcfg, SGD(), device="meta")
    with pytest.raises(ValueError, match="batch on cpu"):
        step({}, None, to_torch(numpy_batch(0)))


def test_data_parallel_world_matches_single_device_jax():
    """data=2,fsdp=2 as 4 gloo ranks: the loss of the global batch, the
    summed gradients and 3 steps equal JAX's single-device ones
    (TestVisionFamily.test_data_parallel_matches_single_device). Then, in
    the same world, data=2,tensor=2: the tensor peers compute the same rows
    and the same steps."""
    jcfg, pcfg = configs()
    tree = jax_params(jcfg)
    jb = jax_vision.synthetic_mnist(jax.random.PRNGKey(1), 64, jcfg)
    batch = {k: np.asarray(v) for k, v in jb.items()}
    want_loss = float(jax_vision.vision_loss_fn(tree, jb, jcfg))
    want_grads = vision_params_from_jax(jax.tree.map(
        np.asarray, jax.grad(jax_vision.vision_loss_fn)(tree, jb, jcfg)))
    opt = optax.sgd(0.1, momentum=0.9)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    jstep = jax_vision.make_vision_train_step(jcfg, opt)
    want_metrics = []
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jb)
        want_metrics.append((float(jm["loss"]), float(jm["accuracy"])))
    want = vision_params_from_jax(jax.tree.map(np.asarray, jp))
    want_trace = sgd_state_from_jax(jax.tree.map(np.asarray, js)).trace

    meshes = [{"data": 2, "fsdp": 2}, {"data": 2, "tensor": 2}]
    worlds = distributed.spawn(workers.vision_world, 4, (meshes, pcfg, tree, batch, 3))
    for out in (o for w in worlds for o in w):
        assert abs(out["loss0"] - want_loss) <= 1e-5 * abs(want_loss)
        for (loss, acc), (w_loss, w_acc) in zip(out["metrics"], want_metrics):
            assert abs(loss - w_loss) <= 1e-5 * abs(w_loss)
            assert acc == pytest.approx(w_acc, abs=1e-7)
        for name in want:
            assert rel(out["params"][name], want[name].numpy()) <= 1e-5, name
            assert rel(out["trace"][name], want_trace[name].numpy()) <= 1e-5, name
    # vision_loss_fn's backward leaves each rank its rows' share: the
    # shares sum to the global gradient.
    # On data=2,tensor=2 ranks 0 and 1 (tensor peers) hold the first half
    # of the rows, 2 and 3 the second: one of each sums to the whole.
    for i, ranks in enumerate(([0, 1, 2, 3], [0, 2])):
        for name in want_grads:
            total = sum(worlds[r][i]["grads0"][name] for r in ranks)
            assert rel(total, want_grads[name].numpy()) <= 1e-5, (meshes[i], name)
    np.testing.assert_array_equal(worlds[0][1]["grads0"]["conv1"],
                                  worlds[1][1]["grads0"]["conv1"])
    # 6 rows do not split over data=2,fsdp=2's 4 batch shards; over
    # data=2,tensor=2's 2 they do.
    assert all("does not split over the batch axes" in w[0]["refusal"] for w in worlds)
    assert all(w[1]["refusal"] is None for w in worlds)
