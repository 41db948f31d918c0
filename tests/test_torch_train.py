"""The port's train step (clip + AdamW + warmup-cosine) against the JAX
train step on the CPU: same initial parameters, same batches, three steps.

warmup_steps=1 makes step 1 run at lr 0 (the schedule is read before the
count increments) and steps 2-3 at the peak and then the cosine decay, so
the parameters really move; with the default warmup of 100 a short run
would compare parameters that barely moved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch.trainer import train as pt_train
from training_operator_tpu_torch.trainer.convert import adam_moments_from_jax, flatten_tree

from test_torch_model import configs, numpy_batch, port_model, torch_batch


@pytest.fixture(autouse=True)
def _pin_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _close(got, want, name):
    # rtol 1e-4; atol at 1e-4 of the leaf's largest entry for entries that
    # sit near zero (see test_torch_model).
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=name)


def test_three_steps_match_optax():
    jcfg, pcfg = configs()
    jopt = jax_train.make_optimizer(warmup_steps=1, total_steps=10)
    jstate = jax_train.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    jstep = jax_train.make_train_step(jcfg, jopt)

    popt = pt_train.make_optimizer(warmup_steps=1, total_steps=10)
    model = port_model(pcfg, jstate.params)
    pstate = pt_train.TrainState(step=0, model=model,
                                 opt_state=popt.init(dict(model.named_parameters())))
    pstep = pt_train.make_train_step(pcfg, popt, device="cpu")

    for i in range(3):
        batch = numpy_batch(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pm = pstep(pstate, torch_batch(batch))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert pm["step"] == int(jm["step"]) == i + 1

    exp_params = flatten_tree(jax.tree.map(np.asarray, jstate.params))
    mu, nu, count = adam_moments_from_jax(jax.tree.map(np.asarray, jstate.opt_state))
    assert count == pstate.opt_state.count == 3
    for name, p in pstate.params.items():
        _close(p.detach().numpy(), exp_params[name], name)
        _close(pstate.opt_state.mu[name].numpy(), mu[name].numpy(), "mu " + name)
        _close(pstate.opt_state.nu[name].numpy(), nu[name].numpy(), "nu " + name)
    # The step really moved the parameters.
    start = port_model(pcfg, jax_train.init_train_state(jcfg, jopt, jax.random.PRNGKey(0)).params)
    moved = max((p - q).abs().max().item()
                for p, q in zip(pstate.params.values(), start.parameters()))
    assert moved > 1e-4


@pytest.mark.parametrize("warmup,total", [(1, 10), (100, 10_000), (5, 20)])
def test_schedule_matches_optax(warmup, total):
    import optax

    exp = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1))
    got = pt_train.make_optimizer(warmup_steps=warmup, total_steps=total).schedule
    # optax evaluates the schedule in fp32, the port in Python floats.
    for count in (0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2, total, total + 5):
        np.testing.assert_allclose(got(count), float(exp(count)), rtol=1e-5, atol=1e-12)


def test_clip_scales_only_above_the_norm():
    opt = pt_train.make_optimizer(learning_rate=1.0, weight_decay=0.0, warmup_steps=1,
                                  total_steps=10, clip_norm=1.0)
    p = {"w": torch.zeros(4)}
    state = opt.init(p)
    opt.update({"w": torch.full((4,), 10.0)}, state, p)  # norm 20 -> clipped
    torch.testing.assert_close(state.mu["w"], torch.full((4,), 0.1 * 0.5))


def test_entry_points_need_the_card_by_default():
    _, pcfg = configs()
    opt = pt_train.make_optimizer()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_train.init_train_state(pcfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_train.make_train_step(pcfg, opt)


def test_example_batch_shapes():
    _, pcfg = configs()
    b = pt_train.make_example_batch(pcfg, 2, 16, device="cpu")
    assert b["tokens"].dtype == torch.int32 and tuple(b["tokens"].shape) == (2, 16)
    torch.testing.assert_close(b["targets"], torch.roll(b["tokens"], -1, dims=1))
    assert torch.all(b["mask"] == 1)
