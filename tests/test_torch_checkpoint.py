"""The port's Checkpointer (torch.distributed.checkpoint) against the JAX
package's (orbax), call for call, and its round trip of a TrainState.

The differential tests drive both through the same `save(step, force)`
calls and compare what each call returns, the steps each manager knows
(in its own order) and the directories on the disk, covering the cases of
tests/test_trainer.py's crash-safe overwrite test: a stale leftover swept,
recovery after a preemption between move-aside and save, a declined
overwrite put back.
"""

import os

import jax
import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu.trainer.checkpoint import Checkpointer as JaxCheckpointer
from training_operator_tpu_torch.trainer import train as pt_train
from training_operator_tpu_torch.trainer.checkpoint import Checkpointer, restore_into_mesh

from test_torch_model import configs, numpy_batch, torch_batch


@pytest.fixture(autouse=True)
def _pin_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture(scope="module")
def states():
    """A JAX and a port TrainState of the tiny config (the values do not
    matter to the save decisions)."""
    jcfg, pcfg = configs()
    with jax.default_device(jax.devices("cpu")[0]):
        jstate = jax_train.init_train_state(jcfg, jax_train.make_optimizer(), jax.random.PRNGKey(0))
    opt = pt_train.make_optimizer()
    return jstate, pt_train.init_train_state(pcfg, opt, device="cpu")


def _on_disk(directory):
    parent = os.path.dirname(directory)
    steps = sorted(int(n) for n in os.listdir(directory) if n.isdigit()) \
        if os.path.isdir(directory) else []
    stale = sorted(n.rsplit(".", 1)[1] for n in os.listdir(parent)
                   if n.startswith(os.path.basename(directory) + ".stale."))
    return steps, stale


class Pair:
    """The JAX and the port Checkpointer over sibling directories."""

    def __init__(self, root, states, **kw):
        self.jdir, self.pdir = str(root / "jax" / "ckpt"), str(root / "port" / "ckpt")
        self.kw = kw
        self.jstate, self.pstate = states
        self.open()

    def open(self):
        self.j = JaxCheckpointer(self.jdir, **self.kw)
        self.p = Checkpointer(self.pdir, **self.kw)
        self.check()

    def check(self):
        assert list(self.j.manager.all_steps()) == self.p.all_steps()
        assert self.j.latest_step() == self.p.latest_step()
        assert _on_disk(self.jdir) == _on_disk(self.pdir)

    def save(self, step, force):
        got = (self.j.save(self.jstate, step=step, force=force),
               self.p.save(self.pstate, step=step, force=force))
        assert got[0] == got[1], (step, force, got)
        self.check()
        return got[1]

    def close(self):
        self.j.close()
        self.p.close()


def test_overwrite_is_crash_safe_like_orbax(tmp_path, states):
    pair = Pair(tmp_path, states, max_to_keep=1)
    assert pair.save(0, force=True)
    # A leftover stale dir from an interrupted overwrite is swept, and the
    # overwrite itself succeeds.
    for d in (pair.jdir, pair.pdir):
        os.makedirs(d + ".stale.0")
    assert pair.save(0, force=True)
    assert _on_disk(pair.pdir) == ([0], [])
    # Preemption between move-aside and the replacement save: only the stale
    # copy remains; a fresh Checkpointer recovers it.
    for d in (pair.jdir, pair.pdir):
        os.rename(os.path.join(d, "0"), d + ".stale.0")
    pair.close()
    pair.open()
    assert _on_disk(pair.pdir) == ([0], []) and pair.p.latest_step() == 0
    pair.close()


def test_declined_overwrite_is_put_back_like_orbax(tmp_path, states):
    pair = Pair(tmp_path, states, save_interval_steps=5)
    assert pair.save(10, force=True)
    assert pair.save(12, force=True)
    assert pair.save(10, force=False) is False
    assert pair.p.all_steps() == [10, 12] and _on_disk(pair.pdir) == ([10, 12], [])
    pair.close()


@pytest.mark.parametrize("max_to_keep,interval", [(2, 3), (None, 1), (1, 2)])
def test_save_decisions_and_retention_like_orbax(tmp_path, states, max_to_keep, interval):
    """Unforced saves on and off the interval, at and below the latest step,
    forced saves below it (which retention then orders by save), and a
    reopened manager (which reads the disk in step order)."""
    pair = Pair(tmp_path, states, max_to_keep=max_to_keep, save_interval_steps=interval)
    for step, force in [(1, False), (2, False), (3, False), (3, False), (4, False),
                        (6, False), (5, False), (2, True), (6, True), (7, True),
                        (9, False), (8, False), (12, False)]:
        pair.save(step, force)
    pair.close()
    pair.open()
    for step, force in [(12, False), (13, False), (18, False), (4, True)]:
        pair.save(step, force)
    pair.close()


def _assert_state_equal(a, b):
    sa, sb = pt_train.state_dict(a), pt_train.state_dict(b)
    assert set(sa) == set(sb)
    for key in sa:
        assert sa[key].dtype == sb[key].dtype and sa[key].device == sb[key].device, key
        assert torch.equal(sa[key], sb[key]), key
    assert a.step == b.step and a.opt_state.count == b.opt_state.count


def test_round_trip_is_bitwise(tmp_path):
    _, pcfg = configs()
    opt = pt_train.make_optimizer(warmup_steps=1, total_steps=10)
    state = pt_train.init_train_state(pcfg, opt, device="cpu")
    step = pt_train.make_train_step(pcfg, opt, device="cpu")
    for i in range(3):
        state, _ = step(state, torch_batch(numpy_batch(20 + i)))
    ckpt = Checkpointer(str(tmp_path / "c"))
    assert ckpt.save(state) and ckpt.latest_step() == 3
    assert ckpt.step_bytes(3) > 3 * 4 * sum(p.numel() for p in state.model.parameters())
    template = pt_train.template_train_state(pcfg, opt, device="cpu")
    assert all(torch.all(p == 0) for p in template.model.parameters())
    restored = ckpt.restore(template)
    assert restored is template
    _assert_state_equal(restored, state)
    _assert_state_equal(restore_into_mesh(str(tmp_path / "c"), pcfg, opt, device="cpu"), state)
    # The restored state trains on exactly as the live one.
    batch = torch_batch(numpy_batch(30))
    _, m_live = step(state, batch)
    _, m_back = step(restored, batch)
    assert m_live["loss"].item() == m_back["loss"].item()


def test_restore_errors(tmp_path):
    _, pcfg = configs()
    opt = pt_train.make_optimizer()
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(
            pt_train.template_train_state(pcfg, opt, device="cpu"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        restore_into_mesh(str(tmp_path / "empty"), pcfg, opt, mesh=object(), device="cpu")
    state = pt_train.template_train_state(pcfg, opt, device="cpu")
    flat = pt_train.state_dict(state)
    flat.pop("count")
    with pytest.raises(ValueError, match="count"):
        pt_train.load_state_dict(state, flat)


def test_state_dict_covers_the_train_state():
    _, pcfg = configs()
    state = pt_train.init_train_state(pcfg, pt_train.make_optimizer(), device="cpu")
    flat = pt_train.state_dict(state)
    names = [n for n, _ in state.model.named_parameters()]
    assert set(flat) == {"step", "count"} | {f"{g}.{n}" for g in ("params", "mu", "nu")
                                             for n in names}
    assert flat["params.embed"].data_ptr() == state.model.embed.data_ptr()
    np.testing.assert_array_equal(flat["mu.layers.wq"].numpy(), 0)
