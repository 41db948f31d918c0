"""The port's trainer loop against the JAX package on the CPU: the native
gather, the loader's native path, `train_loop` against the JAX train step
over the same batches, the trainer entry (auto-resume, export, the
multi-process refusal) and the graft entry."""

import itertools
import os

import jax
import numpy as np
import pytest
import torch

from training_operator_tpu.trainer import data as jax_data
from training_operator_tpu.trainer import train as jax_train
from training_operator_tpu_torch import export, graft_entry, native
from training_operator_tpu_torch.trainer import data as pt_data
from training_operator_tpu_torch.trainer import train as pt_train
from training_operator_tpu_torch.trainer.checkpoint import Checkpointer, restore_into_mesh
from training_operator_tpu_torch.trainer.convert import load_jax_params
from training_operator_tpu_torch.trainer.standalone import main, standalone_config, train_loop

from test_torch_model import BATCH, SEQ, configs, port_model


@pytest.fixture(autouse=True)
def _pin_cpu():
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def test_native_gather_equals_numpy():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 1 << 30, size=(97, 33)).astype(np.int32)
    for n in (1, 5, 64, 300):  # below and above the threaded cut-over
        idx = rng.randint(0, len(rows), size=n)
        np.testing.assert_array_equal(native.gather_rows(rows, idx), rows[idx])
    with pytest.raises(ValueError):
        native.gather_rows(rows, np.array([97]))
    with native.Prefetcher(rows) as pf:
        pf.submit(np.array([3, 1]))
        with pytest.raises(RuntimeError):
            pf.submit(np.array([0]))
        np.testing.assert_array_equal(pf.wait(), rows[[3, 1]])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_native_path_yields_the_same_batches(shuffle, drop_last):
    ds = pt_data.TokenDataset.synthetic(vocab_size=100, seq_len=16, num_rows=37, seed=3)
    kw = dict(batch_size=5, shuffle=shuffle, seed=7, drop_last=drop_last, device="cpu")
    on = pt_data.DataLoader(ds, use_native=True, **kw)
    off = pt_data.DataLoader(ds, use_native=False, **kw)
    assert on.use_native and not off.use_native
    jl = jax_data.DataLoader(jax_data.TokenDataset.synthetic(100, 16, 37, seed=3), batch_size=5,
                             shuffle=shuffle, seed=7, drop_last=drop_last, use_native=False)
    for epoch in range(2):
        a, b, c = list(on.epoch(epoch)), list(off.epoch(epoch)), list(jl.epoch(epoch))
        assert len(a) == len(b) == len(c) == (7 if drop_last else 8)
        for x, y, z in zip(a, b, c):
            for key in x:
                assert torch.equal(x[key], y[key])
                np.testing.assert_array_equal(x[key].numpy(), np.asarray(z[key]))


def test_native_required_raises_when_it_does_not_build(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", "RuntimeError: g++ failed: no compiler")
    assert not native.available() and "g++" in native.build_error()
    ds = pt_data.TokenDataset.synthetic(vocab_size=100, seq_len=16, num_rows=10)
    with pytest.raises(RuntimeError, match="native dataio"):
        pt_data.DataLoader(ds, batch_size=2, device="cpu", use_native=True)
    assert not pt_data.DataLoader(ds, batch_size=2, device="cpu").use_native


def _jax_and_port_states(steps):
    jcfg, pcfg = configs()
    jopt = jax_train.make_optimizer(warmup_steps=2, total_steps=steps)
    jstate = jax_train.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    popt = pt_train.make_optimizer(warmup_steps=2, total_steps=steps)
    model = port_model(pcfg, jstate.params)
    pstate = pt_train.TrainState(step=0, model=model,
                                 opt_state=popt.init(dict(model.named_parameters())))
    return (jcfg, jopt, jstate), (pcfg, popt, pstate)


def test_train_loop_matches_the_jax_step_over_20_batches(tmp_path):
    """From JAX's initial params, `train_loop` (native loader, prefetch,
    saves at 10 and 20, the forced final save) against the JAX train step
    on the same 20 batches (three epochs of 8 batches), fp32. The losses are
    held to rtol 1e-4, the tolerance of the three-step test
    (test_torch_train), which the twenty steps keep."""
    steps = 20
    (jcfg, jopt, jstate), (pcfg, popt, pstate) = _jax_and_port_states(steps)
    jds = jax_data.TokenDataset.synthetic(jcfg.vocab_size, SEQ, num_rows=BATCH * 8, seed=5)
    pds = pt_data.TokenDataset.synthetic(pcfg.vocab_size, SEQ, num_rows=BATCH * 8, seed=5)
    jloader = jax_data.DataLoader(jds, BATCH, use_native=False)
    ploader = pt_data.DataLoader(pds, BATCH, device="cpu", use_native=True)
    jstep = jax_train.make_train_step(jcfg, jopt)
    expected = []
    batches = itertools.chain.from_iterable(jloader.epoch(e) for e in itertools.count())
    for batch in itertools.islice(batches, steps):
        jstate, m = jstep(jstate, batch)
        expected.append(float(m["loss"]))
    got, lines = [], []
    pstep = pt_train.make_train_step(pcfg, popt, device="cpu")

    def step_fn(state, batch):
        state, metrics = pstep(state, batch)
        got.append(metrics["loss"].item())
        return state, metrics

    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    stats = train_loop(pcfg, popt, pstate, ploader, steps, ckpt, step_fn=step_fn,
                       log=lines.append)
    np.testing.assert_allclose(got, expected, rtol=1e-4)
    assert stats["done"] == stats["steps_run"] == pstate.step == steps
    assert stats["saves"] == 3 and ckpt.all_steps() == [10, 20]
    assert lines == [f"step {s} loss {got[s - 1]:.4f}" for s in (5, 10, 15, 20)]
    assert stats["data_s"] >= 0 and stats["ckpt_s"] > 0 and stats["wall_s"] > stats["ckpt_s"]


def _args(ckpt_dir, steps):
    return ["--steps", str(steps), "--seq-len", "32", "--batch-size", "2",
            "--checkpoint-dir", str(ckpt_dir), "--device", "cpu"]


def test_trainer_entry_resumes_and_exports_the_final_step(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    monkeypatch.delenv("MODEL_EXPORT_URI", raising=False)
    ckpt_dir = tmp_path / "ckpt"
    first = main(_args(ckpt_dir, 10))
    out = capsys.readouterr().out
    assert "resumed" not in out and "done at step 10" in out
    # Auto-resume restores the step-10 state bit for bit.
    config = standalone_config(32)
    restored = restore_into_mesh(str(ckpt_dir), config, pt_train.make_optimizer(), device="cpu")
    a, b = pt_train.state_dict(first), pt_train.state_dict(restored)
    assert all(torch.equal(a[k], b[k]) for k in a) and restored.step == 10

    export_dir = tmp_path / "model"
    monkeypatch.setenv("MODEL_EXPORT_URI", f"file://{export_dir}")
    final = main(_args(ckpt_dir, 12))
    out = capsys.readouterr().out
    assert "resumed at step 10" in out and "done at step 12" in out and final.step == 12
    assert sorted(n for n in os.listdir(ckpt_dir) if n.isdigit()) == ["10", "12"]
    step_dir = ckpt_dir / "12"
    assert {n: os.path.getsize(export_dir / n) for n in os.listdir(export_dir)} == \
        {n: os.path.getsize(step_dir / n) for n in os.listdir(step_dir)}


def test_trainer_entry_refuses_more_processes(tmp_path, monkeypatch):
    """More than one process needs the coordinator of the operator's env
    (tests/test_torch_dist.py runs two with it)."""
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError, match="missing COORDINATOR_ADDRESS"):
        main(_args(tmp_path / "ckpt", 2))


def test_export_providers(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.bin").write_bytes(b"xyz")
    assert export.upload(str(src), str(tmp_path / "plain")) == str(tmp_path / "plain")
    assert (tmp_path / "plain" / "a.bin").read_bytes() == b"xyz"
    for uri in ("gs://bucket/prefix", "ftp://host/path"):
        with pytest.raises(ValueError, match=repr(uri.split(":")[0])):
            export.upload(str(src), uri)


def test_graft_entry_matches_the_jax_entry():
    """The port's entry() on the JAX entry's parameters and batch: bf16
    compute on both sides, so the loss is held to 1e-3 relative, as in
    test_torch_model.test_loss_matches_bf16."""
    import __graft_entry__ as g

    jfn, (params, batch) = g.entry()
    expected = float(jax.jit(jfn)(params, batch))
    fn, (model, _) = graft_entry.entry(device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss = fn(model, tb).item()
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, expected, rtol=1e-3)


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1", "--checkpoint-dir", "unused"])
