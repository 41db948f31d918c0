"""The plain reference against the port's plain path, at a tiny size on the
CPU, both in fp32: the same loss, gradients and AdamW steps."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import families, inputs, reference
from benchmark.tiny import REPO

DIMS = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=96,
            max_seq_len=64, rope_theta=1e6)
# The port's RMSNorm eps, which its norms take from no config.
PLAIN = reference.Numerics(1e-6)
DECODER = families.load(REPO, "decoder")
OPT = {"learning_rate": 3e-4, "weight_decay": 0.01, "warmup_steps": 0,
       "total_steps": 100000, "clip_norm": 1.0}


def _port(seed, remat_policy="save_attn_qkv"):
    from training_operator_tpu_torch.trainer.model import TransformerConfig
    from training_operator_tpu_torch.trainer.train import AdamW, template_train_state

    cfg = TransformerConfig(**DIMS, dtype=torch.float32, remat=True, remat_policy=remat_policy,
                            remat_head=True, attn_impl="xla")
    opt = AdamW(**OPT)
    state = template_train_state(cfg, opt, "cpu")
    for n, p in state.model.named_parameters():
        inputs.fill_leaf(p.data, DECODER, DIMS, n, seed)
    return cfg, opt, state


def _batches(seed, n, batch=2, seq=24):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, DIMS["vocab_size"], size=(n, batch, seq + 1))
    return [(r[:, :-1], r[:, 1:]) for r in rows]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_loss_and_gradients_match_the_port(seed):
    from training_operator_tpu_torch.trainer.model import loss_fn

    cfg, _, state = _port(seed)
    (tok, tgt), = _batches(seed, 1)
    batch = {"tokens": torch.as_tensor(tok, dtype=torch.int32),
             "targets": torch.as_tensor(tgt, dtype=torch.int32),
             "mask": torch.ones(tok.shape)}
    port_loss = loss_fn(state.model, batch, cfg)
    port_loss.backward()
    shapes = DECODER.param_shapes(DIMS)
    params = {n: inputs.initial_leaf(s, DECODER, DIMS, n, seed, "cpu").requires_grad_()
              for n, s in shapes.items()}
    ref_loss = DECODER.loss(params, torch.as_tensor(tok), torch.as_tensor(tgt), DIMS,
                              PLAIN)
    ref_loss.backward()
    assert abs(float(port_loss.detach()) - float(ref_loss.detach())) < 1e-5
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p.grad, params[n].grad, rtol=1e-4, atol=1e-6)


def test_three_steps_match_the_port():
    from training_operator_tpu_torch.trainer.train import make_train_step

    seed = 5
    cfg, opt, state = _port(seed)
    step = make_train_step(cfg, opt, "cpu")
    batches = _batches(seed, 3)
    losses, norms = [], []
    for tok, tgt in batches:
        state, m = step(state, {"tokens": torch.as_tensor(tok, dtype=torch.int32),
                                "targets": torch.as_tensor(tgt, dtype=torch.int32),
                                "mask": torch.ones(tok.shape)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ref = reference.run_steps(DECODER, DIMS, OPT, seed, batches, "cpu", PLAIN)
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(norms, ref["grad_norm"], rtol=1e-4)
    for n, p in state.model.named_parameters():
        moved = float(torch.linalg.vector_norm(
            p.detach() - inputs.initial_leaf(p.shape, DECODER, DIMS, n, seed, "cpu")))
        assert moved == pytest.approx(ref["change_leaf"][n], rel=1e-3)


def test_schedule_is_the_ports():
    from training_operator_tpu_torch.trainer.train import warmup_cosine_decay

    for opt in (OPT, dict(OPT, warmup_steps=10, total_steps=50)):
        ours = [reference.learning_rate(opt, c) for c in range(60)]
        port = warmup_cosine_decay(0.0, opt["learning_rate"], opt["warmup_steps"],
                                   max(opt["total_steps"], opt["warmup_steps"] + 1))
        np.testing.assert_allclose(ours, [port(c) for c in range(60)], rtol=1e-12, atol=1e-15)


def test_control_rounds_each_product():
    x = torch.randn(4096) * 3
    q = reference._RoundFP8.apply(x)
    # e4m3 keeps 3 mantissa bits: relative steps of 2^-4 at most near the
    # top of the range, and a few distinct values per octave.
    assert 0 < float((q - x).abs().max() / x.abs().max()) < 2 ** -3
    assert len(torch.unique(q)) < 256
    t = reference._RoundTF32.apply(x)
    assert float(((t - x) / x).abs().max()) <= 2 ** -11
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("name", ["mistral7b_v03_stage8", "internlm2_1p8b"])
def test_numerics_come_from_the_config(name):
    """The plain reference runs at the eps the configuration states it is
    run at, and its control rounds as the configuration's `run.control`
    names, so a configuration of another precision brings its control as
    data."""
    import json

    run = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())["run"]
    plain, control = reference.numerics(run), reference.numerics(run, control=True)
    assert plain.eps == control.eps == 1e-6
    x = torch.randn(256) * 3
    assert torch.equal(plain.body(x), x) and torch.equal(plain.head(x), x)
    assert torch.equal(control.body(x), reference._RoundFP8.apply(x))
    assert torch.equal(control.head(x), reference._RoundTF32.apply(x))
    fp32 = reference.numerics(dict(run, control={"body": "tf32", "head": "tf32"}), control=True)
    assert torch.equal(fp32.body(x), reference._RoundTF32.apply(x))


def test_reference_batches_follow_the_loader():
    """The reference works out the DataLoader's batches again from the
    stream: the port's loader must yield the same rows."""
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset, pack_tokens

    mix = {"batch": 2, "seq": 16, "batches": 5}
    stream = np.arange(5 * 2 * 17 + 3, dtype=np.int32)
    loader = DataLoader(TokenDataset(pack_tokens(stream, 16)), 2, shuffle=True, seed=77,
                        device="cpu")
    ours = inputs.reference_batches(stream, mix, 77, 5)
    for (tok, tgt), got in zip(ours, loader.epoch(0)):
        assert (got["tokens"].numpy() == tok).all() and (got["targets"].numpy() == tgt).all()


def test_program_fp32_matches_reference_through_the_harness():
    """The harness's own first steps (run.first_steps) in fp32 read gaps at
    rounding level against the reference: the comparison itself adds
    nothing."""
    from benchmark import check, spec, traffic
    from benchmark.run import Program, first_steps, to_floats
    from benchmark.tiny import CELL, make_root

    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        cell = spec.load_cell(make_root(Path(tmp)), CELL)
        cell.config["run"]["dtype"] = "float32"
        prog_obj = Program(cell, 9, torch.device("cpu"))
        prog = to_floats(first_steps(prog_obj, cell, 9, 3))
        batches = inputs.reference_batches(prog_obj.stream, cell.traffic,
                                           traffic.shuffle_seed(9), 3)
        ref = reference.run_steps(cell.family, cell.dims, cell.run["optimizer"], 9,
                                  batches, "cpu", reference.numerics(cell.run))
        prog_obj.close()
    g = check.gaps(prog, ref)
    assert max(g.values()) < 1e-4, g


@pytest.mark.parametrize("policy", ["save_attn_qkv", "full"])
def test_remat_policy_does_not_change_the_port(policy):
    """The reference knows no remat policy: the port's policies give the same
    numbers (so the reference stands for the configuration's)."""
    from training_operator_tpu_torch.trainer.model import loss_fn

    cfg, _, state = _port(4, policy)
    cfg = dataclasses.replace(cfg, remat_policy=policy)
    (tok, tgt), = _batches(4, 1)
    batch = {"tokens": torch.as_tensor(tok, dtype=torch.int32),
             "targets": torch.as_tensor(tgt, dtype=torch.int32), "mask": torch.ones(tok.shape)}
    params = {n: inputs.initial_leaf(s, DECODER, DIMS, n, 4, "cpu")
              for n, s in DECODER.param_shapes(DIMS).items()}
    ref = DECODER.loss(params, torch.as_tensor(tok), torch.as_tensor(tgt), DIMS,
                         PLAIN)
    assert abs(float(loss_fn(state.model, batch, cfg)) - float(ref)) < 1e-5
