"""The port's OLMoE model (the dropless top-k MoE layer of trainer/moe.py,
qk-norm and `rms_norm_eps` in trainer/model.py) on the CPU, against the
benchmark's plain reference of the family (benchmark/families/olmoe.py), a
per-token loop over the chosen experts and transformers'
load-balancing formula; and the dense and switch configurations' losses
bit for bit as they were before the dropless layer existed.

Tolerances, all in fp32: the layer against the per-token loop rtol 1e-5
(the same products, summed in another order); the model's loss against the
reference rtol 1e-6 and every gradient rtol 1e-5 of the leaf's norm (one
model in another summation order: the reference's blocked attention and
head, its experts' rows in another grouping); the parameters after one
AdamW step rtol 1e-5 (the update divides by sqrt(nu) + eps, so a
gradient's last bits reach it); the pooled aux rtol 1e-6.
"""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from benchmark import families, inputs, reference
from benchmark.tiny import REPO
from training_operator_tpu_torch.trainer import model as pt_model
from training_operator_tpu_torch.trainer import moe
from training_operator_tpu_torch.trainer.model import TransformerConfig, loss_fn
from training_operator_tpu_torch.trainer.train import (
    AdamW,
    init_train_state,
    make_example_batch,
    make_optimizer,
    make_train_step,
    template_train_state,
)

FAMILY = families.load(REPO, "olmoe")
RUN = {"dtype": "float32", "remat_policy": "save_attn_qkv", "remat_head": True,
       "rms_norm_eps": 1e-5, "router_aux_coef": 0.01,
       "optimizer": {"learning_rate": 3e-4, "weight_decay": 0.01, "warmup_steps": 0,
                     "total_steps": 100, "clip_norm": 1.0}}
# Tiny OLMoE dims: d 64, 4 heads of 16, E 16 experts of 32, k 4; and one case
# at the published E 64, k 8.
CASES = {"e16_k4": dict(n_experts=16, n_experts_per_tok=4),
         "e64_k8": dict(n_experts=64, n_experts_per_tok=8)}
SEED = 2**31 + 11


def _dims(n_experts, n_experts_per_tok):
    return dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=32,
                max_seq_len=16, rope_theta=10000, n_experts=n_experts,
                n_experts_per_tok=n_experts_per_tok, router_aux_coef=0.01, rms_norm_eps=1e-5)


def _config(dims, **kw):
    return dataclasses.replace(FAMILY.port_config(dims, RUN), attn_impl="xla", **kw)


def _filled_state(dims, config, optimizer=None):
    state = template_train_state(config, optimizer or make_optimizer(), device="cpu")
    for name, p in state.model.named_parameters():
        inputs.fill_leaf(p.data, FAMILY, dims, name, SEED)
    return state


def _batch(config, seed=1):
    return make_example_batch(config, 2, 16, torch.Generator().manual_seed(seed), device="cpu")


def _reference_grads(dims, batch):
    params = {n: inputs.initial_leaf(s, FAMILY, dims, n, SEED, "cpu").requires_grad_()
              for n, s in FAMILY.param_shapes(dims).items()}
    value = FAMILY.loss(params, batch["tokens"].long(), batch["targets"].long(), dims,
                        reference.Numerics(dims["rms_norm_eps"]))
    value.backward()
    return value, params


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_config_counts_the_published_model():
    config = __import__("json").loads(
        (REPO / "benchmark/configs/olmoe_1b7b_stage8.json").read_text())
    dims = FAMILY.dims(config)
    assert (dims["d_model"], dims["n_heads"], dims["n_kv_heads"], dims["d_ff"]) == (
        2048, 16, 16, 1024)
    assert (dims["n_experts"], dims["n_experts_per_tok"], dims["vocab_size"]) == (64, 8, 50304)
    assert FAMILY.count_params(dims) == (3_562_604_544, 641_009_664)
    model = pt_model.Transformer(FAMILY.port_config(dims, config["run"]), "meta")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        FAMILY.param_shapes(dims)
    from training_operator_tpu_torch.trainer.bench import _count_params

    assert _count_params(model) == FAMILY.count_params(dims)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match_the_reference(case):
    dims = _dims(**CASES[case])
    config = _config(dims)
    state = _filled_state(dims, config)
    batch = _batch(config)
    loss = loss_fn(state.model, batch, config)
    loss.backward()
    want, ref = _reference_grads(dims, batch)
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    for name, p in state.model.named_parameters():
        assert _rel(p.grad, ref[name].grad) < 1e-5, name


def test_one_adamw_step_matches_the_reference():
    dims = _dims(**CASES["e16_k4"])
    config = _config(dims)
    opt = RUN["optimizer"]
    optimizer = AdamW(**opt)
    state = _filled_state(dims, config, optimizer)
    batch = _batch(config)
    for _ in range(2):  # the first step runs at the schedule's lr 0
        state, _ = make_train_step(config, optimizer, device="cpu")(state, batch)
    params = {n: inputs.initial_leaf(s, FAMILY, dims, n, SEED, "cpu").requires_grad_()
              for n, s in FAMILY.param_shapes(dims).items()}
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    prec = reference.Numerics(dims["rms_norm_eps"])
    for step in range(2):
        value = FAMILY.loss(params, batch["tokens"].long(), batch["targets"].long(), dims, prec)
        value.backward()
        grads = {n: p.grad for n, p in params.items()}
        norm = math.sqrt(sum(float(g.square().sum()) for g in grads.values()))
        scale = opt["clip_norm"] / norm if norm >= opt["clip_norm"] else 1.0
        reference._adamw(params, grads, mu, nu, scale, step, opt)
        for p in params.values():
            p.grad = None
    for name, p in state.model.named_parameters():
        assert _rel(p.detach(), params[name].detach()) < 1e-5, name


def _loop_moe(h, router, experts, config):
    """The dropless layer token by token: each token's k chosen experts."""
    x = h.reshape(-1, h.shape[-1])
    probs = torch.softmax(x.float() @ router, dim=-1)
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        gate, choice = probs[t].topk(config.n_experts_per_tok)
        for g, e in zip(gate, choice):
            y = (F.silu(x[t] @ experts["w1"][e]) * (x[t] @ experts["w3"][e])) @ experts["w2"][e]
            out[t] += g * y
    return out.view(h.shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dropless_layer_is_the_per_token_loop(case):
    E, k = CASES[case]["n_experts"], CASES[case]["n_experts_per_tok"]
    config = TransformerConfig(d_model=64, d_ff=32, n_experts=E, n_experts_per_tok=k,
                               moe_router="dropless", dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    h = torch.randn(2, 24, 64, generator=g)
    router = torch.randn(64, E, generator=g) * 0.3
    experts = {"w1": torch.randn(E, 64, 32, generator=g) / 8,
               "w3": torch.randn(E, 64, 32, generator=g) / 8,
               "w2": torch.randn(E, 32, 64, generator=g) / 8}
    out, sums = moe.dropless_mlp(h, router, experts, config)
    torch.testing.assert_close(out, _loop_moe(h, router, experts, config), rtol=1e-5,
                               atol=1e-6)
    probs = torch.softmax(h.reshape(-1, 64) @ router, -1)
    choice = probs.topk(k).indices
    assert torch.equal(sums[0], torch.bincount(choice.reshape(-1), minlength=E).float())
    torch.testing.assert_close(sums[1], probs.sum(0), rtol=1e-6, atol=1e-6)


def test_group_layout_pads_every_group_and_keeps_token_order():
    choice = torch.tensor([[2, 0], [2, 1], [0, 2], [2, 0]])
    counts = torch.bincount(choice.reshape(-1), minlength=4)
    dest, offs, rows = moe.group_layout(choice, counts, 4)
    A = moe.GROUP_ALIGN
    assert rows == 8 + 4 * A
    # Expert 0: pairs (0,1), (2,0), (3,1); 1: (1,1); 2: (0,0), (1,0), (2,1), (3,0); 3: none,
    # the slack closing its group.
    assert offs.tolist() == [A, 2 * A, 3 * A, rows]
    assert dest.view(4, 2).tolist() == [[2 * A, 0], [2 * A + 1, A], [1, 2 * A + 2],
                                        [2 * A + 3, 2]]


def test_pooled_aux_is_transformers_formula(monkeypatch):
    """transformers' load_balancing_loss_func on every layer's router logits,
    concatenated: E * sum over (choice slot, expert) of the mean one-hot
    times the mean probability."""
    dims = _dims(**CASES["e16_k4"])
    config = _config(dims)
    state = _filled_state(dims, config)
    logits = []
    route = moe.route_topk

    def recording(x, router, cfg):
        logits.append(x.float() @ router.float())
        return route(x, router, cfg)

    monkeypatch.setattr(moe, "route_topk", recording)
    _, aux = pt_model._backbone(state.model, _batch(config)["tokens"], config)
    assert len(logits) == config.n_layers
    probs = torch.softmax(torch.cat(logits), dim=-1)
    chosen = F.one_hot(probs.topk(config.n_experts_per_tok).indices, config.n_experts)
    want = config.n_experts * (chosen.float().mean(0) * probs.mean(0)[None]).sum()
    assert aux.item() == pytest.approx(want.item(), rel=1e-6)


def test_routing_in_the_recompute_is_the_forwards(monkeypatch):
    dims = _dims(**CASES["e64_k8"])
    config = _config(dims, dtype=torch.bfloat16)
    state = _filled_state(dims, config)
    choices = []
    route = moe.route_topk

    def recording(x, router, cfg):
        out = route(x, router, cfg)
        choices.append(out[1].clone())
        return out

    monkeypatch.setattr(moe, "route_topk", recording)
    loss_fn(state.model, _batch(config), config).backward()
    L = config.n_layers
    assert len(choices) == 2 * L  # the forward, then the recompute from the last layer
    for forward, again in zip(choices[:L], reversed(choices[L:])):
        assert torch.equal(forward, again)


def test_rms_norm_eps_reaches_every_norm(monkeypatch):
    dims = _dims(**CASES["e16_k4"])
    config = _config(dims, rms_norm_eps=3e-3)
    state = _filled_state(dims, config)
    seen = []
    norm = pt_model._rms_norm

    def recording(x, scale, eps=1e-6):
        seen.append(eps)
        return norm(x, scale, eps)

    monkeypatch.setattr(pt_model, "_rms_norm", recording)
    loss = loss_fn(state.model, _batch(config), config)
    # ln1, q_norm, k_norm and ln2 per layer, then ln_f.
    assert len(seen) == 4 * config.n_layers + 1
    loss.backward()
    # The backward recomputes ln1, q_norm, k_norm (_NormQKV) and ln2 (the
    # checkpointed MoE half) per layer.
    assert len(seen) == 2 * (4 * config.n_layers) + 1
    assert set(seen) == {3e-3}
    monkeypatch.undo()
    other = loss_fn(state.model, _batch(config), dataclasses.replace(config, rms_norm_eps=1e-6))
    assert other.item() != loss.item()


def test_routing_reads_nothing_back_to_the_host(monkeypatch):
    """The router, the group layout and the dispatch take no .item(),
    .tolist() or truth value of a tensor."""
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was read back to the host")

    config = TransformerConfig(d_model=64, d_ff=32, n_experts=16, n_experts_per_tok=4,
                               moe_router="dropless", dtype=torch.float32)
    x = torch.randn(48, 64)
    router = torch.randn(64, 16)
    for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    gate, choice, counts, _ = moe.route_topk(x, router, config)
    dest, offs, rows = moe.group_layout(choice, counts, 16)
    moe._Dispatch.apply(x, dest, rows, 4)
    monkeypatch.undo()
    assert rows == 48 * 4 + 16 * moe.GROUP_ALIGN


def test_plain_grouped_products_are_torchs_grouped_mm():
    """The CPU's loop of products is what torch's `_grouped_mm` computes on
    the same groups, in bf16."""
    g = torch.Generator().manual_seed(5)
    a = torch.randn(96, 32, generator=g).bfloat16()
    b = torch.randn(4, 32, 24, generator=g).bfloat16()
    offs = torch.tensor([16, 32, 64, 96], dtype=torch.int32)
    assert torch.equal(moe.plain_grouped_mm(a, b, offs), torch._grouped_mm(a, b, offs=offs))


@pytest.mark.parametrize("kw", [dict(moe_router="dropless", n_experts=4, n_experts_per_tok=2),
                                dict(qk_norm=True)])
def test_unsharded_only_parts_refuse_the_loopback_pipeline(kw):
    from training_operator_tpu_torch.trainer.pipeline import loopback

    config = TransformerConfig(vocab_size=96, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               d_ff=64, **kw)
    with pytest.raises(ValueError, match="unsharded"):
        loopback(pt_model.Transformer(config, "meta"), 2)


@pytest.mark.parametrize("kw", [dict(n_experts_per_tok=2), dict(moe_router="top2"),
                                dict(moe_router="dropless", n_experts_per_tok=5)])
def test_bad_router_settings_are_refused(kw):
    with pytest.raises(ValueError):
        TransformerConfig(n_experts=4, **kw).validate()


# The dense and switch configurations' loss and gradient norm on the CPU, as
# the port computed them before the dropless layer, qk-norm and
# `rms_norm_eps` were added (float.hex, one thread).
BEFORE = {
    ("dense", "float32"): ("0x1.3a1c080000000p+2", "0x1.1e47d6215ab8ep+1"),
    ("dense", "bfloat16"): ("0x1.3a1f8e0000000p+2", "0x1.1e323f578f8d8p+1"),
    ("switch", "float32"): ("0x1.41df380000000p+2", "0x1.beb41ebc9b029p+0"),
    ("switch", "bfloat16"): ("0x1.41dce20000000p+2", "0x1.be936c0fa6178p+0"),
}


@pytest.mark.parametrize("kind,dtype", sorted(BEFORE))
def test_dense_and_switch_losses_are_bit_identical_to_before(kind, dtype):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = TransformerConfig(vocab_size=96, d_model=32, n_layers=2, n_heads=4,
                                   n_kv_heads=2, d_ff=64, max_seq_len=16,
                                   remat_policy="save_attn_qkv", remat_head=True,
                                   attn_impl="xla", dtype=getattr(torch, dtype),
                                   n_experts=4 if kind == "switch" else 0)
        state = init_train_state(config, make_optimizer(), torch.Generator().manual_seed(0),
                                 device="cpu")
        batch = make_example_batch(config, 2, 16, torch.Generator().manual_seed(1),
                                   device="cpu")
        loss = loss_fn(state.model, batch, config)
        loss.backward()
        norm = torch.sqrt(sum(p.grad.double().square().sum()
                              for p in state.model.parameters()))
    finally:
        torch.set_num_threads(threads)
    assert (loss.item().hex(), norm.item().hex()) == BEFORE[(kind, dtype)]
