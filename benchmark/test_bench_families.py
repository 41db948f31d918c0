"""Model families (benchmark/families/): the dense decoder gives the numbers
the harness gave before it was a family, refuses configs of other kinds of
model, and a family of another kind, written beside a tiny cell as a later
model would add it, runs through the harness with no file of it changed."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from benchmark import families, inputs, reference, run, spec, traffic
from benchmark.test_bench_harness import _half_batch, _unchanged
from benchmark.tiny import CELL, LIMITS, REPO, make_root

DECODER = families.load(REPO, "decoder")
FLASH_CALLS = {"flash_fwd": [11, 40, 71], "flash_bwd_dq": [90, 120], "flash_bwd_dkv": [91, 121]}
# Read from the harness before the family seam (yardstick.param_shapes,
# count_params, flops_per_step and attention_work, the attention bound of
# FLASH_CALLS at 989e12 FLOP/s and 3.35e12 B/s): each cell's shapes.
PINNED = {
    "mistral7b_v03_stage8": {
        "dims": dict(vocab_size=32768, d_model=4096, n_layers=8, n_heads=32, n_kv_heads=8,
                     d_ff=14336, max_seq_len=32768, rope_theta=1e6),
        "params": (2_013_335_552, 1_879_117_824),
        "flops": {(4, 4096): 197918938103808.0},
        "bound_s": {(4, 4096): 0.005560060987017189, (1, 32768): 0.08894197631611729},
    },
    "internlm2_1p8b": {
        "dims": dict(vocab_size=92544, d_model=2048, n_layers=24, n_heads=16, n_kv_heads=8,
                     d_ff=8192, max_seq_len=32768, rope_theta=1000000),
        "params": (1_889_110_016, 1_699_579_904),
        "flops": {(1, 16384): 246240340082688.0},
        "bound_s": {(4, 4096): 0.0027800304935085944, (1, 16384): 0.01111808631587462},
    },
}
# The tiny cell's reference (reference.run_steps, seed 2**31 + 5, 3 steps)
# as the harness computed it before the family seam.
TINY_SEED = 2**31 + 5
TINY_REF = {
    "loss": [5.8626389503479, 6.116319179534912, 6.0397539138793945],
    "grad_norm": [1.8742487363805613, 1.9187833751959953, 1.9380336574381902],
    "grad_leaf": {
        "embed": 0.07775256640295966, "layers.ln1": 0.027077676139297478,
        "layers.wq": 0.113022185779886, "layers.wk": 0.1126978065420037,
        "layers.wv": 0.1786387946885015, "layers.wo": 0.4000870622682281,
        "layers.ln2": 0.05177426158881584, "layers.w1": 0.292350572565862,
        "layers.w3": 0.28050338414747666, "layers.w2": 0.5515483785484827,
        "ln_f": 0.09189242434215082, "lm_head": 0.5443194282228454,
    },
}
# Moonlight-16B-A3B's published config.json
# (https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json):
# DeepSeek-V3's block, latent attention and routed plus shared experts.
MOONLIGHT = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 11264, "kv_lora_rank": 512,
    "max_position_embeddings": 8192, "model_type": "deepseek_v3",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": True, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "num_nextn_predict_layers": 0, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05, "rope_theta": 50000,
    "routed_scaling_factor": 2.446, "scoring_func": "sigmoid", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 163840,
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_decoder_family_gives_the_harness_numbers(name):
    entry = next(c for c in json.loads((REPO / "BENCHMARK.json").read_text())["configs"]
                 if c["name"] == name)
    config = json.loads((REPO / entry["file"]).read_text())
    assert "family" not in config  # the dense decoder by default
    want = PINNED[name]
    dims = DECODER.dims(config)
    assert dims == want["dims"]
    assert DECODER.count_params(dims) == want["params"]
    for (batch, seq), flops in want["flops"].items():
        assert DECODER.flops_per_step(dims, batch, seq) == flops
    for (batch, seq), bound in want["bound_s"].items():
        assert DECODER.attention_bound_s(dims, batch, seq, 2, FLASH_CALLS, 989e12,
                                         3.35e12) == bound
    if name == "mistral7b_v03_stage8":
        assert want["flops"][(4, 4096)] == 16384 * (6 * 1_879_117_824 + 6 * 8 * 4096 ** 2)


def test_tiny_reference_is_unchanged(tmp_path):
    cell = spec.load_cell(make_root(tmp_path), CELL)
    stream = traffic.token_stream(cell.traffic, cell.dims["vocab_size"], TINY_SEED)
    batches = inputs.reference_batches(stream, cell.traffic, traffic.shuffle_seed(TINY_SEED), 3)
    ref = reference.run_steps(cell.family, cell.dims, cell.run["optimizer"], TINY_SEED, batches,
                              "cpu", reference.numerics(cell.run), steps=3)
    assert ref["loss"] == pytest.approx(TINY_REF["loss"], rel=1e-7)
    assert ref["grad_norm"] == pytest.approx(TINY_REF["grad_norm"], rel=1e-7)
    assert ref["grad_leaf"] == pytest.approx(TINY_REF["grad_leaf"], rel=1e-7)


def test_decoder_refuses_moonlight():
    config = {"name": "moonlight", "config": MOONLIGHT,
              "run": {"rms_norm_eps": DECODER.PORT_RMS_EPS}}
    with pytest.raises(ValueError) as err:
        DECODER.dims(config)
    for key in ("n_routed_experts", "kv_lora_rank", "num_experts_per_tok", "n_shared_experts",
                "qk_rope_head_dim", "v_head_dim", "first_k_dense_replace"):
        assert key in str(err.value)


def test_missing_family_is_refused(tmp_path):
    root = make_root(tmp_path)
    path = root / "benchmark" / "configs" / "tiny.json"
    config = json.loads(path.read_text())
    path.write_text(json.dumps(dict(config, family="no_such_family")))
    with pytest.raises(FileNotFoundError, match="no_such_family.py"):
        spec.load_cell(root, CELL)
    # A family file has to define the whole contract.
    (root / "benchmark" / "families" / "half_done.py").write_text(
        "def dims(config):\n    return {}\n")
    path.write_text(json.dumps(dict(config, family="half_done")))
    with pytest.raises(TypeError, match="port_config"):
        spec.load_cell(root, CELL)


# A family the harness has no file of: the port's switch (top-1) MoE decoder
# (trainer/moe.py, `n_experts` > 0), with its own parameter table, FLOP rule
# and plain reference. The reference follows moe.py's stated rules: top-1 on
# fp32 router logits, cap = max(1, int(capacity T / E)), tokens past their
# expert's cap in token order dropped, out = gate * MLP_e(x), and the
# layers' mean aux loss E * sum_e frac_e * mean_prob_e at the aux weight.
SWITCH_FAMILY = '''
"""The port's switch MoE decoder, for the harness's tests."""

import math
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import families

decoder = families.load(Path(__file__).resolve().parents[2], "decoder")
MOE_KEYS = {"num_experts": "n_experts", "expert_capacity": "expert_capacity",
            "router_aux_loss_coef": "router_aux_coef"}
NAMES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "router", "w1", "w3", "w2")
port_config, leaf_init, attention_bound_s = (decoder.port_config, decoder.leaf_init,
                                             decoder.attention_bound_s)


def dims(config):
    c = dict(config["config"])
    if c.pop("num_experts_per_tok") != 1:
        raise ValueError("a switch MoE routes a token to one expert")
    moe = {ours: c.pop(theirs) for theirs, ours in MOE_KEYS.items()}
    return {**decoder.dims(dict(config, config=c)), **moe}


def param_shapes(dims):
    L, D, F_, E = dims["n_layers"], dims["d_model"], dims["d_ff"], dims["n_experts"]
    return {**decoder.param_shapes(dims), "layers.router": (L, D, E),
            "layers.w1": (L, E, D, F_), "layers.w3": (L, E, D, F_), "layers.w2": (L, E, F_, D)}


def count_params(dims):
    sizes = {n: math.prod(s) for n, s in param_shapes(dims).items()}
    total = sum(sizes.values())
    experts = sum(sizes["layers." + n] for n in ("w1", "w3", "w2"))
    return total, total - sizes["embed"] - (experts - experts // dims["n_experts"])


def flops_per_step(dims, batch, seq):
    attn = 6 * dims["n_layers"] * seq * dims["d_model"]
    return float(batch * seq) * (6.0 * count_params(dims)[1] + attn)


def _moe(x, lp, dims, prec):
    b, s, D = x.shape
    E = dims["n_experts"]
    h = prec.rms(x, lp["ln2"]).reshape(-1, D)
    probs = torch.softmax(h @ lp["router"], dim=-1)
    gate, choice = probs.max(dim=-1)
    cap = max(1, int(dims["expert_capacity"] * h.shape[0] / E))
    mm = lambda a, w: prec.body(a) @ prec.body(w)
    out = torch.zeros_like(h)
    for e in range(E):
        kept = (choice == e).nonzero()[:cap, 0]
        he = h[kept]
        y = mm(F.silu(mm(he, lp["w1"][e])) * mm(he, lp["w3"][e]), lp["w2"][e])
        out = out.index_add(0, kept, gate[kept, None] * y)
    frac = F.one_hot(choice, E).sum(0).float() / h.shape[0]
    return x + out.reshape(b, s, D), E * (frac * probs.mean(0)).sum()


def loss(params, tokens, targets, dims, prec, half_batch=False):
    x = params["embed"][tokens]
    aux = 0.0
    for i in range(dims["n_layers"]):
        lp = {n: params["layers." + n][i] for n in NAMES}
        q, k, v = checkpoint(decoder._qkv, x, lp, dims, prec, use_reentrant=False)
        x = x + prec.body(decoder.attention(q, k, v, prec).reshape(x.shape)) @ prec.body(lp["wo"])
        x, a = checkpoint(_moe, x, lp, dims, prec, use_reentrant=False)
        aux = aux + a
    ce = decoder.head_loss(x, params, targets, prec, half_batch)
    return ce + dims["router_aux_coef"] * aux / dims["n_layers"]
'''


def _switch_root(tmp_path) -> Path:
    """The tiny cell's root with a second cell, `switch.t`, of a 4-expert
    switch MoE decoder in fp32: in bf16 a near-tied token's top-1 choice
    follows the last bits of its hidden state (moe.py `route`)."""
    root = make_root(tmp_path)
    bench = root / "benchmark"
    (bench / "families" / "switch_moe.py").write_text(SWITCH_FAMILY)
    config = json.loads((bench / "configs" / "tiny.json").read_text())
    config["name"], config["family"] = "switch", "switch_moe"
    config["config"].update(num_experts=4, expert_capacity=1.25, router_aux_loss_coef=0.01,
                            num_experts_per_tok=1)
    config["run"]["dtype"] = "float32"
    (bench / "configs" / "switch.json").write_text(json.dumps(config))
    (bench / "limits" / "switch.t.json").write_text(json.dumps(LIMITS))
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["configs"].append({"name": "switch", "source": "tests",
                                  "file": "benchmark/configs/switch.json", "reduced": [],
                                  "why": "tests"})
    bench_json["workloads"].append({"name": "switch.t", "config": "switch", "traffic": "tiny",
                                    "chips": 1, "why": "tests"})
    for m in bench_json["per_layer"]:
        m["workloads"].append("switch.t")
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root


def test_switch_family_counts_as_the_port(tmp_path):
    from training_operator_tpu_torch.trainer.bench import _count_params
    from training_operator_tpu_torch.trainer.model import Transformer

    cell = spec.load_cell(_switch_root(tmp_path), "switch.t")
    assert importlib.util.find_spec("benchmark.families.switch_moe") is None
    assert cell.dims["n_experts"] == 4 and cell.dims["expert_capacity"] == 1.25
    model = Transformer(cell.family.port_config(cell.dims, cell.run), "meta")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        cell.family.param_shapes(cell.dims)
    assert cell.family.count_params(cell.dims) == _count_params(model)


@pytest.mark.parametrize("fault", [None, _half_batch, _unchanged])
def test_switch_family_runs_through_the_harness(tmp_path, monkeypatch, fault):
    """A sound run of the switch MoE cell is correct against its family's
    reference; a planted fault is not."""
    cell = spec.load_cell(_switch_root(tmp_path), "switch.t")
    if fault is not None:
        fault(monkeypatch)
    result = run.run_cell(cell, 2**31 + 9, 0.5, False, "cpu")
    assert result["correct"] is (fault is None), result["checks"]
