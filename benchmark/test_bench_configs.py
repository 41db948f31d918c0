"""The configurations and the copied arithmetic, on the CPU."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import families, spec, traffic, yardstick
from benchmark.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
DECODER = families.load(REPO, "decoder")
CELLS = [w["name"] for w in BENCH["workloads"]]
# Published widths (each model's config.json) and parameter counts of the
# decoder as run: Mistral-7B-v0.3 cut to 8 of its 32 layers; InternLM2-1.8B
# whole.
PUBLISHED = {
    "mistral7b_v03_stage8": dict(vocab_size=32768, d_model=4096, n_layers=8, n_heads=32,
                                 n_kv_heads=8, d_ff=14336, rope_theta=1e6,
                                 total=2_013_335_552, products=1_879_117_824),
    "internlm2_1p8b": dict(vocab_size=92544, d_model=2048, n_layers=24, n_heads=16,
                           n_kv_heads=8, d_ff=8192, rope_theta=1e6,
                           total=1_889_110_016, products=1_699_579_904),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_config_maps_to_the_port(name):
    from training_operator_tpu_torch.trainer.bench import _count_params
    from training_operator_tpu_torch.trainer.model import Transformer, TransformerConfig

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    config = json.loads((REPO / entry["file"]).read_text())
    dims = DECODER.dims(config)
    want = PUBLISHED[name]
    assert {k: dims[k] for k in want if k in dims} == {k: v for k, v in want.items()
                                                      if k in dims}
    assert dims["d_model"] // dims["n_heads"] == 128
    assert DECODER.count_params(dims) == (want["total"], want["products"])
    assert config["params"] == {"total": want["total"], "products": want["products"]}
    model = Transformer(TransformerConfig(**dims), "meta")
    assert _count_params(model) == (want["total"], want["products"])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == DECODER.param_shapes(dims)
    # `reduced` names every key changed from the published config, and
    # nothing else.
    assert sorted(entry["reduced"]) == sorted(config["reduced"]) == sorted(config["published"])


def test_flops_and_bytes_by_hand():
    dims = dict(vocab_size=32768, d_model=4096, n_layers=8, n_heads=32, n_kv_heads=8,
                d_ff=14336)
    # 6 x 1,879,117,824 + 6 x 8 x 4096 x 4096 FLOP a token, 16,384 tokens.
    want = 16384 * (6 * 1_879_117_824 + 6 * 8 * 4096 * 4096)
    assert DECODER.flops_per_step(dims, 4, 4096) == want
    w = DECODER.attention_work(4, 4096, 32, 128, True, 2)
    pairs = 4 * 32 * 4096 * 4097 // 2
    assert w["flash_fwd"]["flops"] == 4 * 128 * pairs
    assert w["flash_bwd_dq"]["flops"] == 6 * 128 * pairs
    assert w["flash_bwd_dkv"]["flops"] == 8 * 128 * pairs
    tensor = 4 * 32 * 4096 * 128 * 2
    assert w["flash_fwd"]["bytes"] == 4 * tensor + 4 * 32 * 4096 * 4
    assert w["flash_bwd_dkv"]["bytes"] == 6 * tensor + 2 * 4 * 32 * 4096 * 4


def test_copies_match_the_port():
    """The yardstick and the decoder family's arithmetic are copies: they read
    as the port's own arithmetic does today, so a later change to the port
    cannot move them unseen."""
    from training_operator_tpu_torch.trainer import bench
    from training_operator_tpu_torch.trainer.model import TransformerConfig

    dims = dict(vocab_size=92544, d_model=2048, n_layers=24, n_heads=16, n_kv_heads=8,
                d_ff=8192)
    cfg = TransformerConfig(**dims)
    n = DECODER.count_params(dims)[1]
    assert DECODER.flops_per_step(dims, 1, 16384) == bench.flops_per_step(cfg, n, 1, 16384)
    assert DECODER.FLOPS_RULE == bench.FLOPS_RULE
    assert yardstick.PEAK_BF16_FLOPS == bench.PEAK_BF16_FLOPS
    assert yardstick.PEAK_BYTES_PER_S == bench.PEAK_BYTES_PER_S
    for causal in (True, False):
        assert (DECODER.attention_work(2, 1000, 4, 64, causal, 2)
                == bench.attention_work(2, 1000, 4, 64, causal, torch.bfloat16))
    for name in ("void flash_bwd_dkv_kernel<128>", "sm90_xmma_gemm_bf16bf16", "nvjet_tst_128x",
                 "reduce_kernel<512>", "vectorized_elementwise_kernel"):
        assert yardstick.kernel_family(name) == bench._kernel_family(name)


@pytest.mark.parametrize("name", ["seq4k", "seq16k", "seq32k"])
def test_traffic_is_fixed_in_shape_and_drawn_from_the_seed(name):
    mix = traffic.load(REPO / "benchmark" / "traffic" / f"{name}.json")
    need = mix["batch"] * mix["batches"] * (mix["seq"] + 1)
    a = traffic.token_stream(mix, 32768, 2**31 + 7)
    b = traffic.token_stream(mix, 32768, 2**31 + 7)
    c = traffic.token_stream(mix, 32768, 2**40 + 3)
    assert a.shape == c.shape == (need,) and a.dtype.name == "int32"
    assert (a == b).all() and not (a == c).all()
    assert a.min() >= 0 and a.max() < 32768
    # Zipf-ranked: the commonest id is id 0, and ids are skewed towards it.
    counts = np.bincount(a, minlength=32768)
    assert counts.argmax() == 0 and counts[:100].sum() > counts[100:].sum() / 4


def test_every_cell_loads():
    """Each cell loads with the metrics BENCHMARK.json gives it: an entry
    with a `workloads` list names its cells, one without belongs to every
    cell that reports the end-to-end metric it moves."""
    for name in CELLS:
        cell = spec.load_cell(REPO, name)
        e2e = {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])}
        per_layer = {m["name"] for m in BENCH["per_layer"]
                     if name in m.get("workloads", [name]) and m["moves"] in e2e}
        assert {m.name for m in cell.end_to_end} == e2e
        assert {"tokens_per_s", "setup_s"} <= e2e
        assert {m.name for m in cell.per_layer} == per_layer
        assert {"mfu", "attn_roofline"} <= per_layer
        assert cell.family.__file__ == str(REPO / "benchmark" / "families" / "decoder.py")
        assert set(cell.limits) & {"loss_gap", "gnorm_gap", "grad_gap", "change_gap"}
