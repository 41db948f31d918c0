"""A tiny cell in a directory of its own, for the benchmark's CPU tests: a
BENCHMARK.json with one cell of a 2-layer decoder of the Mistral config's
form, its traffic and limits, and the metric readers and model families
copied beside them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CELL = "tiny.t"
DIMS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=256)
TRAFFIC = {"batch": 2, "seq": 32, "batches": 8, "zipf_a": 1.1}
# Set from the tiny cell's readings on the CPU (benchmark/readings.py's
# `readings` over seeds 1-12, control and half batch on seeds 1-3). Sound
# runs read at most: loss 1.31e-3, gnorm 5.2e-4, grad 1.21e-3, change
# 8.5e-4. The fp8 control reads at least: loss 2.6e-3, gnorm 1.7e-3,
# grad 3.7e-3, change 2.4e-3, so at this size it is `grad_gap` that fails
# it. Half the batch reads at least 0.118, 0.428, 0.044, 0.235.
LIMITS = {"steps": 3, "loss_gap": 6e-3, "gnorm_gap": 4e-3, "grad_gap": 3e-3,
          "change_gap": 4e-3}


def make_root(tmp: Path, limits: dict = LIMITS) -> Path:
    """`tmp` as a checkout holding the tiny cell; returns it."""
    tmp = Path(tmp)
    bench = tmp / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "families"):
        shutil.copytree(REPO / "benchmark" / d, bench / d, dirs_exist_ok=True)
    cfg = json.loads((REPO / "benchmark/configs/mistral7b_v03_stage8.json").read_text())
    cfg["name"] = "tiny"
    cfg["config"].update(DIMS)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "tiny", "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "tests"}]
    spec["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "tiny", "chips": 1,
                          "why": "tests"}]
    for m in spec["per_layer"]:
        m["workloads"] = [CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
