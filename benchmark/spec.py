"""What `BENCHMARK.json` says about one cell, and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own, found by name:

- a configuration: the `file` its `configs` entry names (a JSON object
  holding the published config, `reduced`, `assumed`, `departures`, the
  deployment it stands for, and the `run` block: compute dtype, remat
  policy, optimizer, the RMSNorm eps as run, and the roundings of the
  control (reference.numerics));
- a traffic mix: `benchmark/traffic/<traffic>.json` (traffic.py);
- a cell's limits for `correct`: `benchmark/limits/<workload>.json`;
- a metric: `benchmark/metrics/<name>.py`, whose `read(run)` returns the
  value or None (metrics/__init__.py).

A later cell or metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

from benchmark import traffic as traffic_mod

BENCH_DIR = "benchmark"
# The port's RMSNorm epsilon in every norm (trainer/model.py `_rms_norm`),
# which takes none from a config: a configuration's `run.rms_norm_eps`
# states it, whatever its published config says.
PORT_RMS_EPS = 1e-6
# The published config.json keys the port's decoder is built from.
SHAPE_KEYS = {
    "vocab_size": "vocab_size",
    "hidden_size": "d_model",
    "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff",
    "max_position_embeddings": "max_seq_len",
    "rope_theta": "rope_theta",
}


@dataclass
class Metric:
    name: str
    unit: str


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict  # the configuration file
    dims: dict  # the decoder's sizes, by the port's TransformerConfig names
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def run(self) -> dict:
        return self.config["run"]

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


def decoder_dims(config: dict) -> Dict:
    """The port's TransformerConfig sizes from a published config, refusing
    what the port's dense decoder cannot express."""
    c = config["config"]
    missing = [k for k in SHAPE_KEYS if k not in c]
    if missing:
        raise ValueError(f"config {config.get('name')} lacks {missing}")
    if c.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's MLP is SwiGLU (silu)")
    if c.get("tie_word_embeddings", False):
        raise ValueError("the port's head is untied")
    if c.get("sliding_window") is not None:
        raise ValueError("the port's attention is full causal, with no window")
    if c.get("attention_bias") or c.get("mlp_bias") or c.get("bias"):
        raise ValueError("the port's products have no biases")
    if config["run"].get("rms_norm_eps") != PORT_RMS_EPS:
        raise ValueError(f"the port runs RMSNorm at eps {PORT_RMS_EPS}: run.rms_norm_eps "
                         "has to state it")
    dims = {ours: c[theirs] for theirs, ours in SHAPE_KEYS.items()}
    head_dim = c.get("head_dim", c["hidden_size"] // c["num_attention_heads"])
    if head_dim * c["num_attention_heads"] != c["hidden_size"]:
        raise ValueError("the port's head_dim is hidden_size / num_attention_heads")
    return dims


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named `workload` of `root/BENCHMARK.json`, with its files
    read; raises when any is missing."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = traffic_mod.load(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = json.loads((root / BENCH_DIR / "limits" / f"{workload}.json").read_text())
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"] if _in_cell(m, workload)]
    moved = {m.name for m in e2e}
    # A per-layer metric without a `workloads` list belongs to every cell
    # that reports the end-to-end metric it moves.
    per_layer = [Metric(m["name"], m["unit"]) for m in bench["per_layer"]
                 if _in_cell(m, workload) and m["moves"] in moved]
    return Cell(name=workload, root=root, chips=w["chips"], config=config, dims=decoder_dims(config),
                traffic=traffic, limits=limits, end_to_end=e2e, per_layer=per_layer)


def _in_cell(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])
