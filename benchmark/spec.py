"""What `BENCHMARK.json` says about one cell, and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own, found by name:

- a configuration: the `file` its `configs` entry names (a JSON object
  holding the published config, `reduced`, `assumed`, `departures`, the
  deployment it stands for, and the `run` block: compute dtype, remat
  policy, optimizer, the RMSNorm eps as run, and the roundings of the
  control (reference.numerics)), and the model family it names under
  `family` (the dense decoder where it names none):
  `benchmark/families/<family>.py` (families/__init__.py);
- a traffic mix: `benchmark/traffic/<traffic>.json` (traffic.py);
- a cell's limits for `correct`: `benchmark/limits/<workload>.json`;
- a metric: `benchmark/metrics/<name>.py`, whose `read(run)` returns the
  value or None (metrics/__init__.py).

A later cell, metric or model family adds files and entries; no file here
changes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

from benchmark import families
from benchmark import traffic as traffic_mod

BENCH_DIR = "benchmark"


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
    family: ModuleType  # its model family (families/__init__.py)
    dims: dict  # the port's sizes, as the family reads them from the config
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def run(self) -> dict:
        return self.config["run"]

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


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
    family = families.load(root, config.get("family", families.DEFAULT))
    traffic = traffic_mod.load(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = json.loads((root / BENCH_DIR / "limits" / f"{workload}.json").read_text())
    e2e = [Metric(m["name"], m["unit"]) for m in bench["end_to_end"] if _in_cell(m, workload)]
    moved = {m.name for m in e2e}
    # A per-layer metric without a `workloads` list belongs to every cell
    # that reports the end-to-end metric it moves.
    per_layer = [Metric(m["name"], m["unit"]) for m in bench["per_layer"]
                 if _in_cell(m, workload) and m["moves"] in moved]
    return Cell(name=workload, root=root, chips=w["chips"], config=config, family=family,
                dims=family.dims(config), traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def _in_cell(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])
