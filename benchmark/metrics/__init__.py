"""One reader per metric: `benchmark/metrics/<name>.py` defines
`read(run)`, which returns the metric's value, or None where the run holds
nothing for it to read (the harness then leaves the metric out of the
line). `run` is run.RunView: the cell's sizes, the window's host and
device readings and, in a traced run, the trace (device_trace.Trace)."""

from __future__ import annotations

import importlib.util
from pathlib import Path


def reader(root: Path, name: str):
    """The `read` function of metric `name`, from its file under `root`."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
