"""Model families: the rules that turn one kind of model's configuration into
the port's model, its parameter table, its FLOP and attention arithmetic and
its plain reference.

A configuration file names its family under `"family"` (`DEFAULT` where it
names none); the family is `benchmark/families/<name>.py` under the cell's
root, loaded by path, so a later model of another kind adds one file and no
file here changes. A family module defines:

- `dims(config)`: the port's sizes from the configuration file, refusing
  every key of the published config that it neither reads nor lists as
  shape-neutral, by name;
- `port_config(dims, run)`: the port's model config, built through the
  port's own entry point, with the `run` block's dtype and remat settings;
- `param_shapes(dims)`: every parameter by the port's names and layout;
- `count_params(dims)`: (total, the products one token passes through);
- `leaf_init(dims, name)`: the std of a leaf's normal draw, or None for a
  norm scale, which starts at ones (inputs.fill_leaf draws it);
- `flops_per_step(dims, batch, seq)`: model FLOPs of one fwd+bwd step;
- `attention_bound_s(dims, batch, seq, dtype_bytes, calls, flops_peak,
  bytes_peak)`: the least seconds the card could take for a window's calls
  of the flash ops, `calls` being {op: [call ids in launch order]} by the
  op's short name (`flash_fwd`, `flash_bwd_dq`, `flash_bwd_dkv`);
- `loss(params, tokens, targets, dims, numerics, half_batch)`: the plain
  fp32 reference loss (reference.Numerics; `half_batch` the planted fault of
  the mean over the first half of the tokens). It imports nothing of the
  port.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

DEFAULT = "decoder"
CONTRACT = ("dims", "port_config", "param_shapes", "count_params", "leaf_init",
            "flops_per_step", "attention_bound_s", "loss")


def load(root: Path, name: str) -> ModuleType:
    """The family module `name`, from its file under `root`; raises when the
    file is missing or defines less than CONTRACT."""
    path = Path(root) / "benchmark" / "families" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"model family {name!r} has no file at {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_family_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in CONTRACT if not callable(getattr(module, f, None))]
    if missing:
        raise TypeError(f"model family {name!r} at {path} lacks {missing}")
    return module
