#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once on the card and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's timed path is the port's training loop between saves
(`trainer/standalone.py train_loop`): `make_train_step` (the loss,
backward, global-norm clip and AdamW in place) fed by epochs of
`prefetch(DataLoader(TokenDataset(rows)).epoch(e), size=2)`, the rows the
traffic file's token stream packed by the port's `pack_tokens`, with the
loop's read of the loss every 5 steps.

Set-up: the caches in fixed directories inside the checkout (Python's
bytecode among them), torch's lazily loaded compiler stack, the kernels
(built there on a checkout's first run, loaded after), a zero-filled state
filled with weights drawn on the card from the seed (inputs.py), the data,
and the first steps through the window's own call and feed, which warm up
the cell's one shape and give the readings `correct` compares (check.py).
Then the window: `--seconds` of steps, each closed by a CUDA event; with
`--trace 1` under torch.profiler, for the per-layer metrics. After it: the
peak memory is read, the program's state freed, and the plain reference
(reference.py) follows the first steps from the same weights and rows.

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result. With no card, or fewer than the
cell asks for, or with JAX loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ".bench_cache"
# Run as a script, the repository's root takes the place of this folder on
# the path, so `benchmark` and the port import as packages.
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)
if __name__ == "__main__":
    # The bytecode of every module a run imports (torch, and the compiler
    # stack that torch.utils.checkpoint loads at the first step) is cached
    # at a fixed path inside the checkout, so that only a checkout's first
    # run compiles it. Where the environment sets PYTHONDONTWRITEBYTECODE
    # and the installed packages hold no bytecode, every run compiled them
    # again, seconds of set-up that moved with the host's load.
    sys.pycache_prefix = str(ROOT / CACHE / "pycache")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

# Compared by whole top-level module name: the port's name begins with the
# JAX package's.
BANNED = ("jax", "jaxlib", "flax", "training_operator_tpu")
# Steps between the loop's reads of the loss (train_loop's log line).
LOG_EVERY = 5


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def fix_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout. The
    port's own kernels build into its package's `build/`, also inside."""
    base = Path(root) / CACHE
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


@dataclass
class RunView:
    """What the metric readers read (metrics/__init__.py)."""

    device_name: str
    family: object  # the cell's model family (families/__init__.py)
    dims: dict
    batch: int
    seq: int
    dtype_bytes: int
    tokens_per_step: int
    setup_s: float = 0.0
    wall_s: float = 0.0
    steps: int = 0
    step_ms: List[float] = field(default_factory=list)
    data_wait_s: List[float] = field(default_factory=list)
    peak_bytes: int = 0
    trace: Optional[object] = None
    trace_s: float = 0.0


class Feed:
    """train_loop's feed: epochs of `prefetch(loader.epoch(e), size=2)`."""

    def __init__(self, loader):
        from training_operator_tpu_torch.trainer.data import prefetch

        self._prefetch = prefetch
        self.loader = loader
        self.epoch = 0
        self.batches = prefetch(loader.epoch(0), size=2)

    def next(self):
        batch = next(self.batches, None)
        if batch is None:
            self.batches.close()
            self.epoch += 1
            self.batches = self._prefetch(self.loader.epoch(self.epoch), size=2)
            batch = next(self.batches)
        return batch

    def close(self) -> None:
        self.batches.close()


class Program:
    """The system under test, built from the cell: the state (weights from
    the seed), the step and its feed."""

    def __init__(self, cell, seed: int, device):
        from benchmark import inputs, traffic
        from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset, pack_tokens
        from training_operator_tpu_torch.trainer.train import (
            AdamW,
            make_train_step,
            template_train_state,
        )

        family, dims = cell.family, cell.dims
        self.config = family.port_config(dims, cell.run)
        self.optimizer = AdamW(**cell.run["optimizer"])
        self.state = template_train_state(self.config, self.optimizer, device)
        params = dict(self.state.model.named_parameters())
        have = {n: tuple(p.shape) for n, p in params.items()}
        want = family.param_shapes(dims)
        if have != want:
            raise RuntimeError(f"the port's parameters {have} are not the family's {want}")
        for name, p in params.items():
            inputs.fill_leaf(p.data, family, dims, name, seed)
        self.step_fn = make_train_step(self.config, self.optimizer, device)
        mix = cell.traffic
        self.stream = traffic.token_stream(mix, dims["vocab_size"], seed)
        loader = DataLoader(TokenDataset(pack_tokens(self.stream, mix["seq"])), mix["batch"],
                            shuffle=True, seed=traffic.shuffle_seed(seed), device=device)
        self.feed = Feed(loader)

    def step(self):
        batch = self.feed.next()
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def close(self) -> None:
        self.feed.close()


def first_steps(program: Program, cell, seed: int, steps: int) -> Dict[str, object]:
    """Set-up's first `steps` steps through the window's call and feed, and
    what the check compares of them: each step's loss and raw gradient norm
    (the step's own metrics), step 1's gradient as the optimizer got it
    (from its first moment, mu = (1 - b1) g), and how far each leaf moved
    in all, as device tensors; and each step's host seconds, fenced."""
    import torch

    from benchmark import inputs, reference

    out: Dict[str, object] = {"loss": [], "grad_norm": [], "seconds": []}
    for i in range(steps):
        t = time.perf_counter()
        metrics = program.step()
        _sync(metrics["loss"].device)
        out["seconds"].append(time.perf_counter() - t)
        out["loss"].append(metrics["loss"])
        out["grad_norm"].append(metrics["grad_norm"])
        if i == 0:
            out["grad_leaf"] = {n: torch.linalg.vector_norm(mu) / (1.0 - reference.B1)
                                for n, mu in program.state.opt_state.mu.items()}
    change = {}
    with torch.no_grad():
        for n, p in program.state.model.named_parameters():
            p0 = inputs.initial_leaf(p.shape, cell.family, cell.dims, n, seed, p.device)
            change[n] = torch.linalg.vector_norm(p - p0)
            del p0
    out["change_leaf"] = change
    return out


def to_floats(readings: Dict[str, object]) -> Dict[str, object]:
    out = {}
    for k, v in readings.items():
        if isinstance(v, dict):
            out[k] = {n: float(t) for n, t in v.items()}
        else:
            out[k] = [float(t) for t in v]
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """Step boundaries: CUDA events on the stream, or the host clock on a
    CPU (the tests)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self._torch = torch
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            e = self._torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def window(program: Program, view: RunView, seconds: float, device, trace: bool,
           t_start: float) -> List[float]:
    """The measured window: steps until `seconds` have passed on the host
    clock, then a device sync. Fills `view`; returns the losses the loop
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities) if trace else nullcontext()
    marks = _Marks(device)
    logged = []
    _sync(device)
    view.setup_s = time.perf_counter() - t_start
    with prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            marks.mark()
            while True:
                ta = time.perf_counter()
                with record_function("bench.data"):
                    batch = program.feed.next()
                view.data_wait_s.append(time.perf_counter() - ta)
                with record_function("bench.step"):
                    program.state, metrics = program.step_fn(program.state, batch)
                marks.mark()
                view.steps += 1
                if metrics["step"] % LOG_EVERY == 0:
                    with record_function("bench.log"):
                        logged.append(float(metrics["loss"]))
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
            view.wall_s = time.perf_counter() - t0
    view.step_ms = marks.step_ms()
    if trace:
        from benchmark import device_trace

        t = time.perf_counter()
        view.trace = device_trace.from_profiler(prof)
        view.trace_s = time.perf_counter() - t
    del batch, metrics
    if device.type == "cuda":
        view.peak_bytes = torch.cuda.max_memory_allocated(device)
    return logged


def breakdown(t, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by what
    the window's host thread was doing when each gap began."""
    ops: Dict[str, float] = {}
    for d in t.device:
        ops[d.name[:160]] = ops.get(d.name[:160], 0.0) + (d.end - d.start) / 1e9
    gaps: Dict[str, float] = {}
    for s, e in t.gaps():
        label = t.host_at(s)[:160]
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None) -> Dict[str, object]:
    """One run of `cell`: the result object the command prints."""
    import torch

    from benchmark import check, inputs, reference, traffic
    from benchmark.metrics import reader

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    steps = int(cell.limits.get("steps", 3))
    phases = {"imports": time.perf_counter() - t_start}
    # What the first step would load by itself, timed apart: torch's
    # compiler stack, which torch.utils.checkpoint imports at its first
    # call, and the port's kernels (built on a checkout's first run).
    import torch._dynamo  # noqa: F401

    phases["lazy_imports"] = time.perf_counter() - t_start - sum(phases.values())
    if device.type == "cuda":
        from training_operator_tpu_torch.trainer import kernels

        kernels.load()
        phases["kernels"] = time.perf_counter() - t_start - sum(phases.values())
    program = Program(cell, seed, device)
    _sync(device)
    phases["build"] = time.perf_counter() - t_start - sum(phases.values())
    readings = first_steps(program, cell, seed, steps)
    _sync(device)
    phases["first_steps"] = time.perf_counter() - t_start - sum(phases.values())
    print("run: first steps' seconds " + " ".join(f"{x:.2f}" for x in readings["seconds"]),
          file=sys.stderr)
    view = RunView(device_name=_device_name(device), family=cell.family, dims=cell.dims,
                   batch=cell.traffic["batch"], seq=cell.traffic["seq"],
                   dtype_bytes=torch.empty((), dtype=getattr(torch, cell.run["dtype"])).element_size(),
                   tokens_per_step=cell.traffic["batch"] * cell.traffic["seq"])
    logged = window(program, view, seconds, device, trace, t_start)
    found = banned_modules()
    if found:
        raise SystemExit(f"JAX is loaded in the measuring process: {found}")
    prog = to_floats(readings)
    stream = program.stream
    program.close()
    del program, readings
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_read = time.perf_counter()
    metrics = {}
    for m in cell.metrics(trace):
        value = reader(cell.root, m.name)(view)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    trace_obj = view.trace
    view.trace = None
    brk = breakdown(trace_obj) if trace_obj is not None else None
    phases["read"] = time.perf_counter() - t_read
    batches = inputs.reference_batches(stream, cell.traffic, traffic.shuffle_seed(seed), steps)
    t_ref = time.perf_counter()
    ref = reference.run_steps(cell.family, cell.dims, cell.run["optimizer"], seed, batches,
                              device, reference.numerics(cell.run), steps=steps)
    phases.update(window=view.wall_s, trace=view.trace_s, reference=time.perf_counter() - t_ref,
                  total=time.perf_counter() - t_start)
    print("run: seconds " + " ".join(f"{k} {v:.2f}" for k, v in phases.items()),
          file=sys.stderr)
    print(f"run: leaves left out of change_gap: {check.still_leaves(ref)}; worst "
          f"{check.worst_leaves(prog, ref)}", file=sys.stderr)
    checks, correct = check.judge(check.gaps(prog, ref), cell.limits)
    failed = sum(not math.isfinite(x) for x in logged + prog["loss"])
    result: Dict[str, object] = dict(
        correct=bool(correct and failed == 0), attempted=view.steps, failed=failed,
        metrics=metrics, device={"platform": "gpu" if device.type == "cuda" else device.type,
                                 "kind": view.device_name, "count": cell.chips,
                                 "memory_peak_bytes": view.peak_bytes})
    if trace_obj is not None:
        result["device"].update(busy_s=trace_obj.busy_s(), window_s=trace_obj.window_s)
        result["breakdown"] = brk
    result["checks"] = checks
    return result


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import spec

    cell = spec.load_cell(ROOT, args.workload)
    fix_caches(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start=T_START)
    found = banned_modules()
    if found:
        print(f"run: JAX is loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
