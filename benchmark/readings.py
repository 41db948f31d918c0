#!/usr/bin/env python3
"""The readings a cell's limits are set from (check.py), on the card at the
cell's own size:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out chiprun_out/readings.jsonl]

For each of `--seeds`: the program's first steps, as a run takes them
(run.first_steps), against the reference on the same weights and rows:
the numbers of a sound run. For each of `--control-seeds` also the control
(the reference in the precision next below the configuration's, as its
`run.control` names it) and the
planted fault of half the batch left out (the reference with its loss the
mean over the first half of the tokens), each against the sound reference
of that seed. The third fault a training cell can have on one chip, a
step that returns its state unchanged, reads 1 on `change_gap` by
definition and needs no run. One JSON line per seed and kind; no window
is measured.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def readings(cell, seeds, control_seeds, device, emit) -> None:
    """Calls `emit(line)` with {seed, kind, gaps, seconds} for each seed and
    kind: "program", and for `control_seeds` "control" and "half_batch"."""
    import torch

    from benchmark import check, inputs, reference, traffic
    from benchmark.run import Program, first_steps, to_floats

    device = torch.device(device)
    steps = int(cell.limits.get("steps", 3))
    opt, family, dims = cell.run["optimizer"], cell.family, cell.dims
    for seed in seeds:
        t = time.perf_counter()
        program = Program(cell, seed, device)
        prog = to_floats(first_steps(program, cell, seed, steps))
        stream = program.stream
        program.close()
        del program
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        batches = inputs.reference_batches(stream, cell.traffic, traffic.shuffle_seed(seed),
                                           steps)
        plain = reference.numerics(cell.run)
        ref = reference.run_steps(family, dims, opt, seed, batches, device, plain, steps=steps)
        emit({"seed": seed, "kind": "program", "gaps": check.gaps(prog, ref),
              "loss": prog["loss"], "ref_loss": ref["loss"], "grad_norm": prog["grad_norm"],
              "ref_grad_norm": ref["grad_norm"], "seconds": time.perf_counter() - t})
        if seed not in control_seeds:
            continue
        for kind, prec, half in (("control", reference.numerics(cell.run, control=True), False),
                                 ("half_batch", plain, True)):
            t = time.perf_counter()
            other = reference.run_steps(family, dims, opt, seed, batches, device, prec,
                                        steps=steps, half_batch=half)
            emit({"seed": seed, "kind": kind, "gaps": check.gaps(other, ref),
                  "loss": other["loss"], "seconds": time.perf_counter() - t})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    from benchmark import spec
    from benchmark.run import fix_caches

    cell = spec.load_cell(ROOT, args.workload)
    fix_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    parse = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(args.out, "a") if args.out else None

    def emit(line):
        line = {"workload": args.workload, **line}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    try:
        readings(cell, parse(args.seeds), set(parse(args.control_seeds)), "cuda:0", emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
