#!/usr/bin/env python3
"""The spread of a cell's runs, from which its bounds are set:

    python3 benchmark/spread.py runs.jsonl

Each line is {"cell", "set", "seed", "result"}, `result` a run's printed
object. For every metric and set: the median and the spread, the distance
between the first and third quartile (`statistics.quantiles(values, n=4)`)
as a share of the median; then the wider of the sets' spreads and five
times it, never under 1%, the bound that spread supports. With it the
compared numbers' largest readings, and the runs that were not correct.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summarize(lines) -> dict:
    by = defaultdict(lambda: defaultdict(list))
    checks = defaultdict(list)
    wrong = []
    for line in lines:
        r = line.get("result")
        if not r:
            wrong.append((line["set"], line["seed"], "no result"))
            continue
        if not r["correct"]:
            wrong.append((line["set"], line["seed"], r.get("checks")))
        for name, m in r["metrics"].items():
            by[name][line["set"]].append(m["value"])
        for name, c in r.get("checks", {}).items():
            checks[name].append(c["value"])
    out = {"metrics": {}, "checks": {k: max(v) for k, v in checks.items()}, "wrong": wrong}
    for name, sets in by.items():
        row = {s: {"n": len(v), "median": statistics.median(v),
                   "spread": spread(v) if len(v) >= 2 else None} for s, v in sets.items()}
        widths = [r["spread"] for s, r in row.items() if s != "T" and r["spread"] is not None]
        if widths:
            row["widest"] = max(widths)
            row["bound"] = max(0.01, 5 * max(widths))
        out["metrics"][name] = row
    return out


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(summarize(json.loads(l) for l in f if l.strip()), indent=1))
