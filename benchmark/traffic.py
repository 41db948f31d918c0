"""The one traffic generator: a seeded token stream, cut into rows.

A traffic mix is a JSON file under `benchmark/traffic/`, found by the
cell's `traffic` name. Its keys:

- `batch`, `seq`: rows per step and tokens per row; every step has this
  one shape, whatever the seed;
- `batches`: how many batches one epoch of the dataset holds, so the rows
  number `batch * batches`;
- `zipf_a`: the exponent of the Zipf law the token ids follow (the id of
  rank r has probability ~ r^-a). Word and subword frequencies in text
  follow Zipf's law with an exponent near 1 (Piantadosi 2014, "Zipf's word
  frequency law in natural language", Psychon. Bull. Rev. 21:1112); numpy's
  sampler needs a > 1.

The port packs the stream into rows of `seq + 1` tokens (`pack_tokens`,
inputs and targets by a shift) with no document mask, so where documents
begin and end changes no work of the step: the stream holds no document
boundaries. What reaches the step is the ids' skew, through the
embedding's gather and its backward. A seed changes the ids, never a shape.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

KEYS = ("batch", "seq", "batches", "zipf_a")


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic file {path} lacks {missing}")
    return mix


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (`stream`) of one run's seed; any
    whole number is a seed."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def token_stream(mix: dict, vocab_size: int, seed: int) -> np.ndarray:
    """The flat int32 stream: exactly enough for the dataset's rows,
    `batch * batches * (seq + 1)` Zipf-ranked ids below `vocab_size`."""
    need = mix["batch"] * mix["batches"] * (mix["seq"] + 1)
    ranks = rng_for(seed, 1).zipf(mix["zipf_a"], size=need)
    return ((ranks - 1) % vocab_size).astype(np.int32)


def shuffle_seed(seed: int) -> int:
    """The DataLoader's shuffle seed for a run: numpy's RandomState takes
    32 bits, and the loader adds the epoch to it."""
    return abs(int(seed)) % (1 << 31)
