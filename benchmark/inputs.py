"""The inputs the benchmark makes from `--seed` and hands to both sides:
the initial weights and the token stream (traffic.py).

Weights: every parameter is drawn on the device by a generator of its own,
seeded from the run's seed and the parameter's name, in one call, in fp32
(the type the state keeps). So any one leaf can be drawn again alone, by
the program's set-up to measure how far it moved and by the reference
after the window, without holding a second copy of the model. The
distribution is the model family's (`leaf_init`): a normal draw of the
family's std, or ones for a norm scale.

Batches for the reference: the rows the DataLoader should emit, worked out
again from the stream: rows of `seq + 1` tokens, shuffled by
`RandomState(shuffle_seed + epoch)`, inputs and targets by a shift.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np
import torch


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@torch.no_grad()
def fill_leaf(t: torch.Tensor, family, dims: dict, name: str, seed: int) -> torch.Tensor:
    """Writes leaf `name`'s initial value into `t` (fp32, on its device), as
    the model `family` draws it."""
    std = family.leaf_init(dims, name)
    if std is None:
        return t.fill_(1.0)
    g = torch.Generator(device=t.device).manual_seed(leaf_seed(seed, name))
    return t.normal_(0.0, std, generator=g)


def initial_leaf(shape, family, dims: dict, name: str, seed: int, device) -> torch.Tensor:
    return fill_leaf(torch.empty(shape, dtype=torch.float32, device=device), family, dims,
                     name, seed)


def reference_batches(stream: np.ndarray, mix: dict, shuffle_seed: int,
                      count: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The first `count` batches of epoch 0 as (inputs, targets) int64
    arrays [batch, seq]."""
    row = mix["seq"] + 1
    rows = stream[: len(stream) // row * row].reshape(-1, row)
    order = np.arange(len(rows))
    np.random.RandomState(shuffle_seed).shuffle(order)
    b = mix["batch"]
    out = []
    for i in range(count):
        chunk = rows[order[i * b:(i + 1) * b]].astype(np.int64)
        out.append((chunk[:, :-1], chunk[:, 1:]))
    return out

