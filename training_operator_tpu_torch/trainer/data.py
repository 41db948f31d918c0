"""Data pipeline: process-sharded token batches as tensors on the device.

Counterpart of training_operator_tpu/trainer/data.py, numpy gather path only
(the native C++ prefetcher is not ported yet). The shuffle is the JAX
loader's `RandomState(seed + epoch)` permutation, so both loaders yield the
same batches in the same order.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from training_operator_tpu_torch.trainer.model import resolve_device


def process_shard(environ: Optional[Dict[str, str]] = None) -> Tuple[int, int]:
    """(process_id, num_processes) from the operator-injected bootstrap env."""
    e = os.environ if environ is None else environ
    return int(e.get("PROCESS_ID", "0")), int(e.get("NUM_PROCESSES", "1"))


def pack_tokens(tokens: np.ndarray, seq_len: int) -> np.ndarray:
    """Pack a flat token stream into [N, seq_len+1] rows (input+target via
    shift); the trailing remainder is dropped."""
    row = seq_len + 1
    n = len(tokens) // row
    return np.asarray(tokens[: n * row], dtype=np.int32).reshape(n, row)


class TokenDataset:
    """Fixed-length LM rows with deterministic per-process sharding."""

    def __init__(self, rows: np.ndarray, process_id: int = 0, num_processes: int = 1):
        # Equal-size contiguous shards, remainder dropped: every process sees
        # the same number of batches.
        per = len(rows) // num_processes
        self.rows = rows[process_id * per : (process_id + 1) * per]

    @classmethod
    def synthetic(cls, vocab_size: int, seq_len: int, num_rows: int, seed: int = 0,
                  process_id: int = 0, num_processes: int = 1) -> "TokenDataset":
        rng = np.random.RandomState(seed)
        rows = rng.randint(0, vocab_size, size=(num_rows, seq_len + 1)).astype(np.int32)
        return cls(rows, process_id, num_processes)

    @classmethod
    def from_env(cls, rows: np.ndarray) -> "TokenDataset":
        pid, n = process_shard()
        return cls(rows, pid, n)

    @classmethod
    def from_token_file(cls, path: str, seq_len: int, process_id: int = 0,
                        num_processes: int = 1) -> "TokenDataset":
        """Memory-map a flat int32 token file and view it as packed LM rows."""
        flat = np.memmap(path, dtype=np.int32, mode="r")
        row = seq_len + 1
        n = len(flat) // row
        return cls(flat[: n * row].reshape(n, row), process_id, num_processes)

    def __len__(self) -> int:
        return len(self.rows)


class DataLoader:
    """Yields {tokens, targets, mask} tensors on `device` (the card unless
    the caller names another): tokens/targets int32, mask fp32."""

    def __init__(self, dataset: TokenDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, device=None):
        if batch_size > len(dataset):
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset shard of {len(dataset)} rows"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.epoch(0)

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        rows = self.dataset.rows
        order = np.arange(len(rows))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        end = (len(rows) // self.batch_size) * self.batch_size if self.drop_last else len(rows)
        for start in range(0, end, self.batch_size):
            yield self._emit(rows[order[start : start + self.batch_size]])

    def _emit(self, chunk: np.ndarray) -> Dict[str, torch.Tensor]:
        batch = {
            "tokens": np.ascontiguousarray(chunk[:, :-1]),
            "targets": np.ascontiguousarray(chunk[:, 1:]),
            "mask": np.ones((chunk.shape[0], chunk.shape[1] - 1), dtype=np.float32),
        }
        cuda = self.device.type == "cuda"
        out = {}
        for name, arr in batch.items():
            t = torch.from_numpy(arr)
            if cuda:  # pinned host memory lets the copy run asynchronously
                t = t.pin_memory()
            out[name] = t.to(self.device, non_blocking=cuda)
        return out


def prefetch(batches: Iterator[Dict[str, torch.Tensor]], size: int = 2
             ) -> Iterator[Dict[str, torch.Tensor]]:
    """Keep `size` batches issued ahead of the consumer so host-side slicing
    and the asynchronous host-to-device copies overlap the running step.
    Wrap a DataLoader epoch: `for batch in prefetch(loader.epoch(e), 2): ...`."""
    buf = collections.deque()
    it = iter(batches)
    for _ in range(max(1, size)):
        try:
            buf.append(next(it))
        except StopIteration:
            break
    while buf:
        out = buf.popleft()
        try:
            buf.append(next(it))
        except StopIteration:
            pass
        yield out
