"""Data pipeline: process-sharded token batches as tensors on the device.

Counterpart of training_operator_tpu/trainer/data.py. The shuffle is the JAX
loader's `RandomState(seed + epoch)` permutation, so both loaders yield the
same batches in the same order, through the numpy gather or the native C++
prefetcher (training_operator_tpu_torch/native) alike.

Under a mesh (JAX `data.py:76-150`) `batch_size` is the global batch and
each rank gathers and emits only its rows of it, the slice at its batch
coordinate over (data, fsdp, expert) (mesh.batch_coordinate), and of those
rows the slice of positions at its `sequence` coordinate: ranks that differ
only in `tensor` get the same block, and the union over the coordinates is
the batch the unsharded loader yields. On a pipeline mesh a rank's rows
are its block of every microbatch (mesh.batch_rows; `microbatches` is the
config's `pipeline_microbatches`). The dataset is then
the same on every rank; `process_shard` splits it by PROCESS_ID only for
separate single-process trainers, since a tensor peer is a process too.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch import native
from training_operator_tpu_torch.observe.spans import DATA, span
from training_operator_tpu_torch.trainer.mesh import (
    BATCH_AXES,
    batch_coordinate,
    batch_rows,
    check_sequence,
    sequence_coordinate,
)
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
    the caller names another): tokens/targets int32, mask fp32.

    `use_native`: the native C++ gather (real OS threads copy the shuffled
    rows out of the possibly memory-mapped arena, the NEXT batch gathered
    while the current one is emitted). None takes it where it builds and the
    rows are C-contiguous int32, as the JAX loader does; True requires it
    and raises when it does not build. The batches are the same either
    way. `mesh`: see the module docstring. Under a profiler, producing each
    batch (the gather's wait, slicing, pinning, the copy's launch) is a range
    `data.next` (observe/spans.py)."""

    def __init__(self, dataset: TokenDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, device=None,
                 use_native: Optional[bool] = None, mesh: Optional[DeviceMesh] = None,
                 microbatches: int = 0):
        if batch_size > len(dataset):
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset shard of {len(dataset)} rows"
            )
        # This rank's rows of every global batch (None: all of them), and
        # its positions [pos, pos + seq) of each row (seq None: all of them).
        self.rows: Optional[np.ndarray] = None
        self.pos, self.seq = 0, None
        if mesh is not None:
            if not drop_last:
                # A partial tail batch cannot be split over the batch axes;
                # fail at construction, not mid-epoch.
                raise ValueError("drop_last=False is incompatible with a sharded mesh")
            _, count = batch_coordinate(mesh)
            if batch_size % count:
                raise ValueError(f"batch_size {batch_size} does not split over the batch "
                                 f"axes {BATCH_AXES} ({count} shards)")
            self.rows = batch_rows(mesh, batch_size, microbatches)
            s_index, s_count = sequence_coordinate(mesh)
            if s_count > 1:
                row = dataset.rows.shape[1] - 1
                check_sequence(row, mesh)
                self.seq = row // s_count
                self.pos = s_index * self.seq
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.device = resolve_device(device)
        rows = dataset.rows
        fits = rows.dtype == np.int32 and rows.flags.c_contiguous
        if use_native is None:
            use_native = fits and native.available()
        elif use_native and not native.available():
            raise RuntimeError(f"use_native=True but the native dataio did not build: "
                               f"{native.build_error()}")
        self.use_native = use_native

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self.epoch(0)

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        rows = self.dataset.rows
        order = np.arange(len(rows))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        end = (len(rows) // self.batch_size) * self.batch_size if self.drop_last else len(rows)
        starts = list(range(0, end, self.batch_size))
        if self.use_native and starts:
            with native.Prefetcher(rows) as pf:
                pf.submit(self._take(order, starts[0]))
                for i, start in enumerate(starts):
                    with span(DATA):
                        chunk = pf.wait()
                        if i + 1 < len(starts):
                            pf.submit(self._take(order, starts[i + 1]))
                        batch = self._emit(chunk)
                    yield batch
            return
        for start in starts:
            with span(DATA):
                batch = self._emit(rows[self._take(order, start)])
            yield batch

    def _take(self, order: np.ndarray, start: int) -> np.ndarray:
        """The dataset rows of this rank's part of the batch at `start`."""
        if self.rows is None:
            return order[start:start + self.batch_size]
        return order[start + self.rows]

    def _emit(self, chunk: np.ndarray) -> Dict[str, torch.Tensor]:
        end = chunk.shape[1] - 1 if self.seq is None else self.pos + self.seq
        batch = {
            "tokens": np.ascontiguousarray(chunk[:, self.pos:end]),
            "targets": np.ascontiguousarray(chunk[:, self.pos + 1:end + 1]),
            "mask": np.ones((chunk.shape[0], end - self.pos), dtype=np.float32),
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
