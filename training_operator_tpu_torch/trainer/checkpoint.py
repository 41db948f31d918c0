"""Checkpoint and restore of the whole TrainState on torch.distributed.checkpoint.

Counterpart of training_operator_tpu/trainer/checkpoint.py, which drives an
orbax CheckpointManager. The port keeps that file's surface and the manager's
decisions, call for call (tests/test_torch_checkpoint.py drives both through
the same calls):

- layout `<dir>/<step>/` (a DCP checkpoint: `.metadata` plus data files),
  written to `<dir>/<step>.tmp-<pid>` and renamed into place, so a step
  directory is always complete;
- the steps known to the manager are a list in the order of their saves;
  `reload()` reads them from the disk in step order; `latest_step()` is the
  last of the list;
- an unforced save is declined when the latest step is at or above it, and
  otherwise made when the step is a multiple of `save_interval_steps` or no
  step is known yet (orbax's FixedIntervalPolicy and InitialSavePolicy);
  `force=True` skips that decision;
- after a save, all but the last `max_to_keep` steps of the list are
  deleted (orbax's LatestN; None keeps all);
- saving onto an existing step overwrites it crash-safely: the old step is
  moved aside to `<dir>.stale.<step>` and deleted only once the replacement
  is written; a declined overwrite puts it back; a Checkpointer constructed
  after a preemption in between recovers the moved-aside copy.

A restore loads in place into a template's tensors, so it lands on the
template's device and dtypes. Saves are synchronous: `save` returns after
the files are written and synced.

Under a process group (JAX `checkpoint.py:119-135`) every rank makes the
same calls: DCP writes each rank's shards of a sharded state (its DTensors,
train.state_dict) into one step directory on a filesystem all ranks share,
and restores into any template, sharded on another mesh or not sharded, by
resharding on read (`restore_into_mesh`, the elastic resize path). The
steps known to the manager are rank 0's reading of the disk, broadcast, so
every rank takes the same save decisions; rank 0 alone renames, deletes and
recovers, each behind a barrier.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from typing import List, Optional

import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.trainer.distributed import broadcast_object, is_main
from training_operator_tpu_torch.trainer.model import TransformerConfig
from training_operator_tpu_torch.trainer.train import (
    TrainState,
    load_state_dict,
    state_dict,
    template_train_state,
)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextlib.contextmanager
def _single_process():
    """DCP without a process group saves and loads in this process alone;
    it warns that it assumes so, which is what the port means."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*assuming the intent is to.*single process")
        yield


def _dcp_context():
    return contextlib.nullcontext() if dist.is_initialized() else _single_process()


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        if is_main():
            self._recover_interrupted_overwrites()
            os.makedirs(self.directory, exist_ok=True)  # as orbax's manager does
        _barrier()
        self._tmp_tag = broadcast_object(os.getpid())  # names rank 0's partial writes
        self._steps: List[int] = []
        self.reload()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _recover_interrupted_overwrites(self) -> None:
        """If a previous process was preempted between moving a step aside
        and finishing its replacement save, the only durable copy of that
        step lives in `<dir>.stale.<step>`. Restore it so auto-resume sees
        it; if the replacement did land, just drop the stale copy. Partial
        writes (`<step>.tmp-*`) of a dead process are removed."""
        parent = os.path.dirname(self.directory)
        prefix = os.path.basename(self.directory) + ".stale."
        if not os.path.isdir(parent):
            return
        for name in os.listdir(parent):
            if not name.startswith(prefix):
                continue
            stale = os.path.join(parent, name)
            dst = self._step_dir(int(name[len(prefix):]))
            if os.path.isdir(dst):
                shutil.rmtree(stale, ignore_errors=True)
            else:
                os.makedirs(self.directory, exist_ok=True)
                os.rename(stale, dst)
        if os.path.isdir(self.directory):
            for name in os.listdir(self.directory):
                if ".tmp-" in name:
                    shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def reload(self) -> None:
        """Re-reads the steps on the disk, in step order (rank 0 reads)."""
        steps = []
        if is_main() and os.path.isdir(self.directory):
            steps = [int(n) for n in os.listdir(self.directory)
                     if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, ".metadata"))]
        self._steps = broadcast_object(sorted(steps))

    def all_steps(self) -> List[int]:
        return list(self._steps)

    def latest_step(self) -> Optional[int]:
        return self._steps[-1] if self._steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0 or not self._steps

    def save(self, state: TrainState, step: Optional[int] = None,
             force: bool = False) -> bool:
        """`force=True` bypasses save_interval_steps: the final save, which
        would otherwise be skipped on an off-interval step. Saving onto an
        existing step overwrites it, crash-safely (see the module
        docstring). Returns whether a checkpoint was written."""
        step = int(state.step) if step is None else step
        stale = None
        overwrite = step in self._steps
        if overwrite:
            if is_main():
                src = self._step_dir(step)
                stale = self.directory + f".stale.{step}"
                if os.path.isdir(stale):  # leftover from an interrupted overwrite
                    shutil.rmtree(stale)
                if os.path.isdir(src):
                    os.rename(src, stale)
                else:
                    stale = None
            _barrier()
            self.reload()
        saved = self._write(state, step, force)
        if overwrite:
            if stale is not None:
                if saved:
                    shutil.rmtree(stale, ignore_errors=True)
                else:
                    # Declined (an unforced off-interval write): the moved-aside
                    # copy is still the only one, so put it back.
                    os.rename(stale, self._step_dir(step))
            _barrier()
            if not saved:
                self.reload()
        return saved

    def _write(self, state: TrainState, step: int, force: bool) -> bool:
        if not force and not self.should_save(step):
            return False
        if step in self._steps:
            raise FileExistsError(f"checkpoint for step {step} already exists")
        tmp = os.path.join(self.directory, f"{step}.tmp-{self._tmp_tag}")
        with _dcp_context():
            dcp.save(state_dict(state), checkpoint_id=tmp)
        _barrier()  # every rank's files are written
        self._steps.append(step)
        drop = []
        if self.max_to_keep is not None and len(self._steps) > self.max_to_keep:
            drop = self._steps[: len(self._steps) - self.max_to_keep]
            self._steps = self._steps[len(drop):]
        if is_main():
            os.rename(tmp, self._step_dir(step))
            _fsync_dir(self.directory)
            for old in drop:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        _barrier()
        return True

    def step_bytes(self, step: int) -> int:
        """Bytes on the disk of one step's checkpoint."""
        root = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, files in os.walk(root) for f in files)

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Loads a step (the latest by default) in place into `template`'s
        tensors, on its device and dtypes, and returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        flat = state_dict(template)
        with _dcp_context():
            dcp.load(flat, checkpoint_id=self._step_dir(step))
        return load_state_dict(template, flat)

    def close(self) -> None:
        """Nothing is left running after a save; kept for the JAX surface."""


def restore_into_mesh(directory: str, config: TransformerConfig, optimizer,
                      mesh: Optional[DeviceMesh] = None, step: Optional[int] = None,
                      device=None) -> TrainState:
    """Restore into a zero-filled template (no init compute) laid out on
    `mesh`, the new mesh of a resized job, or unsharded without one: the
    resume path after a preemption or an elastic resize. DCP reshards on
    read, whatever mesh wrote the checkpoint."""
    template = template_train_state(config, optimizer, device, mesh)
    ckpt = Checkpointer(directory)
    try:
        return ckpt.restore(template, step=step)
    finally:
        ckpt.close()
