"""The distributed bootstrap: the operator's env -> a torch process group.

Counterpart of the `jax.distributed.initialize` call in
examples/trainer_standalone.py. The operator injects COORDINATOR_ADDRESS,
COORDINATOR_PORT, NUM_PROCESSES and PROCESS_ID into every worker;
`initialize` turns them into `init_process_group` (a `tcp://` rendezvous at
the coordinator, which rank 0 serves), NCCL on the card and gloo on the CPU.

One process per device: a JAX process owns all of its host's chips, a port
process owns one card, `cuda:{PROCESS_ID % device_count}`. So a host with n
cards runs n worker processes, and NUM_PROCESSES counts cards, not hosts.
The mesh (mesh.py) is built over this world; ranks are process ids.

A world of one initializes too, so a single card runs the same sharded path.
`spawn` starts a world of CPU processes over gloo on one host (the
multi-process dry run and the tests).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from training_operator_tpu_torch.trainer.model import resolve_device

BOOTSTRAP_ENV = ("COORDINATOR_ADDRESS", "COORDINATOR_PORT", "NUM_PROCESSES", "PROCESS_ID")


def initialize(environ: Optional[Mapping[str, str]] = None, device=None,
               init_method: Optional[str] = None) -> torch.device:
    """Joins the process group the bootstrap env describes and returns this
    process's device: `cuda:{PROCESS_ID % device_count}` (made current) on
    the card, the CPU when `device="cpu"`. `init_method` replaces the
    `tcp://COORDINATOR_ADDRESS:COORDINATOR_PORT` rendezvous (a `file://`
    store for processes on one host); rank and world size still come from
    the env. Raises when a variable it needs is missing."""
    e = os.environ if environ is None else environ
    need = ("NUM_PROCESSES", "PROCESS_ID") if init_method else BOOTSTRAP_ENV
    missing = [k for k in need if not e.get(k)]
    if missing:
        raise ValueError(f"distributed bootstrap: missing {', '.join(missing)} in the env")
    world, rank = int(e["NUM_PROCESSES"]), int(e["PROCESS_ID"])
    if not 0 <= rank < world:
        raise ValueError(f"PROCESS_ID {rank} outside NUM_PROCESSES {world}")
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if init_method is None:
        init_method = f"tcp://{e['COORDINATOR_ADDRESS']}:{e['COORDINATOR_PORT']}"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return device


def shutdown() -> None:
    """Leaves the process group (after a barrier, so no rank tears down its
    communicators while another still uses them)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def is_main() -> bool:
    """Rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_object(value):
    """Rank 0's `value` on every rank (the value itself without a group)."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _child(rank: int, world: int, store: str, environ: Dict[str, str], fn: Callable,
           args: Sequence[Any], results) -> None:
    os.environ.update(environ)
    os.environ.update(NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    try:
        initialize(device="cpu", init_method="file://" + store)
        out = fn(*args)
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))
    shutdown()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (),
          environ: Optional[Mapping[str, str]] = None, timeout: float = 300.0) -> List[Any]:
    """Runs `fn(*args)` in `world` new CPU processes (the `spawn` start
    method) that form one gloo world through a file store, each with
    `environ` added to its env, and returns their results in rank order.
    `fn` must be importable by name and its result picklable. Raises with
    the first failing rank's traceback; a rank that does not report within
    `timeout` seconds fails the call and every process is stopped."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="torch-world-")
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(r, world, os.path.join(tmp, "store"), dict(environ or {}), fn,
                               tuple(args), results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        for _ in range(world):
            try:
                rank, ok, out = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{world - len(got)} of {world} ranks did not report "
                                   f"within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
