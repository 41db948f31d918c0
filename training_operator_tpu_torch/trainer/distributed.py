"""The distributed bootstrap: the operator's env -> a torch process group.

Counterpart of the `jax.distributed.initialize` call in
examples/trainer_standalone.py. The operator injects COORDINATOR_ADDRESS,
COORDINATOR_PORT, NUM_PROCESSES and PROCESS_ID into every worker;
`initialize` turns them into `init_process_group` (a `tcp://` rendezvous at
the coordinator, which rank 0 serves), NCCL on the card and gloo on the CPU.

The operator runs one process per pod (NUM_PROCESSES pods, PROCESS_ID the
pod's index), as a JAX process owns all of its host's chips. A port process
drives one card, so the pod's process starts one worker per local card
(`worker_env`, torchrun's arithmetic): worker i of `local` has rank
PROCESS_ID x local + i in a world of NUM_PROCESSES x local and drives
`cuda:i`. The mesh (mesh.py) is built over this world of workers.

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


def worker_env(environ: Mapping[str, str], local: int, i: int) -> Dict[str, str]:
    """The bootstrap env of worker i of a pod that runs `local` workers:
    PROCESS_ID and NUM_PROCESSES rewritten to the worker's rank and the
    world of workers (NUM_PROCESSES, PROCESS_ID default to 1 and 0)."""
    pods, pod = int(environ.get("NUM_PROCESSES", "1")), int(environ.get("PROCESS_ID", "0"))
    if not 0 <= i < local:
        raise ValueError(f"worker {i} outside the pod's {local} workers")
    return {**environ, "NUM_PROCESSES": str(pods * local), "PROCESS_ID": str(pod * local + i)}


def initialize(environ: Optional[Mapping[str, str]] = None, device=None,
               init_method: Optional[str] = None) -> torch.device:
    """Joins the process group the bootstrap env describes (a worker's env:
    `worker_env`) and returns this process's device: on the card `device`
    with its index (`cuda:i` for worker i), or the current card for a bare
    "cuda", made current; the CPU when `device="cpu"`. `init_method`
    replaces the `tcp://COORDINATOR_ADDRESS:COORDINATOR_PORT` rendezvous (a
    `file://` store for processes on one host); rank and world size still
    come from the env. Raises when a variable it needs is missing."""
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
        index = torch.cuda.current_device() if device.index is None else device.index
        device = torch.device("cuda", index)
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
