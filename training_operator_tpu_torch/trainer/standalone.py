"""The trainer-image entry: what runs inside a scheduled job's pod.

Counterpart of examples/trainer_standalone.py:

    python -m training_operator_tpu_torch.trainer.standalone [--steps N]
        [--seq-len S] [--batch-size B] [--checkpoint-dir DIR] [--resume]
        [--device cpu] [--local-workers N]

It reads the bootstrap env the operator injects (COORDINATOR_ADDRESS,
COORDINATOR_PORT, NUM_PROCESSES, PROCESS_ID, TPU_MESH_AXES,
MODEL_EXPORT_URI). The operator runs one such process per pod; it starts
one worker process per local card (`--local-workers`, by default every
card of the pod; 1 with `--device cpu`), each with its rank in the world of
workers (distributed.worker_env) and its card `cuda:i`; one worker runs in
the process itself. With a coordinator address or more than one worker in
the world, each worker joins the process group (distributed.initialize,
gloo with `--device cpu`), builds the mesh (mesh_from_env; `pipeline` and
`expert` axes included) and trains the state sharded on it; `--batch-size`
is the global batch. It resumes from the
newest checkpoint whenever one exists, onto this run's mesh, runs
`train_loop` and exports the final step from worker 0. It runs on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from training_operator_tpu_torch.trainer import distributed
from training_operator_tpu_torch.trainer.checkpoint import Checkpointer, restore_into_mesh
from training_operator_tpu_torch.trainer.data import (
    DataLoader,
    TokenDataset,
    prefetch,
    process_shard,
)
from training_operator_tpu_torch.trainer.mesh import mesh_from_env, mesh_shape
from training_operator_tpu_torch.trainer.model import TransformerConfig, resolve_device
from training_operator_tpu_torch.trainer.train import (
    AdamW,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)


def train_loop(config: TransformerConfig, optimizer: AdamW, state: TrainState,
               loader: DataLoader, steps: int, ckpt: Checkpointer,
               step_fn: Optional[Callable] = None, save_every: int = 10,
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Trains `state` in place up to global step `steps`, as the JAX loop
    does line for line: epochs of `prefetch(loader.epoch(epoch), size=2)`
    with the epoch counter starting at 0 (after a resume too), a log line
    every 5 steps and at the last, an interval save every `save_every`
    steps, and a forced save of the final step (which overwrites the
    interval save when they coincide).

    Returns the loop's accounting: `done` (the final step), `steps_run`,
    `saves`, `wall_s`, `data_s` (host time waiting for the next batch),
    `ckpt_s` (time in saves, measured after the device finished the step
    before) and `last_metrics`."""
    step_fn = step_fn or make_train_step(config, optimizer, device=loader.device,
                                         mesh=state.model.mesh)
    cuda = loader.device.type == "cuda"

    def fence():
        if cuda:
            torch.cuda.synchronize(loader.device)

    stats = {"steps_run": 0, "saves": 0, "data_s": 0.0, "ckpt_s": 0.0}

    def save(force: bool = False) -> None:
        fence()
        t = time.perf_counter()
        if ckpt.save(state, force=force):
            stats["saves"] += 1
        stats["ckpt_s"] += time.perf_counter() - t

    t_start = time.perf_counter()
    done = int(state.step)
    metrics: Dict[str, Any] = {}
    epoch = 0
    while done < steps:
        batches = prefetch(loader.epoch(epoch), size=2)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            stats["data_s"] += time.perf_counter() - t
            if batch is None:
                break
            state, metrics = step_fn(state, batch)
            stats["steps_run"] += 1
            done = int(metrics["step"])
            if done % 5 == 0 or done == steps:
                log(f"step {done} loss {float(metrics['loss']):.4f}")
            if done % save_every == 0:
                save()
            if done >= steps:
                break
        batches.close()
        epoch += 1
    save(force=True)  # final save regardless of interval
    fence()
    stats.update(done=done, wall_s=time.perf_counter() - t_start, last_metrics=metrics)
    return stats


def export_final(checkpoint_dir: str, done: int,
                 environ: Optional[Dict[str, str]] = None) -> Optional[str]:
    """When the operator injected MODEL_EXPORT_URI, push the final step's
    checkpoint directory (only that one: retention keeps up to three, and
    consumers want one model, not a history) through the export providers.
    Process 0 only. Returns the uri exported to, or None."""
    from training_operator_tpu_torch.export import upload

    e = os.environ if environ is None else environ
    uri = e.get("MODEL_EXPORT_URI")
    if not uri or int(e.get("PROCESS_ID", "0")) != 0:
        return None
    final_dir = os.path.join(checkpoint_dir, str(done))
    if not os.path.isdir(final_dir):
        raise SystemExit(f"export: final checkpoint dir {final_dir} not found; "
                         "refusing to upload the whole retention history")
    return upload(final_dir, uri)


def standalone_config(seq_len: int) -> TransformerConfig:
    """The trainer image's model: the JAX example's small decoder."""
    return TransformerConfig(vocab_size=4096, d_model=256, n_layers=4, n_heads=8,
                             d_ff=688, max_seq_len=seq_len)


def main(argv=None) -> Optional[TrainState]:
    """Runs the pod's workers; returns the trained state of a pod of one
    worker (None when it started several)."""
    ap = argparse.ArgumentParser(prog="python -m training_operator_tpu_torch.trainer.standalone")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "trainer-ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--local-workers", type=int, default=None,
                    help="worker processes in this pod, one per card (default: the "
                         "pod's cards; 1 with --device cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    local = args.local_workers
    if local is None:
        local = torch.cuda.device_count() if device.type == "cuda" else 1
    if local < 1:
        raise ValueError(f"--local-workers {local}: a pod runs at least one worker")
    env = dict(os.environ)
    if local == 1:
        return _worker(args, device, distributed.worker_env(env, 1, 0))
    if not env.get("COORDINATOR_ADDRESS") and int(env.get("NUM_PROCESSES", "1")) == 1:
        # One pod alone: its workers meet on this host.
        env.update(COORDINATOR_ADDRESS="127.0.0.1", COORDINATOR_PORT=str(_free_port()))
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for i in range(local):
        worker_device = str(torch.device(device.type, i) if device.type == "cuda" else device)
        procs.append(ctx.Process(target=_pod_worker,
                                 args=(args, worker_device, distributed.worker_env(env, local, i))))
    _run_workers(procs)
    return None


def _say(*parts) -> None:
    """print, as one write: the workers of a pod share its stdout, and an
    unbuffered print writes its pieces apart, which interleave."""
    sys.stdout.write(" ".join(str(p) for p in parts) + "\n")
    sys.stdout.flush()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(procs) -> None:
    """Starts the pod's workers and waits for them; when one fails, the
    others are stopped (they would wait for it in a collective) and the
    pod fails."""
    for p in procs:
        p.start()
    try:
        running = list(procs)
        while running:
            multiprocessing.connection.wait([p.sentinel for p in running])
            for p in [p for p in running if not p.is_alive()]:
                running.remove(p)
                if p.exitcode != 0:
                    raise SystemExit(f"worker {procs.index(p)} of {len(procs)} exited with "
                                     f"code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def _pod_worker(args, device: str, environ: Dict[str, str]) -> None:
    _worker(args, torch.device(device), environ)


def _worker(args, device: torch.device, environ: Mapping[str, str]) -> TrainState:
    """One worker: `environ` is its bootstrap env (distributed.worker_env)."""
    os.environ.update(environ)
    _, nproc = process_shard()
    mesh = None
    if os.environ.get("COORDINATOR_ADDRESS") or nproc > 1:
        device = distributed.initialize(device=device)
        mesh = mesh_from_env(device.type)
        _say("mesh:", mesh_shape(mesh))
    state = _train(args, device, mesh)
    distributed.shutdown()
    return state


def _train(args, device: torch.device, mesh) -> TrainState:
    config = standalone_config(args.seq_len)
    optimizer = make_optimizer(total_steps=args.steps)
    # Auto-resume whenever checkpoints exist: a preempted pod restarts with
    # the same command, so requiring --resume would turn every preemption
    # into a crash loop. --resume stays for explicitness.
    have_ckpt = distributed.broadcast_object(os.path.isdir(args.checkpoint_dir) and any(
        name.isdigit() for name in os.listdir(args.checkpoint_dir)
    ))
    if args.resume or have_ckpt:
        state = restore_into_mesh(args.checkpoint_dir, config, optimizer, mesh, device=device)
        _say("resumed at step", state.step)
    else:
        state = init_train_state(config, optimizer, device=device, mesh=mesh)

    # Under a mesh every rank holds the whole dataset and the loader takes
    # the rank's rows of each global batch.
    dataset = TokenDataset.synthetic(config.vocab_size, args.seq_len,
                                     num_rows=args.batch_size * 8)
    loader = DataLoader(dataset, args.batch_size, device=device, mesh=mesh,
                        microbatches=config.pipeline_microbatches)
    ckpt = Checkpointer(args.checkpoint_dir, save_interval_steps=10)
    stats = train_loop(config, optimizer, state, loader, args.steps, ckpt, log=_say)
    ckpt.close()
    exported = export_final(args.checkpoint_dir, stats["done"])
    if exported:
        _say("exporting to", exported)
    _say("done at step", stats["done"])
    return state


if __name__ == "__main__":
    main()
