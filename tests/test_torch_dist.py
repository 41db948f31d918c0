"""The port's multi-process bootstrap, trainer entry and dry run, on the CPU.

The operator's env (COORDINATOR_ADDRESS, COORDINATOR_PORT, NUM_PROCESSES,
PROCESS_ID, TPU_MESH_AXES) becomes a gloo process group
(distributed.initialize); `python -m training_operator_tpu_torch.trainer.standalone`
runs as two such processes and resumes after a relaunch; the graft entry's
`dryrun_multichip(4)` holds the sharded loss to the single-process loss.
"""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

import torch_mesh_workers as workers
from training_operator_tpu_torch import graft_entry
from training_operator_tpu_torch.trainer import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,message", [
    ({"NUM_PROCESSES": "2", "PROCESS_ID": "0"}, "missing COORDINATOR_ADDRESS, COORDINATOR_PORT"),
    ({"COORDINATOR_ADDRESS": "127.0.0.1", "COORDINATOR_PORT": "1", "NUM_PROCESSES": "2"},
     "missing PROCESS_ID"),
    ({"COORDINATOR_ADDRESS": "127.0.0.1", "COORDINATOR_PORT": "1", "NUM_PROCESSES": "2",
      "PROCESS_ID": "2"}, "PROCESS_ID 2 outside NUM_PROCESSES 2"),
])
def test_initialize_refuses_an_incomplete_env(env, message):
    with pytest.raises(ValueError, match=message):
        distributed.initialize(env, device="cpu")


def test_spawn_reports_a_failing_rank_and_stops_the_others():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed"):
        distributed.spawn(workers.fail_on_rank, 3, (1,), timeout=60)
    assert time.monotonic() - t < 60


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(ckpt_dir, steps, pods=2, axes="fsdp=2", local_workers=None, extra_env=None):
    """The trainer entry as `pods` processes with the operator's env (each
    with `--local-workers` when given); returns each one's stdout."""
    port = str(_free_port())
    procs = []
    local = [] if local_workers is None else ["--local-workers", str(local_workers)]
    for rank in range(pods):
        env = {**os.environ, "PYTHONPATH": ROOT, "COORDINATOR_ADDRESS": "127.0.0.1",
               "COORDINATOR_PORT": port, "NUM_PROCESSES": str(pods), "PROCESS_ID": str(rank),
               "TPU_MESH_AXES": axes, **(extra_env or {})}
        env.pop("MODEL_EXPORT_URI", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "training_operator_tpu_torch.trainer.standalone",
             "--device", "cpu", "--steps", str(steps), "--seq-len", "32", "--batch-size", "4",
             "--checkpoint-dir", str(ckpt_dir), *local],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def test_entry_runs_as_two_processes_and_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    first = _launch(ckpt, 4)
    mesh = "mesh: {'pipeline': 1, 'data': 1, 'fsdp': 2, 'expert': 1, 'sequence': 1, 'tensor': 1}"
    for out in first:
        lines = out.splitlines()
        assert lines[0] == mesh and lines[-1] == "done at step 4"
        assert not any("resumed" in line for line in lines)
    assert first[0] == first[1]  # the same global loss on both ranks
    second = _launch(ckpt, 6)
    for out in second:
        lines = out.splitlines()
        assert lines[:2] == [mesh, "resumed at step 4"] and lines[-1] == "done at step 6"
    assert second[0] == second[1]
    assert sorted(n for n in os.listdir(ckpt) if n.isdigit()) == ["4", "6"]
    # One data file per rank, one metadata file, and no partial writes left.
    assert sorted(os.listdir(ckpt / "6")) == [".metadata", "__0_0.distcp", "__1_0.distcp"]


def test_pods_start_one_worker_per_local_card(tmp_path):
    """The operator runs one process per pod (NUM_PROCESSES pods); each
    starts its local workers with torchrun's ranks. Two pods of two workers
    on fsdp=2,tensor=2 train as a world of four processes does: the same
    loss lines, and a final checkpoint equal bit for bit (one intra-op
    thread on both sides, so the CPU sums run in one order)."""
    from training_operator_tpu_torch.trainer.checkpoint import restore_into_mesh
    from training_operator_tpu_torch.trainer.standalone import standalone_config
    from training_operator_tpu_torch.trainer.train import make_optimizer, state_dict

    env = {"OMP_NUM_THREADS": "1"}
    pods = _launch(tmp_path / "pods", 3, pods=2, axes="fsdp=2,tensor=2", local_workers=2,
                   extra_env=env)
    world = _launch(tmp_path / "world", 3, pods=4, axes="fsdp=2,tensor=2", extra_env=env)
    lines = [sorted(line for out in outs for line in out.splitlines()) for outs in (pods, world)]
    assert lines[0] == lines[1]
    assert lines[0].count("done at step 3") == 4 and any("step 3 loss" in x for x in lines[0])
    states = [state_dict(restore_into_mesh(str(tmp_path / d), standalone_config(32),
                                           make_optimizer(), device="cpu"))
              for d in ("pods", "world")]
    for key, value in states[1].items():
        assert torch.equal(states[0][key], value), key


@pytest.mark.parametrize("n,axes", [(1, {}), (2, {"tensor": 2}), (4, {"tensor": 2, "sequence": 2}),
                                    (8, {"tensor": 2, "sequence": 2, "fsdp": 2}),
                                    (16, {"tensor": 2, "sequence": 2, "fsdp": 2, "data": 2})])
def test_dryrun_pass1_factorization(n, axes):
    """JAX's pass 1: tensor, sequence, fsdp by twos, the rest on data."""
    assert graft_entry._pass1_axes(n) == axes


def test_dryrun_multichip_4(capsys):
    passes = graft_entry.dryrun_multichip(4)
    assert [p["label"] for p in passes] == ["dryrun_multichip(4)"]
    p = passes[0]
    assert p["mesh"] == {"pipeline": 1, "data": 1, "fsdp": 1, "expert": 1, "sequence": 2,
                         "tensor": 2}
    assert abs(p["loss"] - p["ref_loss"]) <= 5e-3 * p["ref_loss"]
    out = capsys.readouterr().out
    assert "parity ok" in out and "pp/ep" not in out  # pass 2 needs 8 processes
