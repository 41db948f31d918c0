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


def _launch(ckpt_dir, steps):
    """The trainer entry as 2 processes with the operator's env; returns
    each one's stdout."""
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": ROOT, "COORDINATOR_ADDRESS": "127.0.0.1",
               "COORDINATOR_PORT": port, "NUM_PROCESSES": "2", "PROCESS_ID": str(rank),
               "TPU_MESH_AXES": "fsdp=2"}
        env.pop("MODEL_EXPORT_URI", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "training_operator_tpu_torch.trainer.standalone",
             "--device", "cpu", "--steps", str(steps), "--seq-len", "32", "--batch-size", "4",
             "--checkpoint-dir", str(ckpt_dir)],
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


@pytest.mark.parametrize("n,axes", [(1, {}), (2, {"tensor": 2}), (4, {"data": 2, "tensor": 2}),
                                    (8, {"data": 2, "fsdp": 2, "tensor": 2})])
def test_dryrun_pass1_factorization(n, axes):
    """JAX's pass 1 (tensor, sequence, fsdp, data by twos) with the sequence
    factor folded into data: 4 -> tensor=2,sequence=2 there."""
    assert graft_entry._pass1_axes(n) == axes


def test_dryrun_multichip_4(capsys):
    passes = graft_entry.dryrun_multichip(4)
    assert [p["label"] for p in passes] == ["dryrun_multichip(4)"]
    p = passes[0]
    assert p["mesh"] == {"pipeline": 1, "data": 2, "fsdp": 1, "expert": 1, "sequence": 1,
                         "tensor": 2}
    assert abs(p["loss"] - p["ref_loss"]) <= 5e-3 * p["ref_loss"]
    out = capsys.readouterr().out
    assert "parity ok" in out and "pp/ep" not in out  # pass 2 needs 8 processes
