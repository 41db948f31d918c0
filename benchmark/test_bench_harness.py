"""The harness end to end on a tiny cell on the CPU: a sound run is
correct, each fault a training cell can have on one chip is not, the
control fails, a new cell and metric are found by name, and nothing it
runs loads JAX."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run, spec
from benchmark.check import NUMBERS
from benchmark.readings import readings
from benchmark.tiny import CELL, LIMITS, REPO, make_root


@pytest.fixture
def tiny(tmp_path):
    return spec.load_cell(make_root(tmp_path), CELL)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(tiny, trace):
    # A window of several steps, so that `step_ms_p90` has two to read on a
    # loaded host too.
    result = run.run_cell(tiny, 2**31 + 5, 3.0, trace, "cpu")
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {k for k in LIMITS if k != "steps"}
    if trace:
        assert "data_wait_ms" in result["metrics"]
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert "breakdown" in result
    else:
        assert {"tokens_per_s", "step_ms_p90", "setup_s"} <= set(result["metrics"])


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer reports the
    norm and moves nothing."""
    from training_operator_tpu_torch.trainer import train

    def update(self, grads, state, params, mesh=None, specs=None):
        return train.global_norm(grads)

    monkeypatch.setattr(train.AdamW, "update", update)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from training_operator_tpu_torch.trainer import train

    whole = train.loss_fn

    def loss_fn(model, batch, config=None):
        half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return whole(model, half, config)

    monkeypatch.setattr(train, "loss_fn", loss_fn)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    result = run.run_cell(tiny, 17, 0.5, False, "cpu")
    assert result["correct"] is False, result["checks"]


def test_control_fails_and_program_passes(tiny):
    lines = []
    readings(tiny, [1, 2, 3, 21], {1, 2, 3}, "cpu", lines.append)
    for line in lines:
        over = [k for k in LIMITS if k != "steps" and line["gaps"][k] > LIMITS[k]]
        assert bool(over) == (line["kind"] != "program"), line


def test_new_cell_traffic_and_metric_are_found_by_name(tmp_path):
    """A later cell adds a traffic file, a limits file, a metric reader and
    entries in BENCHMARK.json; no file of the harness changes."""
    root = make_root(tmp_path)
    bench = root / "benchmark"
    mix = json.loads((bench / "traffic" / "tiny.json").read_text())
    (bench / "traffic" / "tiny_long.json").write_text(json.dumps(dict(mix, seq=48, batch=1)))
    (bench / "limits" / "tiny.long.json").write_text(json.dumps(LIMITS))
    (bench / "metrics" / "steps_done.py").write_text("def read(run):\n    return run.steps\n")
    spec_json = json.loads((root / "BENCHMARK.json").read_text())
    spec_json["workloads"].append({"name": "tiny.long", "config": "tiny",
                                   "traffic": "tiny_long", "chips": 1, "why": "tests"})
    spec_json["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                                    "bound": 0.01, "source": "host_clock",
                                    "workloads": ["tiny.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    cell = spec.load_cell(root, "tiny.long")
    assert cell.traffic["seq"] == 48
    result = run.run_cell(cell, 3, 0.5, False, "cpu")
    assert result["metrics"]["steps_done"]["value"] == result["attempted"] > 0
    assert "steps_done" not in {m.name for m in spec.load_cell(root, CELL).end_to_end}


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "training_operator_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "training_operator_tpu.trainer", sys)
    assert run.banned_modules() == ["jax", "training_operator_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process: no module whose top-level
    name is jax, jaxlib, flax or the JAX package."""
    code = (
        "import sys, tempfile, pathlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from benchmark import spec, run, readings, device_trace\n"
        "from benchmark.tiny import make_root, CELL\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    cell = spec.load_cell(make_root(pathlib.Path(d)), CELL)\n"
        "    run.run_cell(cell, 1, 0.2, True, 'cpu')\n"
        "print(run.banned_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "mistral7b_v03_stage8.seq4k", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_control_fails_at_cell_size():
    """On the card, at the first cell's own size: the fp8 control and half
    the batch fail the committed limits, a sound run passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = spec.load_cell(REPO, "mistral7b_v03_stage8.seq4k")
    lines = []
    readings(cell, [7], {7}, "cuda:0", lines.append)
    for line in lines:
        over = [k for k in NUMBERS if k in cell.limits and line["gaps"][k] > cell.limits[k]]
        assert bool(over) == (line["kind"] != "program"), line
