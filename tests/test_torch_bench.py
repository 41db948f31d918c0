"""The port's trainer benchmark on the CPU: what can be checked without a
card (its refusals, the breakdown's arithmetic, the points
run_trainer_bench measures). The card's numbers come from the card:
tests/test_torch_cuda.py runs bench_train_step there at a small size."""

import pytest

from training_operator_tpu_torch.trainer import bench


def test_bench_train_step_refuses_the_cpu():
    config, _, _ = bench.flagship_config()
    with pytest.raises(RuntimeError, match="measures the card"):
        bench.bench_train_step(config, 1, 8, device="cpu")


def test_phase_breakdown_by_subtraction(monkeypatch):
    monkeypatch.setattr(bench, "_phase_times", lambda config, model, data, iters: (10.0, 32.5))
    out = bench._phase_breakdown(None, None, None, step_ms=40.0, iters=3)
    assert out == {"fwd_ms": 10.0, "bwd_ms": 22.5, "optimizer_ms": 7.5,
                   "remat_recompute_ms_est": 10.0, "fwdbwd_ms": 32.5}


def test_run_trainer_bench_measures_the_long_context_point(monkeypatch):
    """run_trainer_bench's points, the JAX bench's attention_8k
    (bench_attention at batch 2, seq 8192) among them."""
    calls = {}

    def record(name):
        def fn(*args, **kwargs):
            calls.setdefault(name, []).append((args, kwargs))
            return name
        return fn

    for name in ("bench_train_step", "bench_attention", "bench_dataloader",
                 "bench_trainer_e2e"):
        monkeypatch.setattr(bench, name, record(name))
    out = bench.run_trainer_bench(steps=3, device="cpu")
    assert set(out) == {"train_step", "attention", "dataloader", "trainer_e2e",
                        "attention_8k"}
    config, batch, seq = bench.flagship_config()
    (args, kwargs), (args_8k, kwargs_8k) = calls["bench_attention"]
    assert args == (batch, seq, config.n_heads, config.head_dim)
    assert args_8k == (2, 8192, config.n_heads, config.head_dim) and kwargs_8k["iters"] == 10
    assert calls["bench_train_step"][0][1]["steps"] == 3



def test_d256_runs_the_gemma_width_step_and_its_kernels(monkeypatch, capsys):
    """`bench --d256`: bench_train_step with its phase breakdown and
    profile_train_step on gemma2b_config, and bench_attention at its
    attention shape [1, 4096, 8, 256] (head_dim 256), beside the card's
    line."""
    import json
    import subprocess
    import types

    calls = {}

    def record(name):
        def fn(*args, **kwargs):
            calls[name] = (args, kwargs)
            return name
        return fn

    monkeypatch.setattr(bench, "bench_train_step", record("bench_train_step"))
    monkeypatch.setattr(bench, "bench_attention", record("bench_attention"))
    monkeypatch.setattr(bench, "profile_train_step", record("profile_train_step"))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(
        stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"))
    bench.main(["--d256"])
    out = json.loads(capsys.readouterr().out)
    assert out == {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
                   "train_step": "bench_train_step", "profile": "profile_train_step",
                   "attention": "bench_attention"}
    config, batch, seq = bench.gemma2b_config()
    args, kwargs = calls["bench_train_step"]
    assert args == (config, 1, 4096) and kwargs.get("breakdown", True)
    assert calls["profile_train_step"][0] == (config, 1, 4096)
    assert calls["bench_attention"][0] == (1, 4096, 8, 256)


def test_fp32_runs_the_full_precision_flagship_and_its_kernels(monkeypatch, capsys):
    """`bench --fp32`: bench_train_step with its phase breakdown and
    profile_train_step on flagship_fp32_config, bench_attention at the
    flagship attention shape in fp32, and float64_errors there and at
    [1, 4096, 8, 256]."""
    import json
    import subprocess
    import types

    import torch

    calls = {}

    def record(name):
        def fn(*args, **kwargs):
            calls[name] = (args, kwargs)
            return name
        return fn

    for name in ("bench_train_step", "bench_attention", "profile_train_step",
                 "float64_errors"):
        monkeypatch.setattr(bench, name, record(name))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(
        stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"))
    bench.main(["--fp32"])
    assert json.loads(capsys.readouterr().out) == {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W", "train_step": "bench_train_step",
        "profile": "profile_train_step", "attention": "bench_attention",
        "float64_errors": ["float64_errors", "float64_errors"]}
    assert calls["float64_errors"][0] == (1, 4096, 8, 256)  # the last of the two
    config, batch, seq = bench.flagship_fp32_config()
    assert config.dtype == torch.float32
    assert calls["bench_train_step"][0] == (config, 8, 2048)
    assert calls["profile_train_step"][0] == (config, 8, 2048)
    assert calls["bench_attention"] == ((8, 2048, 12, 128), {"dtype": torch.float32})


def test_attention_work_counts_the_dtype():
    """fp32 tensors are twice the bytes of bf16 ones (lse and delta stay
    fp32), the FLOPs are the same, and fp32's bound rate is 3xTF32's: a
    third of the TF32 peak."""
    import torch

    two = bench.attention_work(8, 2048, 12, 128, True)
    four = bench.attention_work(8, 2048, 12, 128, True, torch.float32)
    rows = 8 * 12 * 2048 * 4
    for name in two:
        assert four[name]["flops"] == two[name]["flops"]
    assert two["flash_fwd"]["bytes"] == 4 * (8 * 2048 * 12 * 128 * 2) + rows
    assert four["flash_fwd"]["bytes"] == 4 * (8 * 2048 * 12 * 128 * 4) + rows
    h100 = "NVIDIA H100 80GB HBM3"
    assert bench.peak_flops(h100, torch.float32) == 165e12
    assert bench.peak_flops(h100, torch.float16) == bench.peak_flops(h100) == 989e12
    assert bench.peak_flops("a card without a sheet", torch.float32) is None
    # The fp32 forward's bound at the flagship shape: 0.625 ms at 165 TFLOP/s.
    assert abs(four["flash_fwd"]["flops"] / 165e12 * 1e3 - 0.625) < 1e-3
    assert set(bench.FLOP_RULES) == {torch.bfloat16, torch.float16, torch.float32}
    with pytest.raises(RuntimeError, match="measures the card"):
        bench.float64_errors(1, 64, 2, 64, device="cpu")


def test_mma_sync_rate_refuses_the_cpu():
    """The mma.sync TF32 rate is a card measurement: on a machine without a
    card it raises before building anything."""
    with pytest.raises(RuntimeError, match="measures the card"):
        bench.mma_sync_rate()
