"""The trace reader and the per-layer readers on a hand-made trace: the CPU
has no device events, so the card's arithmetic is checked here."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import families
from benchmark.device_trace import DeviceOp, HostOp, Trace, _nest
from benchmark.metrics import reader
from benchmark.tiny import REPO

FWD = "training_operator_tpu_torch::flash_fwd"
MS = 1_000_000  # ns
DECODER = families.load(REPO, "decoder")


def _trace(flash_ns: int) -> Trace:
    host = {
        1: HostOp("bench.window", 0, 100 * MS, 7),
        2: HostOp("bench.step", 1 * MS, 90 * MS, 7),
        # The op's dispatch nests a second event of the same name.
        3: HostOp(FWD, 2 * MS, 3 * MS, 7),
        4: HostOp(FWD, 2 * MS + 10, 3 * MS - 10, 7),
        5: HostOp("aten::mm", 4 * MS, 5 * MS, 7),
        6: HostOp("bench.log", 91 * MS, 99 * MS, 7),
        7: HostOp("aten::_local_scalar_dense", 92 * MS, 98 * MS, 7),
    }
    by_thread = _nest(host)
    device = [
        DeviceOp("void flash::fwd_kernel<bf16>", 10 * MS, 10 * MS + flash_ns, 4),
        DeviceOp("nvjet_tst_192x192", 30 * MS, 60 * MS, 5),
        DeviceOp("sm80_xmma_gemm_f32f32", 50 * MS, 70 * MS, 5),  # overlaps the one before
    ]
    return Trace(window=(0, 100 * MS), device=device, host=host, main_thread=7,
                 _by_thread=by_thread)


def _run(trace, steps=2):
    dims = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)
    return SimpleNamespace(trace=trace, steps=steps, device_name="NVIDIA H100 80GB HBM3",
                           family=DECODER, dims=dims, batch=2, seq=32, dtype_bytes=2,
                           data_wait_s=[])


def test_busy_is_the_union_and_gaps_name_the_host():
    t = _trace(5 * MS)
    assert t.busy() == [(10 * MS, 15 * MS), (30 * MS, 70 * MS)]
    assert t.busy_s() == pytest.approx(0.045)
    assert t.gaps()[-1] == (70 * MS, 100 * MS)
    assert t.host_at(95 * MS) == "bench.log > aten::_local_scalar_dense"
    assert t.host_at(20 * MS) == "bench.step"
    assert t.under(t.device[0], {FWD}) == 3
    assert t.under(t.device[1], {FWD}) is None
    assert reader(REPO, "device_idle")(_run(t)) == pytest.approx(55.0)
    assert reader(REPO, "matmul_ms")(_run(t)) == pytest.approx(25.0)


def test_attn_roofline_reads_the_bound_over_linked_kernel_time():
    run = _run(None)
    run.batch, run.seq = 4, 4096
    work = DECODER.attention_work(4, 4096, 4, 16, True, 2)["flash_fwd"]
    bound = max(work["flops"] / 989e12, work["bytes"] / 3.35e12)
    run.trace = _trace(round(2 * bound * 1e9))  # one call, twice its bound
    assert reader(REPO, "attn_roofline")(run) == pytest.approx(50.0, rel=1e-4)


def test_mfu_counts_the_model_flops_of_the_traced_steps():
    run = _run(_trace(MS), steps=2)
    n = DECODER.count_params(run.dims)[1]
    tokens, attn = 2 * 32, 6 * 2 * 32 * 64
    want = 100 * 2 * tokens * (6 * n + attn) / 0.1 / 989e12
    assert reader(REPO, "mfu")(run) == pytest.approx(want)
