"""The per-kernel measurements' arithmetic on the CPU: the work each flash
kernel must do and the rates that bound it. The kernels' times come from
the card (chip_smoke.py)."""

from training_operator_tpu_torch.trainer import bench


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


def test_permute_bytes_at_olmoes_shape():
    """The permutation's uses at OLMoE's shape (the buffer of 131,072 pairs
    and 1,024 padding rows of 2048 bf16 written or read once, the token rows
    once, dest and the gates once) move ~4.2 GB a layer and step, the
    forward's two run again in the recompute: 1.25 ms at 3.35 TB/s."""
    shape = bench.PERMUTE_SHAPE
    tokens, d, k = shape["tokens"], shape["d"], shape["k"]
    rows = tokens * k + 16 * shape["experts"]
    moved = bench.permute_bytes(tokens, k, d, rows)
    assert set(moved) == set(bench.PERMUTE_USES)
    row, pairs = 4096, 131_072
    assert moved["dispatch"] == 16384 * row + 132_096 * row + 8 * pairs
    assert moved["combine"] == moved["dispatch_backward"] + 4 * pairs
    assert moved["combine_backward"] == (16384 + pairs + 132_096) * row + 16 * pairs
    step = sum(moved.values()) + moved["dispatch"] + moved["combine"]
    assert 4.1e9 < step < 4.3e9
    assert abs(step / 3.35e12 * 1e3 - 1.25) < 0.02


def test_bf16_ulps_counts_last_places():
    import torch

    one = torch.tensor([1.0, -3.0, 0.0]).bfloat16()
    up = torch.tensor([1.0 + 2 ** -7, -3.0, 0.0]).bfloat16()
    assert bench.bf16_ulps(one, one) == 0
    # Just above 1, a last place is 2^-7 (2^(1 - 8)).
    assert bench.bf16_ulps(up, one) == 1
    assert bench.bf16_ulps(torch.tensor([-3.03125]).bfloat16(),
                           torch.tensor([-3.0]).bfloat16()) == 2
