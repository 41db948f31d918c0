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
