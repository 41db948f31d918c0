"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA Hopper card and nvcc; without them they skip (the check
is made inside the fixture, at run time). Run them on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -m cuda` (the suite's
conftest sets up JAX, which the card's machine need not have). chip_smoke.py
holds the same kernels against the same plain versions at the flagship shape.
"""

import pytest
import torch

from training_operator_tpu_torch.trainer import flash

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    from training_operator_tpu_torch.trainer import kernels

    kernels.load()
    return torch.device("cuda")


def _inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(4)]


@pytest.mark.parametrize("shape", [(2, 256, 4, 128), (1, 333, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(card, shape, causal):
    """Tolerances as in chip_smoke.py: out 1e-2 + 1e-2*|ref|, lse 1e-3,
    gradients 2e-2*(rms of the ref row + |ref| + 1e-2*rms(ref)) elementwise
    (bf16 rounding of p, ds and the outputs)."""
    q, k, v, do = _inputs(shape, 0)
    b, s, h, _ = shape
    out, lse = flash.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = flash.flash_fwd_plain(q.float(), k.float(), v.float(), causal)
    assert bool(((out.float() - ref_out).abs() <= 1e-2 + 1e-2 * ref_out.abs()).all())
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    got = (flash.flash_bwd_dq(q, k, v, do, lse, delta, causal),
           *flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    f = [x.float() for x in (q, k, v, do)]
    ref = (flash.flash_bwd_dq_plain(*f, lse, delta, causal),
           *flash.flash_bwd_dkv_plain(*f, lse, delta, causal))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        row_rms = r.square().mean(-1, keepdim=True).sqrt()
        floor = 1e-2 * r.square().mean().sqrt()
        worst = ((g.float() - r).abs() / (row_rms + r.abs() + floor)).max().item()
        assert worst <= 2e-2, (name, worst)


def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(1, 64, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.float32)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, q, q)


def test_launch_counts(card):
    flash.reset_launches()
    q, k, v, _ = (x.requires_grad_() for x in _inputs((1, 128, 2, 64), 1))
    flash.flash_attention(q, k, v).float().sum().backward()
    assert flash.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
