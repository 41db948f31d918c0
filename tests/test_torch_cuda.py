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


def _inputs(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=dtype) for _ in range(4)]


# (1, 129, 2, 128): one row past a 128-row tile; (2, 384, 3, 128): whole
# tiles; (1, 200, 2, 64) and (1, 333, 2, 64): ragged D=64 tiles;
# (1, 64, 1, 64) and (2, 100, 3, 128): shorter than one 128-row q tile;
# (1, 640, 2, 128): five q tiles, so one of dq's tile pairs is a tile with
# itself; (4, 1000, 40, 64): more (batch, head)s than SMs, ragged. Head_dim
# 256 (32-key dq tiles, dk/dv split over D in the 2-byte kernels):
# (1, 200, 2, 256) and (2, 333, 3, 256) ragged, (1, 64, 1, 256) one key
# tile, (1, 640, 2, 256) five q tiles. (4097, 32, 16, 64): 65552 (batch,
# head)s, more than a grid's y dimension holds. Each in bf16 and fp16 (the
# wgmma kernels' two instantiations) and fp32 (the 3xTF32 kernels).
# The fp32 dk/dv kernel gives each 16 keys a pair of warps, four pairs (64
# keys) a block with 32-row q tiles at D <= 128, two pairs (32 keys) with
# 16-row q tiles at D = 256, and splits no D: (1, 1000, 2, 128) ends in a
# tile of 40 keys (one pair with none) and an 8-row q tile,
# (2, 1000, 4, 256) in 8 keys (one pair with none) and an 8-row q tile,
# (1, 45, 2, 128) is shorter than one key tile, and (1, 17, 1, 256) is one
# 16-row q tile and a row.
# The fp32 dq kernel gives each 16 q rows a pair of warps, four pairs (64
# rows) a block at D <= 128 and two (32 rows) at D = 256, and streams key
# tiles of 32 (D = 64) or 16 keys through a two-stage ring: (1, 333, 2, 64)
# ends in 13 rows (pairs with none) and an 11th key tile of 13 keys, so the
# ring wraps with one stage part used; (1, 1000, 2, 128) 63 key tiles, the
# last of 8 keys; (2, 333, 3, 256) a 13-row last tile (fewer than one
# pair's 16) and 21 key tiles. New for it: (2, 15, 3, 128), one key tile and
# 15 rows, so one stage is never filled; (1, 40, 2, 256), a last q tile of
# 8 rows (its second pair has none) and 3 key tiles, the last half used;
# (3, 97, 2, 64), a last q tile of 33 rows (one pair with one row, one with
# none) and 4 key tiles, the last of one key.
# The fp32 forward gives each 32 q rows a group of D / 64 warps, each warp 64
# head-dim columns as two m16 tiles, so a block holds 256 rows at D = 64,
# 128 at D = 128 and 64 at D = 256, and streams 16-key tiles through a ring
# of 4, 3 or 2 stages: (1, 333, 2, 64) ends in a block of 77 rows (a group
# with 13 rows, its second m16 tile empty, and five groups with none) and 21
# key tiles; (1, 129, 2, 128) a block of one row; (2, 1000, 4, 256) a block
# of 40 rows (its second group has 8) and 63 key tiles. New for it:
# (1, 144, 2, 128), a last block of 16 rows, so one group's second m16 tile
# and three whole groups are empty, over 9 key tiles (the 3-stage ring
# wraps exactly); (2, 300, 3, 64), past one 256-row block with a ragged end
# of 44 rows (a group of 12); (1, 208, 2, 256), 13 key tiles, an odd count
# through the 2-stage ring; (1, 272, 2, 128), 17 key tiles through the
# 3-stage ring and a last block of 16 rows.
@pytest.mark.parametrize("shape", [(2, 256, 4, 128), (1, 333, 2, 64), (1, 129, 2, 128),
                                   (2, 384, 3, 128), (1, 200, 2, 64), (1, 64, 1, 64),
                                   (2, 100, 3, 128), (1, 640, 2, 128), (4, 1000, 40, 64),
                                   (1, 200, 2, 256), (2, 333, 3, 256), (1, 64, 1, 256),
                                   (1, 640, 2, 256), (4097, 32, 16, 64), (1, 1000, 2, 128),
                                   (2, 1000, 4, 256), (1, 45, 2, 128), (1, 17, 1, 256),
                                   (2, 15, 3, 128), (1, 40, 2, 256), (3, 97, 2, 64),
                                   (1, 144, 2, 128), (2, 300, 3, 64), (1, 208, 2, 256),
                                   (1, 272, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernels_match_plain(card, shape, causal, dtype):
    """Tolerances as in chip_smoke.py: bf16 and fp16 out 1e-2 + 1e-2*|ref|,
    lse 1e-3, gradients 2e-2*(rms of the ref row + |ref| + 1e-2*rms(ref))
    elementwise (2-byte rounding of p, ds and the outputs); fp32 out and lse
    within 2e-5, gradients within 2e-4, max abs (the JAX package's fp32
    bars)."""
    q, k, v, do = _inputs(shape, 0, dtype)
    b, s, h, _ = shape
    fp32 = dtype == torch.float32
    out, lse = flash.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = flash.flash_fwd_plain(q.float(), k.float(), v.float(), causal)
    if fp32:
        assert (out - ref_out).abs().max().item() <= 2e-5
    else:
        assert bool(((out.float() - ref_out).abs() <= 1e-2 + 1e-2 * ref_out.abs()).all())
    assert (lse - ref_lse).abs().max().item() <= (2e-5 if fp32 else 1e-3)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    got = (flash.flash_bwd_dq(q, k, v, do, lse, delta, causal),
           *flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    f = [x.float() for x in (q, k, v, do)]
    ref = (flash.flash_bwd_dq_plain(*f, lse, delta, causal),
           *flash.flash_bwd_dkv_plain(*f, lse, delta, causal))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype
        if fp32:
            assert (g - r).abs().max().item() <= 2e-4, name
            continue
        row_rms = r.square().mean(-1, keepdim=True).sqrt()
        floor = 1e-2 * r.square().mean().sqrt()
        worst = ((g.float() - r).abs() / (row_rms + r.abs() + floor)).max().item()
        assert worst <= 2e-2, (name, worst)


@pytest.mark.parametrize("shape", [(2, 1000, 12, 128), (2, 1000, 4, 256)],
                         ids=["d128", "d256"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dq_is_deterministic(card, shape, causal, dtype):
    """dq uses no atomics: every entry is summed in one fixed order, so two
    launches on the same inputs agree bit for bit; a difference is a race."""
    q, k, v, do = _inputs(shape, 2, dtype)
    b, s, h, _ = shape
    out, lse = flash.flash_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    first = flash.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    second = flash.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    assert torch.equal(first, second)


@pytest.mark.parametrize("shape", [(2, 1000, 12, 128), (2, 1000, 4, 256)],
                         ids=["d128", "d256"])
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_fp32_is_deterministic(card, shape, causal):
    """The fp32 dk/dv kernel uses no atomics: each block writes its keys'
    rows once, summed in one fixed order, so two launches agree bit for
    bit; a difference is a race in its ring or its pᵀ hand-over."""
    q, k, v, do = _inputs(shape, 5, torch.float32)
    out, lse = flash.flash_fwd(q, k, v, causal)
    delta = flash.row_delta(do, out)
    first = flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    second = flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("shape", [(2, 1000, 12, 128), (2, 1000, 4, 256)],
                         ids=["d128", "d256"])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_fp32_is_deterministic(card, shape, causal):
    """The fp32 forward uses no atomics and each group of warps adds its
    partial scores in one fixed order, so two launches agree bit for bit in
    out and lse; a difference is a race in its ring or its partial-score
    exchange."""
    q, k, v, _ = _inputs(shape, 6, torch.float32)
    first = flash.flash_fwd(q, k, v, causal)
    second = flash.flash_fwd(q, k, v, causal)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(1, 64, 2, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, q, q)


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "fp32"), (torch.float16, "fp16")])
def test_auto_takes_the_kernel_of_the_dtype(card, dtype, kind):
    """`auto` on fp32 (and fp16) inputs at head_dim 128 launches that
    type's instantiation of each kernel once for a forward and backward,
    and no other type's."""
    from training_operator_tpu_torch.trainer import attention

    q, k, v, _ = (x.requires_grad_() for x in _inputs((1, 256, 2, 128), 4, dtype))
    flash.reset_launches()
    attention.attention(q, k, v, causal=True, impl="auto").float().sum().backward()
    one = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert flash.launches == one
    assert flash.launches_dtype == {t: one if t == kind else dict.fromkeys(one, 0)
                                    for t in ("bf16", "fp16", "fp32")}


def _small_train(policy):
    from training_operator_tpu_torch.trainer.model import TransformerConfig
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    config = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                               n_kv_heads=2, d_ff=512, max_seq_len=256,
                               remat_policy=policy, remat_head=True)
    optimizer = make_optimizer(warmup_steps=1, total_steps=10)
    state = init_train_state(config, optimizer)
    return (config, optimizer, state, make_train_step(config, optimizer),
            make_example_batch(config, 2, 256))


@pytest.mark.parametrize("policy,per_layer", [("save_attn_qkv", 1), ("full", 2)])
def test_remat_policy_forward_launches(card, policy, per_layer):
    """A step of a 2-layer decoder with head_dim 128: the forward kernel
    runs once per layer under save_attn_qkv (backward keeps its outputs)
    and twice under full; dq and dk/dv once per layer either way."""
    config, _, state, step, batch = _small_train(policy)
    flash.reset_launches()
    state, metrics = step(state, batch)
    n = config.n_layers
    assert flash.launches == {"flash_fwd": per_layer * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """DCP save of a state on the card and restore into a zero-filled
    template on the card: every tensor lands on the card, bit for bit."""
    from training_operator_tpu_torch.trainer.checkpoint import Checkpointer
    from training_operator_tpu_torch.trainer.train import state_dict, template_train_state

    config, optimizer, state, step, batch = _small_train("save_attn_qkv")
    state, _ = step(state, batch)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.save(state)
    restored = ckpt.restore(template_train_state(config, optimizer))
    live, back = state_dict(state), state_dict(restored)
    for key in live:
        assert back[key].device == live[key].device, key
        assert torch.equal(back[key], live[key]), key
    assert restored.model.embed.is_cuda and restored.step == state.step == 1
    assert restored.opt_state.count == 1


def test_launch_counts(card):
    flash.reset_launches()
    q, k, v, _ = (x.requires_grad_() for x in _inputs((1, 128, 2, 64), 1))
    flash.flash_attention(q, k, v).float().sum().backward()
    assert flash.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_dispatcher_takes_the_kernels_at_head_dim_256(card, impl):
    """The dispatcher at head_dim 256 with one kv head (phase 13's
    attention): "auto" and "flash" launch each of the three kernels once
    for a forward and backward on bf16 inputs, and their gradients are
    within 2e-2 in relative Frobenius norm of the plain path's in fp32 on
    the same values (the kernels round p, ds and their outputs to bf16,
    2^-9 relative each)."""
    from training_operator_tpu_torch.trainer import attention

    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((1, 256, 4, 256), generator=g, device="cuda", dtype=torch.bfloat16)
    k, v = (torch.randn((1, 256, 1, 256), generator=g, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    launches, grads = {}, {}
    for path, dtype in ((impl, torch.bfloat16), ("xla", torch.float32)):
        leaves = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        flash.reset_launches()
        attention.attention(*leaves, causal=True, impl=path).float().square().sum().backward()
        launches[path] = dict(flash.launches)
        grads[path] = [x.grad.float() for x in leaves]
    assert launches[impl] == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert launches["xla"] == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name, a, b in zip(("dq", "dk", "dv"), grads[impl], grads["xla"]):
        assert ((a - b).norm() / b.norm()).item() <= 2e-2, name


def test_world_of_one_sharded_step_matches_the_unsharded(card, tmp_path):
    """The sharded trainer as a world of one NCCL rank (the operator's env,
    a file store): init_train_state on the mesh fsdp=1,tensor=1; two steps match
    the unsharded step on the same parameters and batches (loss within 1e-5
    relative; every parameter and mu within 1e-5 in relative Frobenius
    norm), and the sharded step launches each kernel once per layer. A save
    of the sharded state restores into an unsharded template bit for bit."""
    import torch.distributed as dist

    from training_operator_tpu_torch.trainer import distributed
    from training_operator_tpu_torch.trainer.checkpoint import Checkpointer
    from training_operator_tpu_torch.trainer.mesh import mesh_from_env
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_train_step,
        template_train_state,
    )

    config, optimizer, ref, ref_step, batch = _small_train("save_attn_qkv")
    env = {"NUM_PROCESSES": "1", "PROCESS_ID": "0", "TPU_MESH_AXES": "fsdp=1,tensor=1"}
    distributed.initialize(env, init_method=f"file://{tmp_path / 'store'}")
    try:
        assert dist.get_backend() == "nccl"
        mesh = mesh_from_env("cuda", env)
        state = init_train_state(config, optimizer, mesh=mesh)
        step = make_train_step(config, optimizer, mesh=mesh)
        second = {k: v.roll(1, 0) for k, v in batch.items()}
        for b in (batch, second):
            ref, want = ref_step(ref, b)
            flash.reset_launches()
            state, got = step(state, b)
            n = config.n_layers
            assert flash.launches == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
            assert abs(got["loss"].item() - want["loss"].item()) <= 1e-5 * want["loss"].item()
        for name, p in state.model.named_parameters():
            for a, b in ((p, ref.params[name]), (state.opt_state.mu[name], ref.opt_state.mu[name])):
                assert ((a.detach() - b.detach()).norm() / b.norm()).item() <= 1e-5, name
        ckpt = Checkpointer(str(tmp_path / "ckpt"))
        assert ckpt.save(state)
        back = ckpt.restore(template_train_state(config, optimizer))
        for name, p in back.model.named_parameters():
            assert torch.equal(p, state.params[name]), name
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_loopback_ring_matches_plain(card, ns, causal):
    """The ring's per-rank body through the loopback transport on the card
    (chip_smoke.py phase 8 at a small shape): out, lse and the gradients
    against the plain version on the unsplit sequence, as
    test_kernels_match_plain holds one kernel (the plain backward takes the
    ring's own lse and delta); NS(NS+1)/2 launches of each kernel under a
    causal mask, NS of them causal, NS^2 without one."""
    from training_operator_tpu_torch.trainer import attention

    shape = (2, 512, 4, 128)
    q, k, v, do = _inputs(shape, 3)
    blocks = [[c.contiguous() for c in x.chunk(ns, 1)] for x in (q, k, v, do)]
    flash.reset_launches()
    outs, lses, dqs, dks, dvs = attention.ring_loopback(*blocks, causal)
    n = ns * (ns + 1) // 2 if causal else ns * ns
    assert flash.launches == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    assert set(flash.launches_causal.values()) == {ns if causal else 0}
    b, s, h, _ = shape
    out = torch.cat(outs, 1)
    lse = torch.cat([x.reshape(b, h, -1) for x in lses], 2).reshape(b * h, s, 1)
    f = [x.float() for x in (q, k, v, do)]
    ref_out, ref_lse = flash.flash_fwd_plain(*f[:3], causal)
    assert bool(((out.float() - ref_out).abs() <= 1e-2 + 1e-2 * ref_out.abs()).all())
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    delta = flash.row_delta(do, out)
    ref = (flash.flash_bwd_dq_plain(*f, lse, delta, causal),
           *flash.flash_bwd_dkv_plain(*f, lse, delta, causal))
    for name, parts, r in zip(("dq", "dk", "dv"), (dqs, dks, dvs), ref):
        g = torch.cat(parts, 1).float()
        row_rms = r.square().mean(-1, keepdim=True).sqrt()
        floor = 1e-2 * r.square().mean().sqrt()
        worst = ((g - r).abs() / (row_rms + r.abs() + floor)).max().item()
        assert worst <= 2e-2, (name, worst)


def test_loopback_ring_fp32_matches_the_plain_ring(card):
    """The loopback ring in fp32 through the fp32 kernels against the same
    ring on the CPU, where each block takes the kernels' plain versions:
    out and lse within 2e-5, the gradients within 2e-4 (phase 3's fp32
    rules); 3 launches of each fp32 kernel and none of another type."""
    from training_operator_tpu_torch.trainer import attention

    ns = 2
    q, k, v, do = _inputs((1, 512, 2, 64), 5, torch.float32)
    blocks = [[c.contiguous() for c in x.chunk(ns, 1)] for x in (q, k, v, do)]
    flash.reset_launches()
    got = attention.ring_loopback(*blocks, True)
    assert flash.launches_dtype["fp32"] == {"flash_fwd": 3, "flash_bwd_dq": 3,
                                            "flash_bwd_dkv": 3}
    assert sum(flash.launches.values()) == 9
    want = attention.ring_loopback(*[[c.cpu() for c in x] for x in blocks], True)
    for name, g, w, tol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                               (2e-5, 2e-5, 2e-4, 2e-4, 2e-4)):
        err = max((a.cpu() - b).abs().max().item() for a, b in zip(g, w))
        assert err <= tol, (name, err)


def test_moe_layer_on_the_card_matches_the_cpu(card):
    """The switch MoE layer (bf16, 4 experts, a router column forced so one
    expert overflows) on the card equals it on the CPU: the same kept
    tokens, the outputs within the CPU test's bf16 tolerance against JAX
    (2e-2 of the largest output), the aux within 1e-5."""
    from training_operator_tpu_torch.trainer import moe
    from training_operator_tpu_torch.trainer.model import TransformerConfig

    config = TransformerConfig(vocab_size=256, d_model=64, n_layers=1, n_heads=4,
                               n_kv_heads=4, d_ff=96, n_experts=4)
    g = torch.Generator().manual_seed(0)
    h = (torch.randn(2, 32, 64, generator=g) + 1.0).to(torch.bfloat16)
    router = torch.randn(64, 4, generator=g) * 0.3
    router[:, 2] += 8.0
    experts = {"w1": torch.randn(4, 64, 96, generator=g) * 0.1,
               "w3": torch.randn(4, 64, 96, generator=g) * 0.1,
               "w2": torch.randn(4, 96, 64, generator=g) * 0.1}
    outs = {}
    for dev in ("cpu", "cuda"):
        args = [x.to(dev) for x in (h, router)]
        out, aux = moe.moe_mlp(*args, {k: w.to(dev) for k, w in experts.items()}, config)
        outs[dev] = (out.float().cpu(), aux.item(), moe.route(*args, config)[3].cpu())
    (want, want_aux, want_keep), (got, aux, keep) = outs["cpu"], outs["cuda"]
    assert torch.equal(keep, want_keep) and not bool(keep.all())
    assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()
    assert abs(aux - want_aux) <= 1e-5 * abs(want_aux)


@pytest.mark.parametrize("n_experts", [0, 4])
def test_loopback_pipeline_on_the_card(card, n_experts):
    """A 4-layer decoder (head_dim 128) as 2 loopback stages x 2
    microbatches: one step launches each kernel once per layer and
    microbatch, and gives the loss of the same parameters unpipelined for
    the dense model (1e-3 relative: bf16 products of other row counts)."""
    from training_operator_tpu_torch.trainer import pipeline
    from training_operator_tpu_torch.trainer.model import TransformerConfig, loss_fn
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    config = TransformerConfig(vocab_size=512, d_model=256, n_layers=4, n_heads=2,
                               n_kv_heads=2, d_ff=512, n_experts=n_experts,
                               pipeline_microbatches=2, remat_policy="save_attn_qkv")
    optimizer = make_optimizer(warmup_steps=1, total_steps=10)
    state = init_train_state(config, optimizer)
    batch = make_example_batch(config, 4, 256)
    with torch.no_grad():
        flat = loss_fn(state.model, batch).item()
    pipeline.loopback(state.model, 2)
    flash.reset_launches()
    state, metrics = make_train_step(config, optimizer)(state, batch)
    per = config.n_layers * config.pipeline_microbatches
    assert flash.launches == {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per}
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    if not n_experts:
        assert abs(metrics["loss"].item() - flat) <= 1e-3 * abs(flat)


def test_vision_steps_on_the_card_match_the_cpu(card):
    """The vision family at TestVisionFamily's size in fp32 (TF32 off): 3
    SGD-momentum steps on the card against the same steps on the CPU from
    the same parameters and batch, within 1e-4 relative (cuDNN's conv
    algorithms sum in another order); then the bf16 default run learns."""
    from training_operator_tpu_torch.trainer import vision
    from training_operator_tpu_torch.trainer.train import SGD

    config = vision.VisionConfig(image_size=16, channels=(8, 16), dense=32, dtype=torch.float32)
    params = vision.init_vision_params(config, torch.Generator().manual_seed(0), "cpu")
    batch = vision.synthetic_mnist(torch.Generator().manual_seed(1), 64, config)
    runs = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            p = {n: t.detach().clone().to(dev).requires_grad_() for n, t in params.items()}
            opt = SGD(0.1, momentum=0.9)
            state = opt.init(p)
            step = vision.make_vision_train_step(config, opt, device=dev)
            b = {k: v.to(dev) for k, v in batch.items()}
            losses = []
            for _ in range(3):
                p, state, m = step(p, state, b)
                losses.append(m["loss"].item())
            runs[dev] = losses, {n: t.detach().cpu() for n, t in p.items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (want, want_p), (got, got_p) = runs["cpu"], runs["cuda"]
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b)
    for n in want_p:
        assert ((got_p[n] - want_p[n]).norm() / want_p[n].norm()).item() <= 1e-4, n
    out = vision.train_synthetic(steps=30, log=lambda _: None)
    assert out["accuracies"][-1] > 0.9 and len(out["step_ms"]) == 30


def test_solver_on_the_card_equals_numpy(card):
    """TorchSolver on the card against the host numpy arm, bit for bit: 20
    random instances (up to 16 slices of 8 hosts) and a 400-slice cut of
    the 10k-node block, cold and warm."""
    import numpy as np

    from training_operator_tpu_torch.scheduler import packer

    solver = packer.TorchSolver()
    for seed in range(20):
        rng = np.random.default_rng(seed)
        s, k, c, g = (int(rng.integers(1, 17)), int(rng.integers(1, 5)),
                      int(rng.integers(1, 65)), int(rng.integers(1, 97)))
        cand_mask = rng.random((k, c, 8)) < 0.3
        args = (rng.random((s, 8)) < 0.75, cand_mask,
                rng.integers(0, s, size=(k, c)).astype(np.int32),
                (rng.random((k, c)) < 0.9) & cand_mask.any(-1),
                rng.integers(0, 8, size=(k, c)).astype(np.int32),
                rng.integers(0, k, size=g).astype(np.int32), rng.random(g) < 0.9)
        want = packer.solve_batch_numpy(*args)
        assert np.array_equal(solver.solve(args[0], args[1:5], args[5], args[6]), want)
    inst = packer.scale_instance(n_slices=400, n_gangs=320)
    want = packer.solve_batch_numpy(*inst)
    for _ in range(2):
        got = solver.solve(inst[0], inst[1:5], inst[5], inst[6], generation=1)
        assert got.dtype == np.int32 and np.array_equal(got, want)


def test_placer_on_the_card_equals_numpy(card):
    """TPUPacker on the card against its numpy arm: burst.replay of 200
    jobs on 12 slices, 8 GPU nodes and 4 CPU nodes (placements equal in
    every cycle, or replay raises), and a 400-slice cut of the 10k-node
    block, cold and warm."""
    from training_operator_tpu_torch.scheduler import burst, packer

    placer = packer.TPUPacker()
    assert placer.device.type == "cuda"
    out = burst.replay([placer, packer.TPUPacker(kernel="numpy")], burst.burst_pool(12, 8, 4),
                       burst.build_workload(200, 0))
    assert out["admitted"] > 150 and out["rounds"]
    nodes = burst.scale_pool(400)
    card_reqs, host_reqs = burst.scale_requests(320), burst.scale_requests(320)
    host = packer.TPUPacker(kernel="numpy")
    for _ in range(2):
        got = placer.place(card_reqs, burst.usage_snapshot(nodes, inventory_gen=7), 1e4)
        want = host.place(host_reqs, burst.usage_snapshot(nodes, inventory_gen=7), 1e4)
        assert not burst.placement_diff(want, got)
        assert placer.last_solve_stats["kernel"] == "torch"


def test_operator_burst_on_the_card_equals_numpy(card):
    """A 100-job burst through the port's own operator (burst.run_burst on
    8 slices, 4 GPU nodes and 2 CPU nodes, charge_solve_time off) with
    TPUPacker solving on the card gives the numpy arm's records: every
    PodGroup's admission, every job's Running and Succeeded times, the
    cycles."""
    from training_operator_tpu_torch.scheduler import burst, packer

    specs = burst.build_workload(100, 0)
    placer = packer.TPUPacker()
    got = burst.run_burst(specs, placer, 8, 4, 2, charge_solve_time=False)
    want = burst.run_burst(specs, packer.TPUPacker(kernel="numpy"), 8, 4, 2,
                           charge_solve_time=False)
    for key in ("admitted", "running", "succeeded", "cycles"):
        assert got[key] == want[key], key
    assert len(got["succeeded"]) == 100
    assert {r["solver"]["kernel"] for r in got["trace"] if "solver" in r} == {"torch"}
    assert placer.device.type == "cuda"


def test_bench_train_step_breakdown(card):
    """bench_train_step at a small size returns the phase breakdown, the
    executed-MFU estimate (remat on) and the first step's seconds."""
    from training_operator_tpu_torch.trainer import bench
    from training_operator_tpu_torch.trainer.model import TransformerConfig

    config = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                               n_kv_heads=2, d_ff=512, max_seq_len=256,
                               remat_policy="save_attn_qkv", remat_head=True)
    out = bench.bench_train_step(config, 2, 256, steps=3, warmup=2)
    br = out["breakdown"]
    assert set(br) == {"fwd_ms", "bwd_ms", "optimizer_ms", "remat_recompute_ms_est",
                       "fwdbwd_ms"}
    assert br["fwd_ms"] > 0 and br["fwdbwd_ms"] > br["fwd_ms"]
    assert br["remat_recompute_ms_est"] == br["fwd_ms"]
    assert out["mfu_executed_est"] == pytest.approx(out["mfu"] * 8 / 6)
    assert out["compile_s"] > 0 and out["kernel_load"] in ("build", "cache", "loaded before")
