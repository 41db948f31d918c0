"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA Hopper card and nvcc; without them they skip (the check
is made inside the fixture, at run time). Run them on the card with
`python -m pytest --noconftest tests/test_torch_cuda.py -m cuda` (the suite's
conftest sets up JAX, which the card's machine need not have). chip_smoke.py
holds the same kernels against the same plain versions at the flagship shape.
"""

import pytest
import torch

from training_operator_tpu_torch.trainer import bench, flash

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


def test_step_phases_hold_every_device_op_of_the_window(card):
    """The benchmark's per-layer readers (benchmark/metrics, on
    device_trace.from_profiler and program_spans.Spans) on three traced
    steps of a small decoder inside a `bench.window` range, as
    benchmark/run.py traces its window: forward, backward (autograd's device
    thread, by launch time) and optimizer hold every device op of the
    window, with the head and the recompute inside them."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import device_trace, program_spans
    from benchmark.metrics import reader
    from benchmark.tiny import REPO
    from training_operator_tpu_torch.trainer.model import TransformerConfig
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    config = TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2,
                               n_kv_heads=2, d_ff=512, max_seq_len=256,
                               remat_policy="save_attn_qkv", remat_head=True)
    optimizer = make_optimizer(total_steps=10)
    state = init_train_state(config, optimizer, device=card)
    step_fn = make_train_step(config, optimizer, device=card)
    data = make_example_batch(config, 2, 256, device=card)
    state, _ = step_fn(state, data)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(steps):
                state, _ = step_fn(state, data)
            torch.cuda.synchronize()
    trace = device_trace.from_profiler(prof)
    assert trace.device
    run = SimpleNamespace(trace=trace, steps=steps)
    ph = {name: reader(REPO, f"{name}_ms")(run)
          for name in ("forward", "backward", "optimizer", "head", "recompute")}
    assert all(ph[name] is not None and ph[name] > 0 for name in ph), ph
    spans = program_spans.Spans(trace)
    assert all(spans.phase(d) is not None for d in trace.device)
    total = ph["forward"] + ph["backward"] + ph["optimizer"]
    device_ms = sum(d.end - d.start for d in trace.device) / 1e6 / steps
    assert total == pytest.approx(device_ms)
    assert ph["recompute"] < ph["backward"] and ph["head"] < total
    assert 0 <= 1 - trace.busy_s() / trace.window_s < 1


# ----------------------------------------------------------------------
# The head's fp32 products (trainer/head_gemm.py, csrc/head_gemm_fp32.cu)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("label", list(bench.HEAD_SHAPES))
def test_head_products_precision_at_the_cells(card, label):
    """At each benchmark cell's head shape (dX sums over K = 92,544, dW
    over K = 32,768 in the 32k cell), each product's max error against
    float64 on sampled rows or columns is at most 4x cuBLAS's fp32 SGEMM's
    and at most 1/100 of torch.matmul's in TF32."""
    t, d, v = bench.HEAD_SHAPES[label]
    fp32 = bench.head_float64_errors(t, d, v)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = bench.head_float64_errors(t, d, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for product, errs in fp32.items():
        assert errs["kernel"] <= 4 * errs["library"], (product, errs)
        assert errs["kernel"] <= tf32[product]["library"] / 100, (product, errs, tf32[product])
        assert tf32[product]["kernel"] == errs["kernel"], product  # the kernel ignores the flag


def _head_operands(t, d, v, seed, ints):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if ints:  # small integers: every product is exact in fp32 and in the split
        return [torch.randint(-3, 4, s, generator=g, device="cuda").float()
                for s in ((t, d), (d, v), (t, v))]
    return [torch.randn(s, generator=g, device="cuda") for s in ((t, d), (d, v), (t, v))]


# Vocab 256 and 512 (the tests' models), 101 and 257 (row strides TMA
# refuses, loaded plainly), one block of k or less, ragged tiles on every
# edge, and T past one 128-row tile.
HEAD_RAGGED = [(37, 48, 101), (64, 32, 256), (300, 96, 512), (129, 130, 257), (5, 3, 7),
               (1000, 512, 1000)]


@pytest.mark.parametrize("shape", HEAD_RAGGED)
def test_head_products_on_ragged_shapes(card, shape):
    """Integer operands give every product exactly (any misplaced element
    shows); normal ones within 3e-5 of the largest float64 magnitude."""
    from training_operator_tpu_torch.trainer import head_gemm

    t, d, v = shape
    for ints in (True, False):
        x, w, dl = _head_operands(t, d, v, 7, ints)
        xd, wd, dld = x.double(), w.double(), dl.double()
        pairs = {"logits": (head_gemm.head_logits(x, w), xd @ wd),
                 "dx": (head_gemm.head_dx(dl, w), dld @ wd.t()),
                 "dw": (head_gemm.head_dw(x, dl), xd.t() @ dld)}
        for product, (got, ref) in pairs.items():
            if ints:
                assert torch.equal(got.double(), ref), (product, shape)
            else:
                err = (got.double() - ref).abs().max().item()
                assert err <= 3e-5 * ref.abs().max().item(), (product, shape, err)


def test_head_products_from_unaligned_operands(card):
    """Operands whose base is not 16-byte aligned (TMA refuses them) are
    loaded plainly: the same products as from aligned copies, bit for bit."""
    from training_operator_tpu_torch.trainer import head_gemm

    x, w, dl = _head_operands(200, 64, 384, 8, False)
    buf = torch.empty(x.numel() + 1, device="cuda")
    xu = buf[1:].view_as(x).copy_(x)
    assert xu.data_ptr() % 16 != 0
    assert torch.equal(head_gemm.head_logits(xu, w), head_gemm.head_logits(x, w))
    assert torch.equal(head_gemm.head_dw(xu, dl), head_gemm.head_dw(x, dl))


def test_head_launch_counts_in_a_remat_head_step(card):
    """One step under remat_head launches the logits twice (the forward and
    its recompute), dX once and dW once, and no cuBLAS fp32 product (the
    layers' products are bf16)."""
    from training_operator_tpu_torch.trainer import head_gemm

    _, _, state, step, batch = _small_train("save_attn_qkv")
    state, _ = step(state, batch)  # warm-up
    head_gemm.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    assert head_gemm.launches == {"logits": 2, "dx": 1, "dw": 1}
    assert torch.isfinite(metrics["loss"])
    names = {e.name for e in prof.events()}
    assert any("head_gemm_kernel" in n for n in names)
    assert not [n for n in names if "sgemm" in n or "f32f32_f32f32" in n]


def _dropless_config(**kw):
    from training_operator_tpu_torch.trainer.model import TransformerConfig

    return TransformerConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=2, n_kv_heads=2,
                             d_ff=128, max_seq_len=512, n_experts=16, n_experts_per_tok=4,
                             moe_router="dropless", qk_norm=True, rms_norm_eps=1e-5, **kw)


def test_dropless_layer_grouped_products_match_the_plain_loop(card):
    """The dropless layer's grouped products on the card (torch's
    `_grouped_mm`) against the loop of plain products over the same groups,
    in bf16: outputs, aux sums and every gradient within 1e-2 of their norm
    (bf16 products of other row blockings; at the cell's shape they were
    equal bit for bit)."""
    from training_operator_tpu_torch.trainer import moe

    config = _dropless_config()
    g = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(4, 512, 256, generator=g, device="cuda").to(torch.bfloat16)
    weights = [torch.randn(256, 16, generator=g, device="cuda") * 0.06,
               torch.randn(16, 256, 128, generator=g, device="cuda") * 0.06,
               torch.randn(16, 256, 128, generator=g, device="cuda") * 0.06,
               torch.randn(16, 128, 256, generator=g, device="cuda") * 0.05]
    dy = torch.randn(4, 512, 256, generator=g, device="cuda").to(torch.bfloat16)

    def run(products):
        leaves = [t.clone().requires_grad_() for t in [h, *weights]]
        saved, moe.grouped_mm = moe.grouped_mm, products
        try:
            y, sums = moe.dropless_mlp(leaves[0], leaves[1], dict(zip(("w1", "w3", "w2"),
                                                                      leaves[2:])), config)
            ((y.float() * dy.float()).sum() + sums[1].square().sum()).backward()
        finally:
            moe.grouped_mm = saved
        return [y.float(), sums] + [t.grad.float() for t in leaves]

    for got, want in zip(run(moe.grouped_mm), run(moe.plain_grouped_mm)):
        assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_a_dropless_step_takes_no_host_sync(card):
    """An untraced train step of a dropless MoE model with qk-norm (flash
    kernels at head_dim 128) calls no synchronising CUDA operation."""
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    config = _dropless_config(remat_policy="save_attn_qkv", remat_head=True)
    optimizer = make_optimizer(warmup_steps=2, total_steps=10)
    state = init_train_state(config, optimizer, device="cuda")
    step = make_train_step(config, optimizer, device="cuda")
    batch = make_example_batch(config, 2, 512, device="cuda")
    state, _ = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(metrics["loss"]).item()


def _olmoe_routing(empty: bool):
    """Seeded hidden states routed by the layer's own router and group
    layout at OLMoE's shape (bench.PERMUTE_SHAPE: 16,384 tokens of 2048,
    top-8 of 64): (x [T, D] bf16, gate [T, k] fp32, dest [T k],
    rows). With `empty`, no token chooses expert 5 (a large first feature
    against a large negative router weight)."""
    from types import SimpleNamespace

    from training_operator_tpu_torch.trainer import moe

    t, d, e, k = (bench.PERMUTE_SHAPE[n] for n in ("tokens", "d", "experts", "k"))
    g = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    router = torch.randn(d, e, generator=g, device="cuda") * 0.02
    if empty:
        x[:, 0] = 4.0
        router[0, 5] = -50.0
    gate, choice, counts, _ = moe.route_topk(x, router, SimpleNamespace(n_experts=e,
                                                                       n_experts_per_tok=k))
    dest, _, rows = moe.group_layout(choice, counts, e)
    assert (counts[5].item() == 0) == empty
    return x, gate, dest, rows


@pytest.mark.parametrize("empty", [False, True], ids=["routed", "one-expert-empty"])
def test_permutation_kernels_match_the_torch_ops_at_olmoes_shape(card, empty):
    """The four uses of the two kernels against the torch ops they replace
    (moe.plain_dispatch, plain_combine and its autograd,
    plain_dispatch_backward), on the layer's own routing: the dispatch and
    y's gradient bit for bit with every padding row zero (the allocator's
    free blocks hold NaN first, so an unwritten row shows); the combine and
    the dispatch's backward within one bf16 ulp (the k-sum's order may
    differ); the gate's gradient at least as close to a float64 one as the
    torch ops' (fp32 against a bf16 sum); two runs the same bit for bit."""
    from training_operator_tpu_torch.trainer import moe, permute

    x, gate, dest, rows = _olmoe_routing(empty)
    (t, d), k = x.shape, gate.shape[1]
    d2 = dest.view(t, k)
    named = torch.zeros(rows, dtype=torch.bool, device="cuda")
    named[dest] = True
    g = torch.Generator(device="cuda").manual_seed(27)
    y = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    dout = torch.randn(t, d, generator=g, device="cuda").bfloat16()
    grad_xs = torch.randn(rows, d, generator=g, device="cuda").bfloat16()

    def nan_blocks():
        torch.full((2 * rows * d,), float("nan"), dtype=torch.bfloat16, device="cuda")

    def kernels_once():
        nan_blocks()
        xs = permute.scatter(x, d2, rows)
        out = permute.gather_sum(y, d2, gate)
        nan_blocks()
        dy, dgate = permute.scatter(dout, d2, rows, gate, y)
        return xs, out, dy, dgate, permute.gather_sum(grad_xs, d2)

    permute.reset_launches()
    first, second = kernels_once(), kernels_once()
    torch.cuda.synchronize()
    assert permute.launches == {"scatter": 4, "gather_sum": 4}
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    xs, out, dy, dgate, dx = first
    assert torch.equal(xs, moe.plain_dispatch(x, dest, rows, k)) and not xs[~named].any()
    assert bench.bf16_ulps(out, moe.plain_combine(y, gate, dest)) <= 1
    leaves = y.clone().requires_grad_(), gate.clone().requires_grad_()
    want_dy, want_dgate = torch.autograd.grad(moe.plain_combine(*leaves, dest), leaves, dout)
    assert torch.equal(dy, want_dy) and not dy[~named].any()
    exact = torch.bmm(y.double()[dest].view(t, k, d), dout.double()[:, :, None])[..., 0]
    err = (dgate.double() - exact).abs().max().item()
    assert err <= (want_dgate.double() - exact).abs().max().item()
    assert bench.bf16_ulps(dx, moe.plain_dispatch_backward(grad_xs, dest, k)) <= 1


def test_dropless_layer_with_the_permutation_kernels_matches_the_torch_ops(card, monkeypatch):
    """The dropless layer on the card with the permutation kernels against
    the same layer with its permutation as torch ops (`permute.fused` made
    False, the CPU's path on card tensors): output, aux sums and every
    gradient within the 1e-2 of their norm that
    test_dropless_layer_grouped_products_match_the_plain_loop allows; one
    launch of each kernel in the forward and one in the backward."""
    from training_operator_tpu_torch.trainer import moe, permute

    config = _dropless_config()
    g = torch.Generator(device="cuda").manual_seed(1)
    h = torch.randn(4, 512, 256, generator=g, device="cuda").to(torch.bfloat16)
    weights = [torch.randn(256, 16, generator=g, device="cuda") * 0.06,
               torch.randn(16, 256, 128, generator=g, device="cuda") * 0.06,
               torch.randn(16, 256, 128, generator=g, device="cuda") * 0.06,
               torch.randn(16, 128, 256, generator=g, device="cuda") * 0.05]
    dy = torch.randn(4, 512, 256, generator=g, device="cuda").to(torch.bfloat16)

    def run():
        leaves = [t.clone().requires_grad_() for t in [h, *weights]]
        y, sums = moe.dropless_mlp(leaves[0], leaves[1], dict(zip(("w1", "w3", "w2"),
                                                                  leaves[2:])), config)
        ((y.float() * dy.float()).sum() + sums[1].square().sum()).backward()
        return [y.float(), sums] + [t.grad.float() for t in leaves]

    permute.reset_launches()
    got = run()
    assert permute.launches == {"scatter": 2, "gather_sum": 2}
    monkeypatch.setattr(permute, "fused", lambda *tensors: False)
    want = run()
    assert permute.launches == {"scatter": 2, "gather_sum": 2}
    for a, b in zip(got, want):
        assert ((a - b).norm() / b.norm()).item() <= 1e-2


@pytest.mark.parametrize("case,reason", [("float32 rows", "rows not bfloat16"),
                                         ("transposed", "not contiguous"),
                                         ("dest on the CPU", "not on one CUDA device")])
def test_the_permutation_refuses_on_the_card(card, case, reason):
    """No call on the card falls back to the torch ops: one the kernels
    refuse raises, naming why, and launches nothing."""
    from training_operator_tpu_torch.trainer import moe, permute

    x = torch.randn(64, 256, device="cuda").bfloat16()
    dest = torch.randperm(64 * 2 + 64, device="cuda")[:128]
    x = {"float32 rows": x.float(), "transposed": x.t().contiguous().t()}.get(case, x)
    dest = dest.cpu() if case == "dest on the CPU" else dest
    permute.reset_launches()
    with pytest.raises(ValueError, match=f"^scatter: .*refused: {reason}$"):
        moe._Dispatch.apply(x, dest, 64 * 2 + 64, 2)
    assert permute.launches == {"scatter": 0, "gather_sum": 0}


def test_a_traced_dropless_step_permutes_in_the_kernels_alone(card):
    """Two traced steps of a dropless model (save_attn_qkv + remat_head, as
    the OLMoE cell runs): every device op under `model.moe.permute` is one
    of moe_permute.cu's kernels or its byte map's memset, none of torch's
    index or elementwise kernels, and each lies under the ranges `moe_ms`
    reads; `permute_ms` reads them; three launches of each kernel a layer
    and step (forward, recompute, backward)."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import device_trace, moe_spans
    from benchmark.metrics import permute_ms, reader
    from benchmark.tiny import REPO
    from training_operator_tpu_torch.trainer import permute
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    config = _dropless_config(remat_policy="save_attn_qkv", remat_head=True)
    optimizer = make_optimizer(warmup_steps=2, total_steps=10)
    state = init_train_state(config, optimizer, device="cuda")
    step = make_train_step(config, optimizer, device="cuda")
    batch = make_example_batch(config, 2, 512, device="cuda")
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    permute.reset_launches()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(steps):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
    per_step = 3 * config.n_layers
    assert permute.launches == {"scatter": steps * per_step, "gather_sum": steps * per_step}
    trace = device_trace.from_profiler(prof)
    under = [op for op in trace.device
             if trace.under(op, frozenset((permute_ms.PERMUTE,))) is not None]
    names = {op.name for op in under}
    assert names and all("moe_permute::" in n or "Memset" in n for n in names), names
    assert all(trace.under(op, moe_spans.LAYER) is not None for op in under)
    assert reader(REPO, "permute_ms")(SimpleNamespace(trace=trace, steps=steps)) > 0


# The fused optimizer's tensors (trainer/adamw.py): one element and three
# (scalar only), 4097 (float4 and a scalar tail of one) and 2^20 + 5 (16
# chunks of 65,536 and a ragged 17th); "odd", p, g, mu and nu each a view
# from element 1 of its storage (a scalar head of three, then float4);
# "odd p", p alone at element 1 (scalar throughout).
ADAMW_LAYOUTS = {"one": (1, (0, 0, 0, 0)), "three": (3, (0, 0, 0, 0)),
                 "4097": (4097, (0, 0, 0, 0)), "2^20+5": ((1 << 20) + 5, (0, 0, 0, 0)),
                 "odd": (5000, (1, 1, 1, 1)), "odd p": (5000, (1, 0, 0, 0))}


def _adamw_tensors(seed, scale):
    from training_operator_tpu_torch.trainer.train import AdamWState

    g = torch.Generator(device="cuda").manual_seed(seed)
    params, grads, mu, nu = {}, {}, {}, {}
    for name, (n, offsets) in ADAMW_LAYOUTS.items():
        p, gr, m, v = (torch.zeros(n + o, device="cuda")[o:] for o in offsets)
        p.copy_(torch.randn(n, generator=g, device="cuda"))
        gr.copy_(torch.randn(n, generator=g, device="cuda") * scale)
        params[name], grads[name], mu[name], nu[name] = p, gr, m, v
    return params, grads, AdamWState(count=0, mu=mu, nu=nu)


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("case", ["above-clip", "below-clip", "lr0-first-step"])
def test_fused_adamw_matches_the_loop(card, case):
    """Three steps of the fused clip + AdamW against the loop of torch ops
    (`adamw.plain_update` and the loop's norm) on the same card: p, mu, nu
    and the norm within 1e-6 (max difference over the largest magnitude;
    the kernels take the loop's roundings, the norm sums in fp64 in another
    order), under set_sync_debug_mode("error"), one launch of each pass a
    step, no memory kept beyond 1 MiB; at lr 0 (the warmup's first step) p
    stays as it was, bit for bit."""
    from training_operator_tpu_torch.trainer import adamw
    from training_operator_tpu_torch.trainer.train import AdamW, AdamWState

    scale, warmup = {"above-clip": (100.0, 0), "below-clip": (1e-4, 0),
                     "lr0-first-step": (1.0, 2)}[case]
    params, grads, state = _adamw_tensors(0, scale)
    first = {n: p.clone() for n, p in params.items()}
    ref = {n: p.clone() for n, p in params.items()}
    ref_state = AdamWState(count=0, mu={n: t.clone() for n, t in state.mu.items()},
                           nu={n: t.clone() for n, t in state.nu.items()})
    names = list(params)
    opt = AdamW(learning_rate=1e-3, warmup_steps=warmup, total_steps=10)
    for i in range(3):
        adamw.reset_launches()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.set_sync_debug_mode("error")
        try:
            norm = opt.update(grads, state, params)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.cuda.memory_allocated() - before <= 1 << 20
        assert adamw.launches == {"sumsq": 1, "update": 1}
        want = torch.sqrt(sum(grads[n].float().square().sum() for n in names))
        adamw.plain_update([ref[n] for n in names], [grads[n] for n in names],
                           [ref_state.mu[n] for n in names], [ref_state.nu[n] for n in names],
                           want, **opt.advance(ref_state))
        assert adamw.launches == {"sumsq": 1, "update": 1}
        assert _rel(norm, want) <= 1e-6
        assert (want.item() >= 1.0) == (case != "below-clip")
        for n in names:
            for got, exp in ((params[n], ref[n]), (state.mu[n], ref_state.mu[n]),
                             (state.nu[n], ref_state.nu[n])):
                assert _rel(got, exp) <= 1e-6, (case, i, n)
            if case == "lr0-first-step" and i == 0:
                assert torch.equal(params[n], first[n]), n


@pytest.mark.parametrize("case,reason", [("bfloat16", "not float32"),
                                         ("transposed", "not contiguous")])
def test_tensors_on_the_card_that_the_kernels_refuse_raise(card, case, reason):
    """No tensor on the card falls back to the loop: one the kernels refuse
    raises, naming the parameter and why, and nothing is updated."""
    from training_operator_tpu_torch.trainer import adamw
    from training_operator_tpu_torch.trainer.train import AdamW

    w = torch.randn(64, 48, device="cuda")
    w = {"bfloat16": w.bfloat16(), "transposed": w.t()}[case]
    params, grads = {"w": w}, {"w": torch.ones_like(w)}
    opt = AdamW(learning_rate=1e-3, warmup_steps=0)
    state = opt.init(params)
    first = w.clone()
    adamw.reset_launches()
    with pytest.raises(ValueError, match=f"^w: .*refused: {reason}$"):
        opt.update(grads, state, params)
    assert adamw.launches == {"sumsq": 0, "update": 0} and torch.equal(w, first)


def test_fused_global_norm_is_the_same_bit_for_bit(card):
    """The norm's passes sum in a fixed order with no atomics: the same
    gradients give the same norm and the same per-tensor sums every time,
    within 1e-6 of the loop's norm."""
    from training_operator_tpu_torch.trainer import adamw
    from training_operator_tpu_torch.trainer.train import global_norm

    _, grads, _ = _adamw_tensors(1, 1.0)
    norms = [global_norm(grads) for _ in range(3)]
    sums = [adamw.square_sums(list(grads.values()))[0] for _ in range(2)]
    assert all(torch.equal(n, norms[0]) for n in norms) and torch.equal(sums[0], sums[1])
    want = torch.sqrt(sum(t.square().sum() for t in grads.values()))
    assert _rel(norms[0], want) <= 1e-6


def test_a_traced_step_on_the_card_fuses_every_parameter(card):
    """A traced train step writes `train.optimizer.fused_share=1.0`: every
    parameter of the decoder went through the fused kernels."""
    from training_operator_tpu_torch.observe import spans

    _, _, state, step, batch = _small_train("save_attn_qkv")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.name.startswith(spans.OPTIMIZER_FUSED_SHARE)]
    assert names == [spans.OPTIMIZER_FUSED_SHARE + "=1.0"]
