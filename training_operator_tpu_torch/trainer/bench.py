"""Single-card trainer benchmark: step time, tokens/s, MFU, and the flash
kernels against their plain versions.

Counterpart of part of training_operator_tpu/trainer/bench.py
(flagship_config, _count_params, flops_per_step, bench_train_step without
the phase breakdown, bench_attention). Times come from CUDA events around
work on the card; the entry points run on the card unless the caller passes
another device, and a measurement that finds no card raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from training_operator_tpu_torch.trainer.model import TransformerConfig, resolve_device

# Peak dense bf16 FLOP/s and device-memory bytes/s per card, matched against
# torch.cuda.get_device_name by substring. NVIDIA's H100 and H200 SXM data
# sheets: 989 TFLOP/s bf16 dense; 3.35 and 4.8 TB/s.
PEAK_BF16_FLOPS = {"H100": 989e12, "H200": 989e12}
PEAK_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}


def _peak(table: Dict[str, float], device_name: str):
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def flagship_config() -> Tuple[TransformerConfig, int, int]:
    """(config, batch, seq) of the card's flagship: the ~554M-param decoder
    (d_model 1536, 12 layers, 12 heads of 128 so the flash kernels engage)
    at batch 8 x seq 2048, with full remat of each layer and of the head +
    loss (the only remat policy ported so far)."""
    return (
        TransformerConfig(
            vocab_size=32768,
            d_model=1536,
            n_layers=12,
            n_heads=12,
            n_kv_heads=12,
            d_ff=6144,
            max_seq_len=2048,
            remat_policy="full",
            remat_head=True,
        ),
        8,
        2048,
    )


def _count_params(model: torch.nn.Module) -> Tuple[int, int]:
    """(total, matmul-relevant) parameter counts; the embedding table is a
    gather, not a product."""
    total = sum(p.numel() for p in model.parameters())
    return total, total - model.embed.numel()


def flops_per_step(config: TransformerConfig, n_matmul_params: int, batch: int,
                   seq: int) -> float:
    """Model FLOPs of one fwd+bwd step: 6*N per token for weight products plus
    causal self-attention 6*L*S*d_model per token (no remat recompute)."""
    tokens = batch * seq
    attn = 6 * config.n_layers * seq * config.d_model
    return float(tokens) * (6.0 * n_matmul_params + attn)


def cuda_time_ms(fn: Callable[[], Any], iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of `fn()` in ms, from CUDA events around `iters`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_train_step(config: TransformerConfig, batch: int, seq: int,
                     steps: int = 10, warmup: int = 2, device=None) -> Dict[str, Any]:
    """Mean time of the full train step (loss, backward, clip + AdamW) over
    `steps` steps after `warmup`, on one fixed example batch."""
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_train_step measures the card; no CUDA device given")
    optimizer = make_optimizer(total_steps=steps + warmup + 1)
    state = init_train_state(config, optimizer, device=device)
    step_fn = make_train_step(config, optimizer, device=device)
    data = make_example_batch(config, batch, seq, device=device)
    total, n_matmul = _count_params(state.model)
    metrics = {}

    def one_step():
        nonlocal state, metrics
        state, metrics = step_fn(state, data)

    torch.cuda.reset_peak_memory_stats(device)
    step_ms = cuda_time_ms(one_step, iters=steps, warmup=warmup)
    name = torch.cuda.get_device_name(device)
    peak = _peak(PEAK_BF16_FLOPS, name)
    achieved = flops_per_step(config, n_matmul, batch, seq) / (step_ms / 1e3)
    return {
        "platform": "gpu",
        "device_kind": name,
        "params_m": total / 1e6,
        "batch": batch,
        "seq": seq,
        "step_time_ms_avg": step_ms,
        "tokens_per_s": batch * seq / (step_ms / 1e3),
        "model_tflops_per_s": achieved / 1e12,
        "mfu": achieved / peak if peak else None,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "final_loss": float(metrics["loss"]),
    }


def _kernel_family(name: str) -> str:
    if "fwd_kernel" in name or "bwd_dq_kernel" in name or "bwd_dkv_kernel" in name:
        return "flash (this port)"
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions"
    return "elementwise and other"


def profile_train_step(config: TransformerConfig, batch: int, seq: int,
                       steps: int = 2, top: int = 30, device=None) -> Dict[str, Any]:
    """Where one train step's device time goes: torch.profiler over `steps`
    steps after one warm-up step; device time per kernel family and the top
    kernels by name, the share of the window the device was idle, and the
    forward / backward / optimizer phases by subtraction (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    from training_operator_tpu_torch.trainer.model import loss_fn
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_example_batch,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("profile_train_step measures the card; no CUDA device given")
    optimizer = make_optimizer(total_steps=steps + 2)
    state = init_train_state(config, optimizer, device=device)
    step_fn = make_train_step(config, optimizer, device=device)
    data = make_example_batch(config, batch, seq, device=device)
    state, _ = step_fn(state, data)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            state, _ = step_fn(state, data)
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)

    # Phases by subtraction, as the JAX bench's phase breakdown: forward
    # alone, forward + backward, and the rest of the step (clip + AdamW).
    model = state.model

    def forward_only():
        with torch.no_grad():
            loss_fn(model, data)

    def forward_backward():
        for p in model.parameters():
            p.grad = None
        loss_fn(model, data).backward()

    fwd_ms = cuda_time_ms(forward_only, iters=steps, warmup=1)
    fwdbwd_ms = cuda_time_ms(forward_backward, iters=steps, warmup=1)
    for p in model.parameters():
        p.grad = None
    by_name: Dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    families: Dict[str, float] = {}
    for name, ms in by_name.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "step_ms": window_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "device_idle_share": (1.0 - busy / window_ms) if by_name else None,
        "phases_ms": {"forward": fwd_ms, "backward_with_recompute": fwdbwd_ms - fwd_ms,
                      "optimizer_and_rest": window_ms / steps - fwdbwd_ms},
        "families_ms_per_step": families,
        "top_kernels_ms_per_step": [[name[:120], ms / steps] for name, ms in ranked],
    }


def attention_work(batch: int, seq: int, heads: int, head_dim: int, causal: bool
                   ) -> Dict[str, Dict[str, float]]:
    """FLOPs and bytes each flash kernel must do on these shapes: the (q, k)
    pairs the mask keeps, 2*D FLOP per pair per product; each input read once
    and each output written once (bf16 tensors, fp32 lse/delta)."""
    bh = batch * heads
    pairs = bh * (seq * (seq + 1) // 2 if causal else seq * seq)
    tensor = bh * seq * head_dim * 2
    rows = bh * seq * 4
    return {
        "flash_fwd": {"flops": 2 * 2 * head_dim * pairs, "bytes": 4 * tensor + rows},
        "flash_bwd_dq": {"flops": 3 * 2 * head_dim * pairs, "bytes": 5 * tensor + 2 * rows},
        "flash_bwd_dkv": {"flops": 4 * 2 * head_dim * pairs, "bytes": 6 * tensor + 2 * rows},
    }


def bench_attention(batch: int = 8, seq: int = 2048, heads: int = 12,
                    head_dim: int = 128, causal: bool = True, iters: int = 10,
                    device=None) -> Dict[str, Dict[str, Any]]:
    """Each flash kernel against its plain version on bf16 [B, S, H, D]
    inputs, with its bound on this card. `library_ms` times one PyTorch call
    computing the same function (scaled_dot_product_attention for the
    forward; none computes dq alone or dk/dv alone, so those are None and
    `library_bwd_ms` times SDPA's whole backward instead). The port never
    calls SDPA; it is a yardstick here only."""
    from training_operator_tpu_torch.trainer import flash

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_attention measures the card; no CUDA device given")
    g = torch.Generator(device=device).manual_seed(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v, do = (torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)
                   for _ in range(4))
    out, lse = flash.flash_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(batch * heads, seq)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's [B, H, S, D]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o_sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    do_t = do.transpose(1, 2)

    def sdpa_bwd():
        torch.autograd.grad(o_sdpa, (qg, kg, vg), do_t, retain_graph=True)

    runs = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, causal),
                      lambda: flash.flash_fwd_plain(q, k, v, causal), sdpa),
        "flash_bwd_dq": (lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                         lambda: flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
                         None),
        "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
                          lambda: flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal),
                          None),
    }
    name = torch.cuda.get_device_name(device)
    peak_flops = _peak(PEAK_BF16_FLOPS, name)
    peak_bytes = _peak(PEAK_BYTES_PER_S, name)
    if peak_flops is None or peak_bytes is None:
        raise ValueError(f"no published peak rates for {name!r}: bounds need them")
    work = attention_work(batch, seq, heads, head_dim, causal)
    bwd_ms = cuda_time_ms(sdpa_bwd, iters=iters)
    result = {}
    for kname, (kernel, plain, library) in runs.items():
        t_ops = work[kname]["flops"] / peak_flops * 1e3
        t_bytes = work[kname]["bytes"] / peak_bytes * 1e3
        result[kname] = {
            "shape": list(shape),
            "causal": causal,
            "ms": cuda_time_ms(kernel, iters=iters),
            "plain_ms": cuda_time_ms(plain, iters=max(2, iters // 4), warmup=1),
            "library_ms": cuda_time_ms(library, iters=iters) if library else None,
            "library_bwd_ms": None if library else bwd_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": work[kname]["flops"],
            "bytes": work[kname]["bytes"],
        }
    return result


def main() -> None:
    """`python -m training_operator_tpu_torch.trainer.bench`: the flagship
    train step, its profile and the three kernels at the flagship attention
    shape, on the card; one JSON object on stdout."""
    import json
    import subprocess

    config, batch, seq = flagship_config()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    out = {
        "card": card,
        "train_step": bench_train_step(config, batch, seq, steps=5, warmup=1),
        "profile": profile_train_step(config, batch, seq),
        "attention": bench_attention(batch, seq, config.n_heads, config.head_dim),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
