"""Per-kernel measurements on the card, the configurations chip_smoke.py
runs, and the arithmetic the benchmark's copies are held to.

- The kernels alone: `bench_attention` (the flash kernels beside their
  plain versions, SDPA and their bounds), `bench_head` and
  `head_float64_errors` (the fp32 head's products), `bench_adamw` (the
  fused clip + AdamW) and `bench_permute` (the dropless expert layer's
  permutation), timed by CUDA events (`cuda_time_ms`); chip_smoke.py
  phases 3, 17, 18 and 19 print them. Each raises without a card.
- The configurations of chip_smoke.py's phases: `flagship_config`,
  `flagship_fp32_config`, `moe_config`, `pipeline_config` and
  `gemma2b_config`, with `moe_routing` for phase 9.
- The arithmetic: the peaks, `_count_params`, `flops_per_step` under
  `FLOPS_RULE` and `attention_work`. benchmark/ keeps copies of them
  (families/decoder.py, yardstick.py), and benchmark/test_bench_configs.py
  holds each copy to the original here.

The train step itself is measured by benchmark/run.py alone.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from training_operator_tpu_torch.trainer.model import TransformerConfig, resolve_device

# Peak dense bf16 FLOP/s and device-memory bytes/s per card, matched against
# torch.cuda.get_device_name by substring. NVIDIA's H100 and H200 SXM data
# sheets: 989 TFLOP/s bf16 dense; 3.35 and 4.8 TB/s.
PEAK_BF16_FLOPS = {"H100": 989e12, "H200": 989e12}
PEAK_BYTES_PER_S = {"H100": 3.35e12, "H200": 4.8e12}
# Dense TF32 FLOP/s (the same data sheets): the fp32 kernels' products run
# as 3xTF32, three TF32 products each, so their fastest fp32-class rate is
# a third of it (FLOP_RULES).
PEAK_TF32_FLOPS = {"H100": 495e12, "H200": 495e12}
# The rate each input dtype's attention products are bounded by.
FLOP_RULES = {
    torch.bfloat16: "bf16 tensor cores, 989 TFLOP/s",
    torch.float16: "fp16 tensor cores, 989 TFLOP/s",
    torch.float32: "3xTF32, 495 / 3 = 165 TFLOP/s",
}


def _peak(table: Dict[str, float], device_name: str):
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def peak_flops(device_name: str, dtype: torch.dtype = torch.bfloat16):
    """The peak FLOP/s of the attention products on `dtype` inputs under
    FLOP_RULES, or None for a card without published rates."""
    if dtype == torch.float32:
        tf32 = _peak(PEAK_TF32_FLOPS, device_name)
        return None if tf32 is None else tf32 / 3
    return _peak(PEAK_BF16_FLOPS, device_name)


# benchmark/yardstick.py copies PEAK_BF16_FLOPS, PEAK_BYTES_PER_S and
# `_kernel_family`, and benchmark/test_bench_configs.py holds the copies to
# these; nothing in the program calls `_kernel_family`.
def _kernel_family(name: str) -> str:
    if re.search(r"(fwd|bwd_dq|bwd_dkv)(_f32)?_kernel", name):
        return "flash (this port)"
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions"
    return "elementwise and other"


def flagship_config() -> Tuple[TransformerConfig, int, int]:
    """(config, batch, seq) of the card's flagship, the JAX package's own:
    the ~554M-param decoder (d_model 1536, 12 layers, 12 heads of 128 so the
    flash kernels engage) at batch 8 x seq 2048. Each layer keeps its
    attention residuals (q, k, v, out, lse) under `save_attn_qkv`, so
    backward recomputes neither the qkv products nor the flash forward; the
    head + loss region is rematerialised so its [B, S, V] logits are not
    kept."""
    return (
        TransformerConfig(
            vocab_size=32768,
            d_model=1536,
            n_layers=12,
            n_heads=12,
            n_kv_heads=12,
            d_ff=6144,
            max_seq_len=2048,
            remat_policy="save_attn_qkv",
            remat_head=True,
        ),
        8,
        2048,
    )


def flagship_fp32_config() -> Tuple[TransformerConfig, int, int]:
    """(config, batch, seq) of chip_smoke.py phase 14: the flagship in full
    precision (`dtype=float32`), the run a team makes to check a bf16 run's
    loss, and the dtype the CPU parity tests hold the two packages in. Same
    widths, policy and batch as `flagship_config`, nothing cut; the fp32
    flash kernels run its attention."""
    config, batch, seq = flagship_config()
    return dataclasses.replace(config, dtype=torch.float32), batch, seq


def moe_config() -> Tuple[TransformerConfig, int, int]:
    """(config, batch, seq) of chip_smoke.py phase 9: the flagship at full
    width with a switch MoE of 8 experts at capacity factor 1.25 in every
    layer, Switch-Base-8's expert count and training capacity (Fedus et
    al., 2021): 2.93B parameters, one expert's MLP (the flagship's d_ff)
    active per token."""
    config, batch, seq = flagship_config()
    return dataclasses.replace(config, n_experts=8, expert_capacity=1.25), batch, seq


def pipeline_config() -> Tuple[TransformerConfig, int, int, int]:
    """(config, batch, seq, stages) of chip_smoke.py phase 10: the dense
    flagship as 2 GPipe stages with 4 microbatches of 2 x 2048, run
    through the loopback transport on one card."""
    config, batch, seq = flagship_config()
    return dataclasses.replace(config, pipeline_microbatches=4), batch, seq, 2


def gemma2b_config() -> Tuple[TransformerConfig, int, int]:
    """(config, batch, seq) of chip_smoke.py phase 13: Gemma-2B's published
    widths (Gemma Team 2024, "Gemma: Open Models Based on Gemini Research
    and Technology", Table 1; the google/gemma-2b model card's config) on
    the repo's decoder: vocab 256000, d_model 2048, 18 layers, 8 heads of
    256 over one kv head (multi-query), d_ff 16384, rope theta 10000; bf16
    compute and fp32 params, `save_attn_qkv` + `remat_head` as the
    flagship; batch 1 x seq 4096. 3,030,460,416 parameters, 2,506,172,416
    of them in products. Cuts: seq 4096, not Gemma's 8192 (at 8192 the head
    and loss hold three [8192, 256000] fp32 logit buffers, ~25 GB, beside
    48.5 GB of params, grads and AdamW moments); and the repo's decoder, so
    SwiGLU, not GeGLU, an untied lm_head, no sqrt(d_model) embedding scale
    and RMSNorm by w, not 1 + w. Head_dim 256 takes the flash kernels."""
    return (
        TransformerConfig(
            vocab_size=256000,
            d_model=2048,
            n_layers=18,
            n_heads=8,
            n_kv_heads=1,
            d_ff=16384,
            max_seq_len=4096,
            rope_theta=10000.0,
            remat_policy="save_attn_qkv",
            remat_head=True,
        ),
        1,
        4096,
    )


def _count_params(model: torch.nn.Module) -> Tuple[int, int]:
    """(total, matmul-relevant active) parameter counts: the embedding table
    is a gather, not a product, and of a MoE layer's expert stacks the
    share of the experts a token is sent to (one for the switch layer;
    FLOPS_RULE)."""
    total = sum(p.numel() for p in model.parameters())
    products = total - model.embed.numel()
    c = model.config
    if c.n_experts > 0:
        experts = sum(getattr(model.layers, n).numel() for n in ("w1", "w3", "w2"))
        products -= experts - experts * c.n_experts_per_tok // c.n_experts
    return total, products


FLOPS_RULE = ("6 x active params per token (the embedding gather excluded; for MoE one "
              "expert's MLP per token, capacity padding and dropped tokens not counted) "
              "+ 6 x n_layers x seq x d_model causal attention")


def flops_per_step(config: TransformerConfig, n_matmul_params: int, batch: int,
                   seq: int) -> float:
    """Model FLOPs of one fwd+bwd step (FLOPS_RULE): 6*N per token for
    weight products, N the active matmul parameters (`_count_params`), plus
    causal self-attention 6*L*S*d_model per token (no remat recompute)."""
    tokens = batch * seq
    attn = 6 * config.n_layers * seq * config.d_model
    return float(tokens) * (6.0 * n_matmul_params + attn)


@torch.no_grad()
def moe_routing(model, tokens: torch.Tensor,
                config: Optional[TransformerConfig] = None) -> Dict[str, list]:
    """Per layer of an unsharded MoE model, from one forward on `tokens`:
    the share of the tokens routed to each expert (`expert_shares`) and the
    share dropped at capacity (`dropped_share`)."""
    from training_operator_tpu_torch.trainer import model as m
    from training_operator_tpu_torch.trainer.moe import route

    c = config or model.config
    b, s = tokens.shape
    x = m.embed_tokens(model.embed, tokens, c)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    shares, dropped = [], []
    for lp in model.layers.unbind():
        x = x + m._attn_block(x, lp, c, positions, c.attn_impl)
        choice, _, _, keep, _, _ = route(m._rms_norm(x, lp["ln2"], c.rms_norm_eps), lp["router"], c)
        counts = torch.bincount(choice, minlength=c.n_experts)
        shares.append((counts.float() / choice.numel()).tolist())
        dropped.append(1.0 - keep.float().mean().item())
        x = m._add_mlp(x, lp, c, None)[0]
    return {"expert_shares": shares, "dropped_share": dropped}


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


def attention_work(batch: int, seq: int, heads: int, head_dim: int, causal: bool,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, Dict[str, float]]:
    """FLOPs and bytes each flash kernel must do on these shapes: the (q, k)
    pairs the mask keeps, 2*D FLOP per pair per product; each input read once
    and each output written once (tensors of `dtype`, fp32 lse/delta). The
    FLOPs run at the rate FLOP_RULES names for `dtype`."""
    bh = batch * heads
    pairs = bh * (seq * (seq + 1) // 2 if causal else seq * seq)
    tensor = bh * seq * head_dim * torch.empty((), dtype=dtype).element_size()
    rows = bh * seq * 4
    return {
        "flash_fwd": {"flops": 2 * 2 * head_dim * pairs, "bytes": 4 * tensor + rows},
        "flash_bwd_dq": {"flops": 3 * 2 * head_dim * pairs, "bytes": 5 * tensor + 2 * rows},
        "flash_bwd_dkv": {"flops": 4 * 2 * head_dim * pairs, "bytes": 6 * tensor + 2 * rows},
    }


def bench_attention(batch: int = 8, seq: int = 2048, heads: int = 12,
                    head_dim: int = 128, causal: bool = True, iters: int = 10,
                    device=None, dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, Dict[str, Any]]:
    """Each flash kernel against its plain version on [B, S, H, D] inputs of
    `dtype`, with its bound on this card (at the rate `bound_rule` names,
    FLOP_RULES). `library_ms` times one PyTorch call computing the same
    function on the same inputs (scaled_dot_product_attention for the
    forward; none computes dq alone or dk/dv alone, so those are None and
    `library_bwd_ms` times SDPA's whole backward instead). The row
    `flash_bwd` is the backward pair, dq then dk/dv, beside SDPA's whole
    backward as its `library_ms`. The port never calls SDPA; it is a
    yardstick here only."""
    from training_operator_tpu_torch.trainer import flash

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_attention measures the card; no CUDA device given")
    g = torch.Generator(device=device).manual_seed(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v, do = (torch.randn(shape, generator=g, device=device, dtype=dtype)
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
    peak = peak_flops(name, dtype)
    peak_bytes = _peak(PEAK_BYTES_PER_S, name)
    if peak is None or peak_bytes is None:
        raise ValueError(f"no published peak rates for {name!r}: bounds need them")
    dq, dkv = runs["flash_bwd_dq"], runs["flash_bwd_dkv"]
    runs["flash_bwd"] = (lambda: (dq[0](), dkv[0]()), lambda: (dq[1](), dkv[1]()), sdpa_bwd)
    work = attention_work(batch, seq, heads, head_dim, causal, dtype)
    work["flash_bwd"] = {key: work["flash_bwd_dq"][key] + work["flash_bwd_dkv"][key]
                         for key in ("flops", "bytes")}
    result = {}
    for kname, (kernel, plain, library) in runs.items():
        t_ops = work[kname]["flops"] / peak * 1e3
        t_bytes = work[kname]["bytes"] / peak_bytes * 1e3
        result[kname] = {
            "shape": list(shape),
            "dtype": str(dtype).removeprefix("torch."),
            "causal": causal,
            "ms": cuda_time_ms(kernel, iters=iters),
            "plain_ms": cuda_time_ms(plain, iters=max(2, iters // 4), warmup=1),
            "library_ms": cuda_time_ms(library, iters=iters) if library else None,
            "library_bwd_ms": None,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rule": FLOP_RULES[dtype],
            "flops": work[kname]["flops"],
            "bytes": work[kname]["bytes"],
        }
    # dq and dk/dv alone have no library call: SDPA's whole backward, timed
    # once, in the pair's row.
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        result[kname]["library_bwd_ms"] = result["flash_bwd"]["library_ms"]
    return result


# (T, D, V) of the fp32 head in the benchmark's cells (benchmark/configs):
# tokens a step, d_model and vocabulary.
HEAD_SHAPES = {
    "mistral7b_v03_stage8.seq4k": (16384, 4096, 32768),
    "internlm2_1p8b.seq4k and .seq16k": (16384, 2048, 92544),
    "mistral7b_v03_stage8.seq32k": (32768, 4096, 32768),
}


def _head_runs(t: int, d: int, v: int, device, seed: int = 0):
    """x [t, d], W [d, v] and dL [t, v] of N(0, 1) in fp32, and for each
    head product its kernel call and the same product by torch.matmul (the
    yardstick; the port's head never calls it on the card)."""
    from training_operator_tpu_torch.trainer import head_gemm

    g = torch.Generator(device=device).manual_seed(seed)
    x, w, dl = (torch.randn(shape, generator=g, device=device)
                for shape in ((t, d), (d, v), (t, v)))
    return (x, w, dl), {
        "logits": (lambda: head_gemm.head_logits(x, w), lambda: x @ w),
        "dx": (lambda: head_gemm.head_dx(dl, w), lambda: dl @ w.t()),
        "dw": (lambda: head_gemm.head_dw(x, dl), lambda: x.t() @ dl),
    }


def bench_head(t: int, d: int, v: int, iters: int = 5, device=None) -> Dict[str, Dict[str, Any]]:
    """Each head product's kernel ms beside its bound (2 t d v FLOP at
    3xTF32's 165 TFLOP/s) and torch.matmul's ms on the same fp32 operands
    (`library_ms`: cuBLAS's SGEMM unless the caller allows TF32)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_head measures the card; no CUDA device given")
    peak = peak_flops(torch.cuda.get_device_name(device), torch.float32)
    if peak is None:
        raise ValueError("no published peak rates for this card: bounds need them")
    _, runs = _head_runs(t, d, v, device)
    flops = 2.0 * t * d * v
    result = {}
    for name, (kernel, library) in runs.items():
        ms = cuda_time_ms(kernel, iters=iters, warmup=1)
        result[name] = {"shape": [t, d, v], "ms": ms, "bound_ms": flops / peak * 1e3,
                        "library_ms": cuda_time_ms(library, iters=iters, warmup=1),
                        "tflops": flops / ms / 1e9}
    return result


def head_float64_errors(t: int, d: int, v: int, sample: int = 256,
                        device=None) -> Dict[str, Dict[str, float]]:
    """Max abs error of each head product, by the kernel and by
    torch.matmul (as the caller's TF32 setting has it), against float64 on
    `sample` evenly spaced rows of the logits and of dX and columns of dW,
    beside the largest magnitude there."""
    device = resolve_device(device)
    (x, w, dl), runs = _head_runs(t, d, v, device)
    rows = torch.arange(0, t, max(1, t // sample), device=device)[:sample]
    cols = torch.arange(0, v, max(1, v // sample), device=device)[:sample]
    refs = {"logits": (x[rows].double() @ w.double(), lambda y: y[rows]),
            "dx": (dl[rows].double() @ w.double().t(), lambda y: y[rows]),
            "dw": (x.double().t() @ dl[:, cols].double(), lambda y: y[:, cols])}
    result = {}
    for name, (kernel, library) in runs.items():
        ref, pick = refs[name]
        result[name] = {"kernel": (pick(kernel()).double() - ref).abs().max().item(),
                        "library": (pick(library()).double() - ref).abs().max().item(),
                        "max_abs": ref.abs().max().item()}
    return result


# Bytes of device memory the fused clip + AdamW moves a parameter: g read
# for the norm, then p, g, mu and nu read and p, mu and nu written.
ADAMW_BYTES = 32


def _max_rel(got: torch.Tensor, want: torch.Tensor, chunk: int = 1 << 26) -> float:
    """max |got - want| / max |want|, a run of `chunk` elements at a time, so
    its temporaries stay small beside a multi-GB tensor."""
    pairs = list(zip(got.reshape(-1).split(chunk), want.reshape(-1).split(chunk)))
    diff = torch.stack([(a.double() - b.double()).abs().max() for a, b in pairs]).max()
    top = torch.stack([b.double().abs().max() for _, b in pairs]).max()
    return (diff / top.clamp(min=1e-30)).item()


def bench_adamw(shapes: Dict[str, tuple], iters: int = 10, loop_iters: int = 2,
                device=None) -> Dict[str, Any]:
    """Clip + AdamW over fp32 parameters, gradients and moments of `shapes`
    on the card. First the kernels (trainer/adamw.py) against the loop of
    torch ops (`adamw.plain_update` and the loop's norm) from the same first
    values, one parameter's tensors at a time, so that the largest
    configuration fits beside its state: `errors`, max |difference| over
    the largest magnitude of p, mu, nu and the norm (and of the norm
    against a float64 one, `norm_fp64`). Then times, means by CUDA events:
    the fused step (`ms`: `AdamW.update` as the train step calls it, the
    norm's two passes and the update; `iters` calls) and the norm's alone
    (`norm_ms`), beside the step's bound (ADAMW_BYTES a parameter at the
    card's peak bytes/s); the loop's step (`plain_ms`, `loop_iters` calls);
    and torch's own multi-tensor kernels on the same tensors
    (`library_ms`: `torch._foreach_norm`, then `torch._fused_adamw_` with
    the clip factor as its device `grad_scale`, which also writes the
    unscaled gradients back; `iters` calls, last, as they change g)."""
    from training_operator_tpu_torch.trainer import adamw
    from training_operator_tpu_torch.trainer.train import AdamW, AdamWState, global_norm

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_adamw measures the card; no CUDA device given")
    peak = _peak(PEAK_BYTES_PER_S, torch.cuda.get_device_name(device))
    if peak is None:
        raise ValueError("no published peak rates for this card: bounds need them")
    names = list(shapes)
    gen = torch.Generator(device=device)

    def fill(i: int, role: int, t: torch.Tensor) -> torch.Tensor:
        """Tensor `i`'s first values in `role` (p, g, mu, nu), in place, from
        a seed of their own, so they can be made again."""
        gen.manual_seed(4 * i + role)
        t.normal_(generator=gen)
        return {0: lambda: t.mul_(0.02), 1: lambda: t, 2: lambda: t.mul_(1e-3),
                3: lambda: t.square_().mul_(1e-6)}[role]()

    def first(role: int) -> Dict[str, torch.Tensor]:
        return {n: fill(i, role, torch.empty(shapes[n], device=device))
                for i, n in enumerate(names)}

    params, grads = first(0), first(1)
    state = AdamWState(count=0, mu=first(2), nu=first(3))
    n = sum(p.numel() for p in params.values())
    opt = AdamW(learning_rate=3e-4, warmup_steps=0)

    hyper = opt.advance(AdamWState(count=4))
    want = torch.sqrt(sum(grads[k].float().square().sum() for k in names))
    exact = torch.sqrt(sum(c.double().square().sum() for k in names
                           for c in grads[k].reshape(-1).split(1 << 26)))
    _, norm = adamw.square_sums([grads[k] for k in names])
    adamw.update([params[k] for k in names], [grads[k] for k in names],
                 [state.mu[k] for k in names], [state.nu[k] for k in names], norm, **hyper)
    errors = {"norm": _max_rel(norm, want), "norm_fp64": _max_rel(norm, exact),
              "p": 0.0, "mu": 0.0, "nu": 0.0}
    for i, k in enumerate(names):
        ref = [fill(i, role, torch.empty_like(params[k])) for role in (0, 2, 3)]
        adamw.plain_update([ref[0]], [grads[k]], [ref[1]], [ref[2]], want, **hyper)
        for key, got, exp in zip(("p", "mu", "nu"), (params[k], state.mu[k], state.nu[k]), ref):
            errors[key] = max(errors[key], _max_rel(got, exp))
        del ref
        torch.cuda.empty_cache()

    adamw.reset_launches()
    ms = cuda_time_ms(lambda: opt.update(grads, state, params), iters=iters, warmup=1)
    fused = dict(adamw.launches)
    norm_ms = cuda_time_ms(lambda: global_norm(grads), iters=iters, warmup=1)

    lists = [[d[k] for k in names] for d in (params, grads, state.mu, state.nu)]

    def plain():
        loop_norm = torch.sqrt(sum(g.float().square().sum() for g in lists[1]))
        adamw.plain_update(*lists, loop_norm, **opt.advance(state))

    plain_ms = cuda_time_ms(plain, iters=loop_iters, warmup=1)
    steps = [torch.ones((), device=device) for _ in names]

    def library():
        total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(lists[1])))
        torch._fused_adamw_(*lists, [], steps, lr=hyper["lr"], beta1=opt.b1, beta2=opt.b2,
                            weight_decay=opt.weight_decay, eps=opt.eps, amsgrad=False,
                            maximize=False, grad_scale=(total / opt.clip_norm).clamp(min=1.0),
                            found_inf=None)

    library_ms = cuda_time_ms(library, iters=iters, warmup=1)
    bound_ms = ADAMW_BYTES * n / peak * 1e3
    return {"params": n, "tensors": len(shapes), "ms": ms, "norm_ms": norm_ms,
            "bound_ms": bound_ms, "ms_over_bound": ms / bound_ms,
            "tb_per_s": ADAMW_BYTES * n / ms / 1e9, "plain_ms": plain_ms,
            "library_ms": library_ms, "errors": errors,
            "launches": {k: v // (iters + 1) for k, v in fused.items()}}


# The dropless expert layer's permutation at OLMoE's shape
# (benchmark/configs/olmoe_1b7b_stage8.json: 4 x 4096 tokens of 2048, top-8
# of 64 experts).
PERMUTE_SHAPE = dict(tokens=16384, d=2048, experts=64, k=8)
PERMUTE_USES = ("dispatch", "combine", "combine_backward", "dispatch_backward")


def permute_bytes(tokens: int, k: int, d: int, rows: int) -> Dict[str, int]:
    """Bytes each use of the permutation must move (csrc/moe_permute.cu):
    bf16 rows of D, the buffer's `rows` written whole, its T k named rows
    read, the token rows read or written once, dest (int64) and the gates
    (fp32) read once, the gate's gradient written once."""
    row, pairs = 2 * d, tokens * k
    return {"dispatch": tokens * row + rows * row + 8 * pairs,
            "combine": pairs * row + tokens * row + 12 * pairs,
            "combine_backward": tokens * row + pairs * row + rows * row + 16 * pairs,
            "dispatch_backward": pairs * row + tokens * row + 8 * pairs}


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of bf16's last place at the larger
    of the two magnitudes (2^(e - 8) for a value of m 2^e, m in [0.5, 1))."""
    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return ((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max().item()


def bench_permute(tokens: int = PERMUTE_SHAPE["tokens"], d: int = PERMUTE_SHAPE["d"],
                  experts: int = PERMUTE_SHAPE["experts"], k: int = PERMUTE_SHAPE["k"],
                  iters: int = 10, device=None) -> Dict[str, Dict[str, Any]]:
    """The four uses of the permutation kernels (trainer/permute.py) on
    seeded hidden states routed by the layer's own router and group layout,
    on the card: {use: fields}. `ms`, means by CUDA events of `iters` calls,
    beside `bound_ms` (`permute_bytes` at the card's peak bytes/s) and
    `plain_ms`, the torch ops they replace (moe.plain_dispatch,
    plain_combine, its autograd backward alone, plain_dispatch_backward).
    `exact` where a use must equal the torch ops bit for bit (the dispatch
    and y's gradient, padding rows zero included), `ulps` where it may
    differ by the k-sum's order (the combine and the dispatch's backward),
    and for the gate's gradient its max error against float64 beside the
    torch ops' (`err`, `plain_err`)."""
    from types import SimpleNamespace

    from training_operator_tpu_torch.trainer import moe, permute

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("bench_permute measures the card; no CUDA device given")
    peak = _peak(PEAK_BYTES_PER_S, torch.cuda.get_device_name(device))
    if peak is None:
        raise ValueError("no published peak rates for this card: bounds need them")
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(tokens, d, generator=g, device=device).bfloat16()
    router = torch.randn(d, experts, generator=g, device=device) * 0.02
    gate, choice, counts, _ = moe.route_topk(x, router, SimpleNamespace(
        n_experts=experts, n_experts_per_tok=k))
    dest, _, rows = moe.group_layout(choice, counts, experts)
    d2 = dest.view(tokens, k)
    y, grad_xs = (torch.randn(rows, d, generator=g, device=device).bfloat16() for _ in range(2))
    dout = torch.randn(tokens, d, generator=g, device=device).bfloat16()
    leaves = y.clone().requires_grad_(), gate.clone().requires_grad_()
    combined = moe.plain_combine(*leaves, dest)

    kernel = {"dispatch": lambda: permute.scatter(x, d2, rows),
              "combine": lambda: permute.gather_sum(y, d2, gate),
              "combine_backward": lambda: permute.scatter(dout, d2, rows, gate, y),
              "dispatch_backward": lambda: permute.gather_sum(grad_xs, d2)}
    plain = {"dispatch": lambda: moe.plain_dispatch(x, dest, rows, k),
             "combine": lambda: moe.plain_combine(y, gate, dest),
             "combine_backward": lambda: torch.autograd.grad(combined, leaves, dout,
                                                             retain_graph=True),
             "dispatch_backward": lambda: moe.plain_dispatch_backward(grad_xs, dest, k)}
    got = {use: fn() for use, fn in kernel.items()}
    want = {use: fn() for use, fn in plain.items()}
    named = torch.zeros(rows, dtype=torch.bool, device=device)
    named[dest] = True
    exact = torch.bmm(y.double()[dest].view(tokens, k, d), dout.double()[:, :, None])[..., 0]
    checks = {
        "dispatch": {"exact": torch.equal(got["dispatch"], want["dispatch"])
                     and not got["dispatch"][~named].any().item()},
        "combine": {"ulps": bf16_ulps(got["combine"], want["combine"])},
        "combine_backward": {
            "exact": torch.equal(got["combine_backward"][0], want["combine_backward"][0])
            and not got["combine_backward"][0][~named].any().item(),
            "err": (got["combine_backward"][1].double() - exact).abs().max().item(),
            "plain_err": (want["combine_backward"][1].double() - exact).abs().max().item()},
        "dispatch_backward": {"ulps": bf16_ulps(got["dispatch_backward"],
                                                want["dispatch_backward"])},
    }
    del got, want, exact
    moved = permute_bytes(tokens, k, d, rows)
    out = {}
    for use in PERMUTE_USES:
        ms = cuda_time_ms(kernel[use], iters=iters)
        bound_ms = moved[use] / peak * 1e3
        out[use] = {"ms": ms, "plain_ms": cuda_time_ms(plain[use], iters=iters),
                    "bound_ms": bound_ms, "ms_over_bound": ms / bound_ms,
                    "tb_per_s": moved[use] / ms / 1e9, "bytes": moved[use], **checks[use]}
    return out
