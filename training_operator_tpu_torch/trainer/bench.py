"""Single-card trainer benchmark: step time, tokens/s, MFU, the flash
kernels against their plain versions, and the training loop around them.

Counterpart of training_operator_tpu/trainer/bench.py (flagship_config,
_count_params, flops_per_step, bench_train_step, bench_attention,
bench_dataloader, bench_trainer_e2e, run_trainer_bench with its
attention_8k point). Times come from CUDA events around work on
the card, and the loop's from the host clock; the entry points run on the
card unless the caller passes another device, and a measurement that finds
no card raises.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
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


def active_mfu(config: TransformerConfig, batch: int, seq: int, step_ms: float) -> float:
    """The model FLOP utilization of a step of `step_ms` on an H100 (989
    TFLOP/s bf16), the parameters counted by `_count_params` on a meta
    model."""
    from training_operator_tpu_torch.trainer.model import Transformer

    n_active = _count_params(Transformer(config, "meta"))[1]
    return flops_per_step(config, n_active, batch, seq) / (step_ms / 1e3) / PEAK_BF16_FLOPS["H100"]


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


def bench_train_step(config: TransformerConfig, batch: int, seq: int,
                     steps: int = 10, warmup: int = 2, device=None) -> Dict[str, Any]:
    """Mean time of the full train step (loss, backward, clip + AdamW) over
    `steps` steps after `warmup`, on one fixed example batch. `compile_s` is
    the first step's host seconds, fenced: it includes what the first use
    of the flash kernels costs, which `kernel_load` names ("build": nvcc
    compiled them; "cache": libraries built earlier were loaded; "loaded
    before": this process had them already; None: the step ran no kernel).
    `mfu_executed_est` rescales the MFU by 8/6 for the forward a remat step
    recomputes (an upper estimate under a selective policy), None without
    remat; `profile_train_step` measures the phases and the recompute."""
    from training_operator_tpu_torch.trainer import kernels
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
    had_kernels = kernels.loaded() is not None
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0
    got = kernels.loaded()
    kernel_load = ("loaded before" if had_kernels else None if got is None
                   else "build" if got.log else "cache")
    step_ms = cuda_time_ms(one_step, iters=steps, warmup=max(0, warmup - 1))
    name = torch.cuda.get_device_name(device)
    peak = _peak(PEAK_BF16_FLOPS, name)
    achieved = flops_per_step(config, n_matmul, batch, seq) / (step_ms / 1e3)
    out = {
        "platform": "gpu",
        "device_kind": name,
        "params_m": total / 1e6,
        "batch": batch,
        "seq": seq,
        "step_time_ms_avg": step_ms,
        "tokens_per_s": batch * seq / (step_ms / 1e3),
        "model_tflops_per_s": achieved / 1e12,
        "mfu": achieved / peak if peak else None,
        "mfu_executed_est": achieved * (8.0 / 6.0) / peak if peak and config.remat else None,
        "compile_s": compile_s,
        "kernel_load": kernel_load,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "final_loss": float(metrics["loss"]),
    }
    return out


def _kernel_family(name: str) -> str:
    if re.search(r"(fwd|bwd_dq|bwd_dkv)(_f32)?_kernel", name):
        return "flash (this port)"
    lowered = name.lower()
    if any(s in lowered for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in lowered or "norm" in lowered:
        return "reductions"
    return "elementwise and other"


# CUDA runtime and low-level API calls (cuda*, cu*) among a trace's host events: their
# correlation ids are the tracer's, not the ops'.
_API_CALL = re.compile(r"^(cuda|cu[A-Z])")
PHASES = ("forward", "backward", "optimizer", "head", "recompute")


def _trace_events(prof) -> Tuple[Dict[int, list], list]:
    """A finished torch.profiler trace's raw events: the host ops by
    correlation id, each [name, start, end, thread, enclosing op's id or
    None] (the innermost op of its thread that holds it), and the device
    ops, each (name, start, end, id of the host op that launched it), in
    ns. The train step's ranges (observe/spans.py) are host ops; user
    annotations' copies on the device's timeline are left out. Of host
    events that share an id, the first is kept: the ops come before the
    trace's own events, among them the overhead of a full command buffer,
    which carries the id of an op open on the caller's thread."""
    from torch.autograd import DeviceType

    host: Dict[int, list] = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if (e.start_thread_id() == e.end_thread_id() and e.correlation_id()
                    and not _API_CALL.match(e.name()) and e.correlation_id() not in host):
                host[e.correlation_id()] = [e.name(), e.start_ns(), e.end_ns(),
                                            e.start_thread_id(), None]
        elif not e.is_user_annotation():
            device.append((e.name(), e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    threads: Dict[int, list] = {}
    for cid, (_, start, end, tid, _) in host.items():
        threads.setdefault(tid, []).append((start, -end, cid))
    for ops in threads.values():
        stack: list = []
        for start, neg_end, cid in sorted(ops):
            while stack and host[stack[-1]][2] <= start:
                stack.pop()
            if stack and host[stack[-1]][2] >= -neg_end:
                host[cid][4] = stack[-1]
            stack.append(cid)
    return host, device


def _busy_ms(device) -> float:
    """The union of the device ops' intervals, in ms: ops that overlap (on
    two streams) count once."""
    busy, reach = 0, None
    for _, start, end, _ in sorted(device, key=lambda d: d[1]):
        if reach is not None:
            start = max(start, reach)
            end = max(end, reach)
        busy += end - start
        reach = end
    return busy / 1e6


def _span_phases(host: Dict[int, list], device, steps: int) -> Dict[str, float]:
    """Device ms per step by the train step's ranges (observe/spans.py), as
    benchmark/program_spans.py reads them: by when each op's launching op
    started, on any thread, `backward` inside `train.backward` (the card's
    backward runs on autograd's device thread, outside any range of the
    caller's), `forward` and `optimizer` inside `train.step` before and
    after its backward; within those, `head` the ops under `model.head` or
    `model.head.grad` and `recompute` the backward's ops under `model.layer`
    or `model.head`. forward + backward + optimizer is the steps' device
    time; head and recompute lie inside them."""
    from training_operator_tpu_torch.observe import spans

    ranges: Dict[int, frozenset] = {}

    def names(cid):
        path = []
        while cid in host and cid not in ranges:
            path.append(cid)
            cid = host[cid][4]
        found = ranges.get(cid, frozenset())
        for cid in reversed(path):
            if host[cid][0] in spans.NAMES:
                found = found | {host[cid][0]}
            ranges[cid] = found
        return found

    def intervals(name):
        return sorted((op[1], op[2]) for op in host.values() if op[0] == name)

    def holding(spans_, t):
        i = bisect.bisect_right(spans_, (t, float("inf"))) - 1
        return spans_[i] if i >= 0 and t <= spans_[i][1] else None

    backward, step_spans = intervals(spans.BACKWARD), intervals(spans.STEP)

    def phase(cid):
        if cid not in host:
            return None
        t = host[cid][1]
        if holding(backward, t):
            return "backward"
        step = holding(step_spans, t)
        inside = [b for b in backward if step and step[0] <= b[0] <= step[1]]
        if not inside:
            return None
        return "forward" if t < inside[0][0] else "optimizer"

    out = dict.fromkeys(PHASES, 0.0)
    for _, start, end, cid in device:
        ms, found, ph = (end - start) / 1e6 / steps, names(cid), phase(cid)
        if ph:
            out[ph] += ms
        out["head"] += ms if found & {spans.HEAD, spans.HEAD_GRAD} else 0.0
        out["recompute"] += ms if ph == "backward" and found & {spans.LAYER, spans.HEAD} else 0.0
    return out


def profile_train_step(config: TransformerConfig, batch: int, seq: int,
                       steps: int = 2, top: int = 30, device=None, mesh=None,
                       stages: int = 0) -> Dict[str, Any]:
    """Where one train step's device time goes: torch.profiler over `steps`
    steps after one warm-up step; device time per kernel family and the top
    kernels by name, the share of the window (CUDA events) in which no
    device op ran, and the phases by the step's own ranges
    (`_span_phases`). With `mesh`, the step sharded on it (this rank's rows
    of the batch); with `stages`, the model as that many pipeline stages
    through the loopback transport (pipeline.loopback)."""
    from torch.profiler import ProfilerActivity, profile

    from training_operator_tpu_torch.trainer.mesh import shard_batch
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
    state = init_train_state(config, optimizer, device=device, mesh=mesh)
    if stages:
        from training_operator_tpu_torch.trainer.pipeline import loopback

        loopback(state.model, stages)
    step_fn = make_train_step(config, optimizer, device=device, mesh=mesh)
    data = make_example_batch(config, batch, seq, device=device)
    if mesh is not None:
        data = shard_batch(data, mesh, config.pipeline_microbatches)
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
    host, dev = _trace_events(prof)
    by_name = _by_name(dev)
    busy = _busy_ms(dev)
    families: Dict[str, float] = {}
    for name, ms in by_name.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "step_ms": window_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "device_idle_share": (1.0 - busy / window_ms) if dev else None,
        "phases_ms": _span_phases(host, dev, steps),
        "families_ms_per_step": families,
        "top_kernels_ms_per_step": [[name[:120], ms / steps] for name, ms in ranked],
    }


def _by_name(device) -> Dict[str, float]:
    """Device ms of the ops of each name, summed."""
    out: Dict[str, float] = {}
    for name, start, end, _ in device:
        out[name] = out.get(name, 0.0) + (end - start) / 1e6
    return out


RING_CASES = (((8, 2048, 12, 128), 2), ((8, 2048, 12, 128), 4), ((2, 8192, 12, 128), 4))


def profile_ring(shape=(8, 2048, 12, 128), ns: int = 2, iters: int = 5, top: int = 12,
                 device=None) -> Dict[str, Any]:
    """The ring's per-rank body for `ns` ranks through the loopback
    transport (attention.ring_loopback: every rank's forward, then every
    rank's backward), bf16 causal on random inputs of `shape`: its CUDA-event
    time beside the unsplit flash forward + backward, and a torch.profiler
    window over `iters` calls, the device time by kernel family and top
    kernels per call and the device's idle share (`_busy_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    from training_operator_tpu_torch.trainer import attention, flash

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("profile_ring measures the card; no CUDA device given")
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)
                   for _ in range(4))
    blocks = [[c.contiguous() for c in x.chunk(ns, 1)] for x in (q, k, v, do)]

    def ring():
        attention.ring_loopback(*blocks, True)

    def unsplit():
        o, lse = flash.flash_fwd(q, k, v, True)
        delta = flash.row_delta(do, o)
        flash.flash_bwd_dq(q, k, v, do, lse, delta, True)
        flash.flash_bwd_dkv(q, k, v, do, lse, delta, True)

    out = {"shape": list(shape), "ns": ns, "ring_ms": cuda_time_ms(ring, iters),
           "unsplit_ms": cuda_time_ms(unsplit, iters)}
    out["overhead_pct"] = 100 * (out["ring_ms"] / out["unsplit_ms"] - 1)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            ring()
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    dev = _trace_events(prof)[1]
    by_name = _by_name(dev)
    busy = _busy_ms(dev)
    families: Dict[str, float] = {}
    for name, ms in by_name.items():
        fam = _kernel_family(name)
        families[fam] = families.get(fam, 0.0) + ms / iters
    out.update(profiled_ms=window_ms / iters, device_busy_ms=busy / iters,
               device_idle_share=(1.0 - busy / window_ms) if dev else None,
               families_ms=families,
               top_kernels_ms=[[n[:100], ms / iters] for n, ms in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:top]])
    return out


def profile_mesh_step(config: TransformerConfig, batch: int, seq: int) -> Dict[str, Any]:
    """`profile_train_step` unsharded, then sharded on the mesh
    fsdp=1,tensor=1 of a world of one NCCL rank (a file store in a
    temporary directory): what the sharded path costs on one card."""
    import tempfile

    from training_operator_tpu_torch.trainer import distributed
    from training_operator_tpu_torch.trainer.mesh import MeshSpec, build_mesh

    out = {"unsharded": profile_train_step(config, batch, seq)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize({"NUM_PROCESSES": "1", "PROCESS_ID": "0"},
                               init_method=f"file://{tmp}/store")
        try:
            mesh = build_mesh(MeshSpec({"fsdp": 1, "tensor": 1}), "cuda")
            out["sharded_world_of_one"] = profile_train_step(config, batch, seq, mesh=mesh)
        finally:
            distributed.shutdown()
    return out


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


def float64_errors(batch: int = 8, seq: int = 2048, heads: int = 12, head_dim: int = 128,
                   causal: bool = True, dtype: torch.dtype = torch.float32,
                   device=None) -> Dict[str, Dict[str, float]]:
    """Max abs error of each kernel output (out; dq, dk, dv given the
    kernel's own lse and delta) and of its plain version against the same
    function in float64 on the same inputs, beside the output's largest
    magnitude: how far each is from the exact result, where the kernel's
    gap to its plain version alone cannot say which of the two is off."""
    from training_operator_tpu_torch.trainer import flash

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("float64_errors measures the card; no CUDA device given")
    g = torch.Generator(device=device).manual_seed(0)
    shape = (batch, seq, heads, head_dim)
    q, k, v, do = (torch.randn(shape, generator=g, device=device, dtype=dtype)
                   for _ in range(4))
    out, lse = flash.flash_fwd(q, k, v, causal)
    delta = flash.row_delta(do, out)
    got = {"out": out, "dq": flash.flash_bwd_dq(q, k, v, do, lse, delta, causal)}
    got["dk"], got["dv"] = flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    plain = {"out": flash.flash_fwd_plain(q, k, v, causal)[0],
             "dq": flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)}
    plain["dk"], plain["dv"] = flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    # The plain versions' arithmetic in float64 ([B, H, S, S] scores).
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * head_dim ** -0.5
    if causal:
        keep = torch.ones(seq, seq, dtype=torch.bool, device=device).tril()
        sc = sc.masked_fill(~keep, -1e30)
    p = torch.softmax(sc, dim=-1)
    ref = {"out": torch.einsum("bhqk,bkhd->bqhd", p, vd)}
    p = torch.exp(sc - lse.double().reshape(batch, heads, seq, 1))
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd)
              - delta.double().reshape(batch, heads, seq, 1))
    ref["dq"] = torch.einsum("bhqk,bkhd->bqhd", ds, kd) * head_dim ** -0.5
    ref["dk"] = torch.einsum("bhqk,bqhd->bkhd", ds, qd) * head_dim ** -0.5
    ref["dv"] = torch.einsum("bhqk,bqhd->bkhd", p, dod)
    return {"shape": list(shape), "dtype": str(dtype).removeprefix("torch."), **{
        n: {"kernel": (got[n].double() - r).abs().max().item(),
            "plain": (plain[n].double() - r).abs().max().item(),
            "max_abs": r.abs().max().item()} for n, r in ref.items()}}


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


# The operand patterns of `mma_sync_rate`, each a kernel of one block per
# SM whose warps run `mma.sync` m16n8k8 TF32 on registers and time
# themselves with clock64: "same" one A and one B into 8 independent sums;
# "mma3" the 3xTF32 step of the fp32 dk/dv kernel's first product (two A
# and four B fragments, hi and lo, into 8 sums); "tiles" its second product
# (sums of 12 steps from zero, added to 4 running sums).
_MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
struct F4 { uint32_t hi[4], lo[4]; };
struct F2 { uint32_t hi[2], lo[2]; };
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma3(float c[4], const F4& a, const F2& b) {
  mma(c, a.lo, b.hi); mma(c, a.hi, b.lo); mma(c, a.hi, b.hi);
}
template <int KIND>
__global__ void rate(float* out, long long* cycles, int iters) {
  F4 a0, a1; F2 b[8];
  for (int i = 0; i < 4; ++i) {
    a0.hi[i] = 0x3f800000u + threadIdx.x + i; a0.lo[i] = a0.hi[i] + 3;
    a1.hi[i] = a0.hi[i] + 5; a1.lo[i] = a0.hi[i] + 9;
  }
  for (int n = 0; n < 8; ++n) {
    b[n].hi[0] = 0x3f800000u + 17 * n + threadIdx.x; b[n].hi[1] = b[n].hi[0] + 1;
    b[n].lo[0] = b[n].hi[0] + 2; b[n].lo[1] = b[n].hi[0] + 3;
  }
  float c[8][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (KIND == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mma(c[j], a0.hi, b[0].hi);
    } else if (KIND == 1) {
#pragma unroll
      for (int n = 0; n < 4; ++n) { mma3(c[n], a0, b[2 * n]); mma3(c[4 + n], a1, b[2 * n + 1]); }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float t[4] = {}, u[4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) mma3(t, k & 1 ? a1 : a0, b[4 * j + k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) mma3(u, k & 1 ? a0 : a1, b[(4 * j + k + 1) & 7]);
        for (int e = 0; e < 4; ++e) { c[j][e] += t[e]; c[j + 2][e] += u[e]; }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int mma_rate(int kind, int blocks, int threads, int iters, float* out,
                        long long* cycles) {
  if (kind == 0) rate<0><<<blocks, threads>>>(out, cycles, iters);
  if (kind == 1) rate<1><<<blocks, threads>>>(out, cycles, iters);
  if (kind == 2) rate<2><<<blocks, threads>>>(out, cycles, iters);
  return (int)cudaGetLastError();
}
"""
_MMA_PATTERNS = {"same": (0, 8), "mma3": (1, 24), "tiles": (2, 24)}  # kind, HMMA an iteration
# 8 warps on each SM, as the fp32 dk/dv kernel's consumers; 8192 iterations
# make each run ~1 ms, against which its launch's microseconds do not count.
MMA_RATE_WARPS, MMA_RATE_ITERS = 8, 8192


def mma_sync_rate() -> Dict[str, Any]:
    """`mma.sync` m16n8k8 TF32 instructions (HMMA) issued per cycle per SM
    on the card, for each operand pattern of `_MMA_RATE_SRC`, and the least
    time the 3xTF32 products of the fp32 dk/dv kernel at the flagship
    attention shape would take at each rate (3 HMMA per 16x8x8 product
    step; SM clock from the run's cycles over its CUDA-event time). Built
    with nvcc into the kernels' build directory; raises without a card."""
    import ctypes
    import hashlib
    import subprocess

    from training_operator_tpu_torch.trainer import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("mma_sync_rate measures the card; no CUDA device")
    tag = hashlib.sha256(_MMA_RATE_SRC.encode()).hexdigest()[:16]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = kernels.BUILD_DIR / f"mma_rate-{tag}.so"
    if not lib_path.exists():
        src = lib_path.with_suffix(".cu")
        src.write_text(_MMA_RATE_SRC)
        subprocess.run([kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", str(src), "-o", str(lib_path)],
                       check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib_path)).mma_rate
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps, iters = MMA_RATE_WARPS, MMA_RATE_ITERS
    out = torch.empty(sms * warps * 32, device="cuda")
    cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
    # 3 HMMA per 16x8x8 step (2048 FLOP) of the four products, kept pairs only.
    flops = attention_work(8, 2048, 12, 128, True, torch.float32)["flash_bwd_dkv"]["flops"]
    hmma = 3 * flops / 2048
    result = {"warps_per_sm": warps, "sms": sms}
    for name, (kind, per_iter) in _MMA_PATTERNS.items():
        args = (kind, sms, warps * 32, iters, out.data_ptr(), cycles.data_ptr())
        fn(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(*args)
        end.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"mma_rate kernel failed: CUDA error {err}")
        mean_cycles = cycles.double().mean().item()
        per_cycle = warps * iters * per_iter / mean_cycles
        clock_hz = mean_cycles / (start.elapsed_time(end) / 1e3)
        result[name] = {"hmma_per_cycle_per_sm": per_cycle, "sm_clock_ghz": clock_hz / 1e9,
                        "dkv_fp32_flagship_floor_ms": hmma / (per_cycle * sms * clock_hz) * 1e3}
    return result


# (batch, seq, heads, head_dim, causal) of `attention_sweep`: the flagship
# attention shape with and without the mask, and a long sequence where each
# block's fixed costs weigh least.
SWEEP_SHAPES = ((8, 2048, 12, 128, True), (8, 2048, 12, 128, False),
                (2, 8192, 12, 128, True), (2, 8192, 12, 128, False))


def attention_sweep(shapes=SWEEP_SHAPES, iters: int = 20, device=None) -> list:
    """Each flash kernel's ms and TFLOP/s (over the work `attention_work`
    counts) at each shape, beside SDPA's forward on the same inputs; and the
    backward pair, dq then dk/dv (`flash_bwd_ms`), beside SDPA's whole
    backward (`sdpa_bwd_ms`), which computes the same three gradients."""
    from training_operator_tpu_torch.trainer import flash

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("attention_sweep measures the card; no CUDA device given")
    rows = []
    for b, s, h, d, causal in shapes:
        g = torch.Generator(device=device).manual_seed(0)
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=device,
                                   dtype=torch.bfloat16) for _ in range(4))
        out, lse = flash.flash_fwd(q, k, v, causal)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        o_sdpa = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        do_t = do.transpose(1, 2)
        work = attention_work(b, s, h, d, causal)

        def dq():
            return flash.flash_bwd_dq(q, k, v, do, lse, delta, causal)

        def dkv():
            return flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal)

        times = {
            "flash_fwd": cuda_time_ms(lambda: flash.flash_fwd(q, k, v, causal), iters=iters),
            "sdpa_fwd": cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters=iters),
            "flash_bwd_dq": cuda_time_ms(dq, iters=iters),
            "flash_bwd_dkv": cuda_time_ms(dkv, iters=iters),
        }
        flops = {"flash_fwd": work["flash_fwd"]["flops"], "sdpa_fwd": work["flash_fwd"]["flops"],
                 "flash_bwd_dq": work["flash_bwd_dq"]["flops"],
                 "flash_bwd_dkv": work["flash_bwd_dkv"]["flops"]}
        pair = {
            "flash_bwd_ms": cuda_time_ms(lambda: (dq(), dkv()), iters=iters),
            "sdpa_bwd_ms": cuda_time_ms(lambda: torch.autograd.grad(
                o_sdpa, (qg, kg, vg), do_t, retain_graph=True), iters=iters),
        }
        rows.append({"shape": [b, s, h, d], "causal": causal,
                     **{f"{n}_ms": t for n, t in times.items()},
                     **{f"{n}_tflops": flops[n] / t / 1e9 for n, t in times.items()},
                     **pair})
        del q, k, v, do, out, lse, delta, qt, kt, vt, qg, kg, vg, o_sdpa, do_t
    return rows


def loss_gaps(seeds=(0, 1), batches: int = 3, device=None) -> list:
    """Flagship forward loss through the flash kernels minus the loss
    through the plain attention path, on the same params and batch, for
    `batches` synthetic batches of each seed (params and data from the
    seed). `chip_smoke.py` holds seed 0's first batch to 1e-4; this shows
    how far other batches spread."""
    import dataclasses

    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
    from training_operator_tpu_torch.trainer.model import loss_fn
    from training_operator_tpu_torch.trainer.train import init_train_state, make_optimizer

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("loss_gaps measures the card; no CUDA device given")
    config, batch, seq = flagship_config()
    plain = dataclasses.replace(config, attn_impl="xla")
    gaps = []
    for seed in seeds:
        state = init_train_state(config, make_optimizer(warmup_steps=1, total_steps=100),
                                 generator=torch.Generator(device=device).manual_seed(seed),
                                 device=device)
        data = TokenDataset.synthetic(config.vocab_size, seq, num_rows=batch * batches,
                                      seed=seed)
        for example in DataLoader(data, batch_size=batch, shuffle=True, seed=0,
                                  device=device).epoch(0):
            with torch.no_grad():
                gaps.append(loss_fn(state.model, example, config).item()
                            - loss_fn(state.model, example, plain).item())
        del state
    return gaps


def bench_dataloader(rows: int = 65536, row_len: int = 2049, batch: int = 512,
                     iters: int = 20) -> Dict[str, Any]:
    """Host data-path throughput: shuffled row gather out of an in-memory
    token arena, the native C++ threaded path against the numpy fancy-index
    path (identical output: tests/test_torch_loop.py). GB/s is what
    matters: the gather must outrun the device step to stay hidden. Raises
    when the native library does not build."""
    import numpy as np

    from training_operator_tpu_torch import native

    if not native.available():
        raise RuntimeError(f"native dataio did not build: {native.build_error()}")
    rng = np.random.RandomState(0)
    # dtype= on randint avoids a transient int64 arena (2x peak memory).
    arena = rng.randint(0, 32768, size=(rows, row_len), dtype=np.int32)
    idx = rng.randint(0, rows, size=(iters, batch), dtype=np.int64)
    bytes_per_iter = batch * row_len * 4

    t = time.perf_counter()
    for i in range(iters):
        _ = arena[idx[i]]
    numpy_s = (time.perf_counter() - t) / iters
    buf = np.empty((batch, row_len), dtype=np.int32)
    native.gather_rows(arena, idx[0], out=buf)  # warm the library

    def native_gbps(threads):
        t = time.perf_counter()
        for i in range(iters):
            native.gather_rows(arena, idx[i], out=buf, threads=threads)
        return bytes_per_iter / ((time.perf_counter() - t) / iters) / 1e9

    threads = native.default_threads()
    by_threads = {n: native_gbps(n) for n in sorted({1, 2, 4, threads})}
    return {
        "batch_mb": bytes_per_iter / 1e6,
        "numpy_gather_gbps": bytes_per_iter / numpy_s / 1e9,
        "native_gather_gbps": by_threads[threads],
        "native_speedup": by_threads[threads] * numpy_s * 1e9 / bytes_per_iter,
        "native_threads": threads,
        "native_gather_gbps_by_threads": by_threads,
    }


def bench_trainer_e2e(steps: int = 20, ckpt_every: int = 10, warmup: int = 2,
                      config: Optional[TransformerConfig] = None, batch: int = 0,
                      seq: int = 0, device=None) -> Dict[str, Any]:
    """End-to-end training-loop throughput: `standalone.train_loop` (the
    native-gather loader feeding the train step, an interval save every
    `ckpt_every` steps and the forced final save) over `steps` steps after
    `warmup` steps, the flagship by default. Wall tokens/s is the number a
    job sees; `data_pct` and `ckpt_pct` are the shares of the wall time the
    host spent waiting for the next batch and in saves (each save after a
    fence, so it does not absorb the step before). Checkpoints go to a
    temporary directory, one kept, removed at the end."""
    import itertools
    import shutil
    import tempfile

    from training_operator_tpu_torch.trainer.checkpoint import Checkpointer
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
    from training_operator_tpu_torch.trainer.standalone import train_loop
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(device)
    if config is None:
        config, batch, seq = flagship_config()
    ds = TokenDataset.synthetic(config.vocab_size, seq, num_rows=batch * 8)
    loader = DataLoader(ds, batch_size=batch, shuffle=True, device=device, use_native=True)
    optimizer = make_optimizer(total_steps=steps + warmup + 1)
    state = init_train_state(config, optimizer, device=device)
    step_fn = make_train_step(config, optimizer, device=device)
    for example in itertools.islice(loader.epoch(0), warmup):
        state, _ = step_fn(state, example)
    ckpt_dir = tempfile.mkdtemp(prefix="trainer-e2e-ckpt-")
    try:
        ckpt = Checkpointer(ckpt_dir, max_to_keep=1)
        stats = train_loop(config, optimizer, state, loader, warmup + steps, ckpt,
                           step_fn=step_fn, save_every=ckpt_every, log=lambda _: None)
        save_bytes = ckpt.step_bytes(ckpt.latest_step())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = stats["wall_s"]
    tokens = stats["steps_run"] * batch * seq
    return {
        "device": str(device),
        "steps": stats["steps_run"],
        "batch": batch,
        "seq": seq,
        "ckpt_saves": stats["saves"],
        "native_dataio": bool(loader.use_native),
        "wall_s": wall,
        "tokens_per_s_wall": tokens / wall,
        "data_pct": 100 * stats["data_s"] / wall,
        "ckpt_pct": 100 * stats["ckpt_s"] / wall,
        "ckpt_s_per_save": stats["ckpt_s"] / stats["saves"],
        "ckpt_bytes_per_save": save_bytes,
        "final_loss": float(stats["last_metrics"]["loss"]),
    }


def run_trainer_bench(steps: int = 10, device=None) -> Dict[str, Any]:
    """The flagship train step, the kernels at its
    attention shape and at the long-context point [2, 8192, 12, 128]
    (`attention_8k`), the data path and the end-to-end loop on the card.
    Unlike the JAX version, a failure raises instead of turning into an
    error entry."""
    config, batch, seq = flagship_config()
    return {
        "train_step": bench_train_step(config, batch, seq, steps=steps, device=device),
        "attention": bench_attention(batch, seq, config.n_heads, config.head_dim,
                                     device=device),
        "dataloader": bench_dataloader(),
        "trainer_e2e": bench_trainer_e2e(steps=2 * steps, ckpt_every=steps, device=device),
        "attention_8k": bench_attention(2, 8192, config.n_heads, config.head_dim, iters=10,
                                        device=device),
    }


def main(argv=None) -> None:
    """`python -m training_operator_tpu_torch.trainer.bench`: the flagship
    train step, its profile and the three kernels at the flagship attention
    shape, on the card; one JSON object on stdout. With `--attention`, only
    the kernels: `bench_attention` at the flagship shape and
    `attention_sweep`; with `--loss-gap`, only `loss_gaps`; with `--loop`,
    `run_trainer_bench` (step, kernels, data path, end-to-end loop); with
    `--mesh`, the profile of the unsharded step and of the step sharded on
    a world of one NCCL rank (fsdp=1,tensor=1), in that order; with
    `--ring`, `profile_ring` at chip_smoke.py phase 8's three cases; with
    `--moe` and `--pipeline`, `profile_train_step` on chip_smoke.py phase 9's
    and phase 10's configurations (`moe_config`, `pipeline_config`), beside
    the step's MFU on active parameters (FLOPS_RULE); with `--d256`,
    `bench_train_step` on phase 13's Gemma-2B-width
    configuration (`gemma2b_config`), its profile (`profile_train_step`) and
    `bench_attention` at its attention shape [1, 4096, 8, 256]; with
    `--fp32`, the same three on phase 14's full-precision flagship
    (`flagship_fp32_config`), the kernels in fp32, and `float64_errors`
    at the flagship attention shape and at [1, 4096, 8, 256]; with
    `--mma-rate`, only `mma_sync_rate`."""
    import argparse
    import json
    import subprocess

    parser = argparse.ArgumentParser(prog="python -m training_operator_tpu_torch.trainer.bench")
    parser.add_argument("--attention", action="store_true",
                        help="time the flash kernels only (bench_attention, attention_sweep)")
    parser.add_argument("--loss-gap", action="store_true",
                        help="flash vs plain-attention forward loss over six batches only")
    parser.add_argument("--loop", action="store_true",
                        help="run_trainer_bench: step, kernels, data path and the loop")
    parser.add_argument("--mesh", action="store_true",
                        help="profile the step unsharded and sharded on a world of one")
    parser.add_argument("--ring", action="store_true",
                        help="profile the loopback ring beside the unsplit flash kernels")
    parser.add_argument("--moe", action="store_true",
                        help="profile the step of the 8-expert switch MoE flagship")
    parser.add_argument("--pipeline", action="store_true",
                        help="profile the flagship step as 2 loopback pipeline stages")
    parser.add_argument("--d256", action="store_true",
                        help="the Gemma-2B-width step (head_dim 256) and its kernels")
    parser.add_argument("--fp32", action="store_true",
                        help="the flagship step in fp32 and the fp32 kernels")
    parser.add_argument("--mma-rate", action="store_true",
                        help="mma.sync TF32 instructions per cycle per SM (mma_sync_rate)")
    args = parser.parse_args(argv)
    config, batch, seq = flagship_config()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if args.mma_rate:
        out = {"card": card, "mma_sync_rate": mma_sync_rate()}
    elif args.d256 or args.fp32:
        config, batch, seq = gemma2b_config() if args.d256 else flagship_fp32_config()
        out = {"card": card,
               "train_step": bench_train_step(config, batch, seq, steps=5, warmup=1),
               "profile": profile_train_step(config, batch, seq),
               "attention": bench_attention(batch, seq, config.n_heads, config.head_dim,
                                            dtype=config.dtype)}
        if args.fp32:
            out["float64_errors"] = [float64_errors(*shape) for shape in
                                     ((batch, seq, config.n_heads, config.head_dim),
                                      (1, 4096, 8, 256))]
    elif args.moe or args.pipeline:
        stages = 0
        if args.moe:
            config, batch, seq = moe_config()
        else:
            config, batch, seq, stages = pipeline_config()
        prof = profile_train_step(config, batch, seq, stages=stages)
        out = {"card": card, "moe" if args.moe else "pipeline": prof,
               "mfu": active_mfu(config, batch, seq, prof["step_ms"]), "flops_rule": FLOPS_RULE}
    elif args.loss_gap:
        out = {"card": card, "loss_gaps": loss_gaps()}
    elif args.ring:
        out = {"card": card, "ring": [profile_ring(shape, ns) for shape, ns in RING_CASES]}
    elif args.mesh:
        out = {"card": card, **profile_mesh_step(config, batch, seq)}
    elif args.loop:
        out = {"card": card, **run_trainer_bench()}
    elif args.attention:
        out = {
            "card": card,
            "attention": bench_attention(batch, seq, config.n_heads, config.head_dim, iters=20),
            "sweep": attention_sweep(),
        }
    else:
        out = {
            "card": card,
            "train_step": bench_train_step(config, batch, seq, steps=5, warmup=1),
            "profile": profile_train_step(config, batch, seq),
            "attention": bench_attention(batch, seq, config.n_heads, config.head_dim),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
