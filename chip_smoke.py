#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device   the card must be there; prints nvidia-smi's name and power limit.
2. build    builds the flash-attention kernels from trainer/csrc with nvcc.
3. kernels  holds each kernel against its plain PyTorch version on the card
            at the flagship attention shape [8, 2048, 12, 128] bf16 causal
            and at [2, 1000, 4, 64] bf16, causal and not; times each at the
            flagship shape beside its plain version, SDPA and its bound.
4. train    the flagship decoder (554M params, batch 8 x seq 2048, bf16,
            full remat of every layer and of the head) through
            init_train_state / make_train_step, fed by the DataLoader over a
            synthetic TokenDataset: 1 warm-up step and 5 timed steps. The
            launch counts are reset just before this phase and read after
            every step: 24 forward (12 layers + their remat recompute), 12 dq
            and 12 dk/dv launches per step. The first loss and the first
            gradients of wq, wk and wv are checked against the same
            parameters through the plain attention path.

The last lines are the `kernels` JSON line, the card's name and power limit,
and `{"ok": true, "device": {...}}`.

Tolerances, bf16 kernel against the plain version in fp32 on the same bf16
inputs:
- out: |kernel - plain| <= 1e-2 + 1e-2*|plain| elementwise. The kernel
  rounds the probabilities to bf16 before p v and rounds out to bf16
  (2^-9 relative each); 1e-2 leaves room for both.
- lse: |kernel - plain| <= 1e-3. lse never passes through bf16: products of
  bf16 inputs are exact in fp32 and only summation order and the fast exp
  differ.
- dq, dk, dv: elementwise, |kernel - plain| <= GRAD_TOL * (rms of the
  plain row + |plain| + 1e-2 * rms of the whole plain tensor), a row being
  one (batch, position, head) vector of head_dim entries. The kernels round
  p and ds to bf16 before the tensor-core products (2^-9 relative each,
  random in sign, so a row's error stays near 2^-9 of the row's size) and
  round the result to bf16 (2^-9 relative). Gradient rows shrink along a
  causal product (about 1/sqrt(position)), so each entry is held to its
  own row's size: a tile that is wrong by a few percent fails wherever it
  lies, late keys and rows included. The row-rms term covers entries near
  zero in a row; the tiny global term covers rows that are zero by
  cancellation (the first query of a causal product attends to itself
  only, so its dq is summation noise).
- train: the step-0 loss through the flash kernels within 1e-4 of the same
  parameters through the plain attention path, and the step-0 gradients of
  wq, wk and wv (which reach the loss through dq, dk and dv) within
  GRAD_REL_TOL in relative Frobenius norm per layer.
"""

import dataclasses
import json
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def check_kernels(flash, shape, causal, seed):
    """Runs the three kernels once on random bf16 inputs of `shape` and
    returns their max errors against the plain versions; raises beyond the
    tolerances in the module docstring."""
    import torch

    b, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    out, lse = flash.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    ref_out, ref_lse = flash.flash_fwd_plain(qf, kf, vf, causal)
    out_err = (out.float() - ref_out).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    if not bool((out_err <= 1e-2 + 1e-2 * ref_out.abs()).all()):
        raise AssertionError(f"flash_fwd out disagrees at {shape} causal={causal}: "
                             f"max abs err {out_err.max().item()}")
    if lse_err > 1e-3:
        raise AssertionError(f"flash_fwd lse disagrees at {shape}: {lse_err}")
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    ref_dq = flash.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal)
    ref_dk, ref_dv = flash.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal)
    errs = {"out": out_err.max().item(), "lse": lse_err}
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        diff = (got.float() - ref).abs()
        # The elementwise tolerance as one number: <= GRAD_TOL passes.
        row_rms = ref.square().mean(-1, keepdim=True).sqrt()
        floor = 1e-2 * ref.square().mean().sqrt()
        worst = (diff / (row_rms + ref.abs() + floor)).max().item()
        if not worst <= GRAD_TOL:
            raise AssertionError(f"{name} disagrees at {shape} causal={causal}: "
                                 f"max |err| / (row rms + |plain|) = {worst}")
        errs[name] = diff.max().item()
        errs[name + "_scaled"] = worst
    del q, k, v, do, out, lse, ref_out, ref_lse, dq, dk, dv, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()
    return errs


# dq, dk, dv against their plain versions; see the module docstring. On an
# H100 the worst reading is 0.0093 at the flagship shape and 0.0081 at
# [2, 1000, 4, 64]: the largest of ~25M entries of 2^-9-sized noise.
GRAD_TOL = 2e-2

# Step-0 gradients of wq, wk, wv, flash path against plain attention path,
# relative Frobenius norm per layer. Both paths round to bf16, at different
# places: the plain one its scores before the softmax and its probabilities,
# the kernels p and ds; the layers pass the differences on. On an
# H100 the worst layer reads 0.023 (wq, wk) and 0.016 (wv); the limit is
# about twice that.
GRAD_REL_TOL = 5e-2


def attention_grads(model, batch, config):
    """Loss and the gradients of the stacked wq, wk, wv of one forward and
    backward of `model` on `batch` under `config`."""
    from training_operator_tpu_torch.trainer.model import loss_fn

    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model, batch, config)
    loss.backward()
    params = dict(model.named_parameters())
    grads = {n: params["layers." + n].grad.clone() for n in ("wq", "wk", "wv")}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from training_operator_tpu_torch.trainer import bench, flash, kernels
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| count {torch.cuda.device_count()}")

    # 2. build
    k = kernels.load()
    log(f"build: {k.build_seconds:.1f} s for {len(kernels.SOURCES)} sources")
    for line in k.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  ptxas " + line.strip())

    # 3. kernels
    flagship = (8, 2048, 12, 128)
    cases = [(flagship, True), ((2, 1000, 4, 64), True), ((2, 1000, 4, 64), False)]
    errors = {}
    for i, (shape, causal) in enumerate(cases):
        errs = check_kernels(flash, shape, causal, seed=i)
        errors[(shape, causal)] = errs
        log(f"kernels: {list(shape)} causal={causal} " + json.dumps(errs))
    timing = bench.bench_attention(*flagship, causal=True, iters=10)
    for name, row in timing.items():
        log(f"timing: {name} " + json.dumps(row))

    # 4. train
    config, batch, seq = bench.flagship_config()
    optimizer = make_optimizer(warmup_steps=1, total_steps=100)
    state = init_train_state(config, optimizer)
    step_fn = make_train_step(config, optimizer)
    total, n_matmul = bench._count_params(state.model)
    dataset = TokenDataset.synthetic(config.vocab_size, seq, num_rows=batch * 4, seed=0)
    loader = DataLoader(dataset, batch_size=batch, shuffle=True, seed=0)

    def batches():
        epoch = 0
        while True:
            yield from loader.epoch(epoch)
            epoch += 1

    it = batches()
    first = next(it)
    xla_loss, xla_grads = attention_grads(state.model, first,
                                          dataclasses.replace(config, attn_impl="xla"))
    flash_loss, flash_grads = attention_grads(state.model, first, config)
    grad_errs = {
        n: max(((flash_grads[n][i] - xla_grads[n][i]).norm()
                / xla_grads[n][i].norm()).item() for i in range(config.n_layers))
        for n in xla_grads
    }
    del xla_grads, flash_grads
    torch.cuda.empty_cache()
    log(f"train: {total / 1e6:.1f}M params ({n_matmul / 1e6:.1f}M in products), "
        f"batch {batch} x seq {seq}, {config.dtype}, remat full + head; "
        f"step-0 loss plain attention {xla_loss:.6f} flash {flash_loss:.6f}; "
        f"gradient rel err flash vs plain, worst layer: " + json.dumps(grad_errs))
    if not max(grad_errs.values()) <= GRAD_REL_TOL:
        raise AssertionError(f"step-0 attention gradients, flash vs plain: {grad_errs} "
                             f"beyond {GRAD_REL_TOL}")

    per_step = {"flash_fwd": 2 * config.n_layers, "flash_bwd_dq": config.n_layers,
                "flash_bwd_dkv": config.n_layers}
    flash.reset_launches()
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    data = first
    for i in range(6):
        before = dict(flash.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step_fn(state, data)
        end.record()
        loss = metrics["loss"].item()  # waits for the step
        wall = time.perf_counter() - t0
        ms = start.elapsed_time(end)
        grew = {n: flash.launches[n] - before[n] for n in per_step}
        if grew != per_step:
            raise AssertionError(f"step {i}: launches grew by {grew}, expected {per_step}")
        if not torch.isfinite(metrics["loss"]) or not torch.isfinite(metrics["grad_norm"]):
            raise AssertionError(f"step {i}: non-finite loss or grad norm: {metrics}")
        losses.append(loss)
        if i > 0:
            times.append(ms)
        log(f"train: step {i} loss {loss:.6f} grad_norm {metrics['grad_norm'].item():.6f} "
            f"{ms:.2f} ms device {wall * 1e3:.2f} ms host"
            + (" (warm-up)" if i == 0 else ""))
        data = next(it)
    # bf16 flash vs plain attention through 12 residual layers: the two
    # paths differ by bf16 rounding of p and of the attention output; the
    # measured gap is under 1e-5 at a loss near ln(32768) = 10.4.
    if abs(losses[0] - xla_loss) > 1e-4:
        raise AssertionError(f"step-0 loss {losses[0]} vs plain-attention loss {xla_loss}")
    step_ms = sum(times) / len(times)
    tokens_s = batch * seq / (step_ms / 1e3)
    fps = bench.flops_per_step(config, n_matmul, batch, seq)
    mfu = fps / (step_ms / 1e3) / bench.PEAK_BF16_FLOPS["H100"]
    log(f"train: {step_ms:.2f} ms/step (mean of {len(times)}), {tokens_s:.1f} tokens/s, "
        f"MFU {mfu:.4f} of 989 TFLOP/s bf16, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {dict(flash.launches)} "
        f"on {card}")

    # 5. report
    sources = {"flash_fwd": "flash_fwd.cu", "flash_bwd_dq": "flash_bwd_dq.cu",
               "flash_bwd_dkv": "flash_bwd_dkv.cu"}
    replaces = {
        "flash_fwd": "training_operator_tpu/trainer/flash.py:89",
        "flash_bwd_dq": "training_operator_tpu/trainer/flash.py:177",
        "flash_bwd_dkv": "training_operator_tpu/trainer/flash.py:217",
    }
    flag_errs = errors[(flagship, True)]
    err_of = {"flash_fwd": flag_errs["out"], "flash_bwd_dq": flag_errs["dq"],
              "flash_bwd_dkv": max(flag_errs["dk"], flag_errs["dv"])}
    rows = []
    for name in per_step:
        t = timing[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"training_operator_tpu_torch/trainer/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": flash.launches[name],
            "max_abs_err": err_of[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
