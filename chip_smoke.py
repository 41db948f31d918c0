#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device   the card must be there; prints nvidia-smi's name and power limit.
2. build    builds the port's kernels from trainer/csrc with nvcc,
            one process per source, all at once, and prints the seconds;
            prints ptxas's report (each kernel instantiation, its registers
            and spills) and warnings and, per library, the instructions its
            design must show in its SASS (cuobjdump): HGMMA (wgmma) and
            UTMALDG (TMA load) for the "wgmma+tma" sources, which hold the
            bf16 and the fp16 instantiations, and HMMA on TF32 (mma.sync)
            with SYNCS (the mbarrier ring) for the fp32 sources, the
            forward's "mma.sync-3xtf32-stream" and dq's and dk/dv's
            "mma.sync-3xtf32-ring", and HGMMA and UTMALDG for the head's
            "wgmma-3xtf32+tma", and 128-bit global loads and stores
            (LDG.128, STG.128) for clip + AdamW's "multi-tensor-stream"
            and the expert layer's permutation's "warp-row-permute"
            (kernels.DESIGN_SASS, kernels.required_sass); and the
            same per kernel instantiation, with the count of each type's. Any
            instantiation without its design's instructions, or any spill,
            fails the run.
3. kernels  holds each kernel against its plain PyTorch version on the card:
            in bf16 at the flagship attention shape [8, 2048, 12, 128]
            causal, at [2, 1000, 4, 64], causal and not, at phase 13's
            attention shape [1, 4096, 8, 256] causal, at [2, 1000, 4, 256]
            not causal, and at [4097, 32, 16, 64] causal, whose 65552
            (batch, head)s are more than a grid's y dimension holds; in
            fp16 and in fp32 at [8, 2048, 12, 128] causal, [2, 1000, 4, 64]
            causal and not and [1, 4096, 8, 256] causal; in fp32 also at
            [2, 1000, 4, 256] not causal, where dk/dv's 32-key and 16-row
            tiles end raggedly and no D split remains. Times each kernel
            in each type at the flagship shape and at [1, 4096, 8, 256]
            beside its plain version, SDPA in the same type and its bound
            (bench.FLOP_RULES: fp32's at 3xTF32's 165 TFLOP/s), and the
            backward pair (dq then dk/dv) beside SDPA's whole backward.
4. train    the flagship decoder (554M params, batch 8 x seq 2048, bf16,
            remat "save_attn_qkv" on every layer and remat of the head)
            through init_train_state / make_train_step, fed by the
            DataLoader over a synthetic TokenDataset: 1 warm-up step and 5
            timed steps. The launch counts are reset just before this phase
            and read after every step: 12 forward, 12 dq and 12 dk/dv
            launches per step (the layers keep their attention residuals,
            so backward launches no forward). The first loss and the first
            gradients of wq, wk and wv are checked against the same
            parameters through the plain attention path. Then one step
            under remat "full", which must launch 24 / 12 / 12 (the forward
            again in each layer's recompute).
5. loop     the trainer loop (standalone.train_loop) at the flagship's full
            size: the DataLoader on the native gather (required: a failed
            build fails the phase), 12 steps, a DCP save every 6 steps into
            a temporary directory with max_to_keep=1, and the forced final
            save on step 12, which overwrites the interval save crash-safely.
            The state restored into a fresh zero-filled template must equal
            the live state bit for bit (every tensor, the AdamW count, the
            step); one more step from each on the same batch must give
            losses within 1e-6. MODEL_EXPORT_URI=file://<tmp> must export
            exactly the final step's files. The port's graft entry
            (graft_entry.entry()) must give a finite loss equal to loss_fn on
            the same arguments. Prints the scratch disk's free space first,
            and seconds and bytes per save, wall tokens/s, data_pct and
            ckpt_pct; the temporary directories are removed at the end.
6. mesh     the sharded trainer as a world of one NCCL rank, bootstrapped
            from the operator's env (COORDINATOR_ADDRESS=127.0.0.1, a free
            COORDINATOR_PORT, NUM_PROCESSES=1, PROCESS_ID=0,
            TPU_MESH_AXES=fsdp=1,tensor=1) through distributed.initialize,
            mesh_from_env and init_train_state(..., mesh) (the shards built
            directly): the
            flagship at full width as in phase 4, 1 warm-up step and 5 timed
            steps, 12/12/12 launches per step. The unsharded make_train_step
            runs the same parameters and batches first: the sharded step-0
            loss within 1e-5 relative, and after two steps every parameter
            and every AdamW mu within 1e-5 relative in Frobenius norm (the
            optimizer has warmup_steps=1; step 1 runs at lr 0, so only step 2
            moves the parameters). Prints ms/step, tokens/s and peak memory
            beside phase 4's. Then the trainer entry as a subprocess under
            the same env (a new port) for 4 steps with a save, relaunched for
            6: it must resume at step 4. Ends with distributed.shutdown().
7. dryrun   graft_entry.dryrun_multichip(8) on the host CPU: 8 gloo
            processes, each pass's sharded loss within 5e-3 of the
            single-process loss (pass 1 on tensor=2,sequence=2,fsdp=2: the
            ring over gloo; pass 2 on pipeline=2,expert=2,tensor=2 with 2
            experts and 2 microbatches: the GPipe schedule and the MoE
            all-to-all over gloo; pass 3 multi-slice data=2,fsdp=2,tensor=2);
            a CPU phase, its seconds are host seconds.
8. ring     the ring attention's per-rank body (attention.ring_forward and
            ring_backward) through the loopback transport: the NS ranks of
            the ring run one after another on the card, each taking its K/V
            blocks from a list and adding its dk/dv into the owner's slot.
            Forward and backward at the flagship attention shape
            [8, 2048, 12, 128] bf16 causal with NS = 2 and 4, and at the
            long-context point [2, 8192, 12, 128] with NS = 4. Out, the
            merged lse, dq, dk and dv are held to the plain version on the
            unsplit sequence (fp32, one batch row at a time) under phase 3's
            elementwise rules; as there, the plain backward takes the ring's
            own lse and delta (from the ring's out). The launch counts are
            reset before each call: NS(NS+1)/2 forward, dq and dk/dv
            launches, NS of each causal (the diagonal blocks). Each case is
            timed in CUDA events beside the unsplit flash forward + backward
            at the same shape.
9. moe      the flagship at full width with a switch MoE of 8 experts at
            capacity factor 1.25 in every layer (bench.moe_config, 2.93B
            parameters), unsharded, batch 8 x seq 2048, bf16, remat
            "save_attn_qkv" + the head: 1 warm-up step and 5 timed steps,
            12/12/12 launches per step (counts reset just before). The
            step-0 loss within 1e-4 of the same parameters and batch through
            the plain attention path (phase 4's gate); every loss finite;
            before step 0 every expert of every layer receives tokens
            (bench.moe_routing). The plain path runs with each layer's
            routing pinned to the flash path's (`routing_gap`): top-1
            routing sends a near-tied token to another expert on a
            last-bit difference of the hidden state, which moves the loss
            by more than the attention paths' own gap (2.3e-4 unpinned on
            an H100 80GB HBM3 at 700 W); the unpinned loss and the count of
            tokens routed elsewhere are printed. Prints ms/step, tokens/s,
            MFU on active parameters (bench.FLOPS_RULE), peak memory (reset
            after phase 8), the dropped-token share and the per-expert
            token shares.
10. pipeline the dense flagship as 2 GPipe stages with 4 microbatches of
            2 x 2048 through the loopback transport (pipeline.loopback: the
            stages run one after another on the card): the step-0 loss
            within 1e-4 relative of the unpipelined loss on the same
            parameters and batch, and every parameter's gradient within
            GRAD_REL_TOL in relative Frobenius norm (phase 4's gates;
            microbatching changes the products' row counts and so their
            bf16 rounding); then 1 warm-up step and 5 timed steps, 48/48/48
            launches per step (12 layers x 4 microbatches). Prints ms/step
            beside phase 4's: on one card this is the cost of the schedule
            and of the smaller launches, not a bubble or a hand-off (NCCL
            cannot put two ranks on one card).

11. vision   the vision family's entry point run (vision.train_synthetic,
            the counterpart of examples/vision_mnist.py): the default
            VisionConfig (28x28x1, convs of 32 and 64 channels, dense 128,
            bf16), batch 256, 60 SGD-momentum steps on one synthetic batch.
            Every loss finite and the final accuracy above 0.9. Prints the
            loss and accuracy at steps 0, 10, ... 50 and 59, ms/step (CUDA
            events, the mean of steps 1-59, after step 0 as warm-up),
            images/s and peak memory. Then the bf16 forward of the trained
            parameters on the training batch against the same forward in
            fp32: max |bf16 - fp32| <= VISION_BF16_TOL x max |fp32| and
            the same argmax on every image.
12. solver   the placement solver on the card (scheduler/packer.py): the
            10k-node block of the solver bench (packer.scale_instance: 2500
            slices of 4 hosts, 2000 gangs of 1, 2 or 4 hosts, 3 classes,
            10000 candidates) through TorchSolver, after prewarm. The
            placements must equal the host numpy arm's
            (packer.solve_batch_numpy) bit for bit, cold (the candidates
            uploaded in the solve) and warm (resident). Prints the rounds,
            the median ms of 5 cold and of 5 warm solves (host clock around
            the whole solve, the result on the host), and the numpy arm's
            median ms of 5 on the same machine's CPU, labelled host time.
13. d256     a decoder at Gemma-2B's widths (bench.gemma2b_config: vocab
            256000, d_model 2048, 18 layers, 8 heads of 256 over one kv
            head, d_ff 16384, 3.03B parameters), unsharded, batch 1 x seq
            4096, bf16, remat "save_attn_qkv" + the head: the head_dim 256
            kernels under a model. The step-0 loss within D256_LOSS_TOL of
            the same parameters and batch through the plain attention path,
            and the step-0 gradients of wq, wk and wv within GRAD_REL_TOL
            per layer (phase 4's gates, the loss's scaled to the batch; see
            D256_LOSS_TOL); then 1 warm-up step and 5 timed steps, 18/18/18
            launches per step (counts reset just before), every loss finite.
            Prints ms/step, tokens/s, MFU (bench.FLOPS_RULE), peak memory
            (reset after phase 12) and the card.
14. fp32     the flagship in full precision (bench.flagship_fp32_config:
            phase 4's model, batch and policy with dtype float32, 554M
            params, nothing cut): the fp32 kernels under a model. The
            step-0 loss within FP32_LOSS_TOL and the step-0 gradients of
            wq, wk and wv within FP32_GRAD_REL_TOL per layer of the same
            parameters and batch through the plain attention path; then 1
            warm-up step and 3 timed steps, 12/12/12 launches per step
            (counts reset just before), all of them the fp32 kernels' and
            none bf16 or fp16 (flash.launches_dtype), every loss finite.
            Prints ms/step, tokens/s, MFU against the bf16 peak as every
            phase (so labelled), peak memory (reset after phase 13) and the
            card.
15. placer   the placement engine's scheduling cycle on the card
            (scheduler/packer.py TPUPacker, the "torch" arm, on the card
            unless told otherwise) against its "numpy" arm on the host, each
            with its own requests and its own snapshot of the same usage:
            (a) the solver bench's 10k-node block (burst.scale_requests:
            2500 slices of 4x4, 2000 gangs of 1, 2 or 4 hosts drawn by
            random.Random(7), created 1 ms apart, placed at t=10000 s): one
            cold place() and one warm place() on a fresh snapshot of the same
            inventory; prints the snapshot build s, the card's place() ms,
            rounds and solve ms, and the numpy arm's host ms. (b) bench.py's
            burst pool (burst.burst_pool: 48 slices of 4x4, 32 GPU nodes of
            8 in NVLink domains of 4, 16 CPU nodes of 64 cores) and
            build_workload(1000, seed=0), replayed by burst.replay until all
            are admitted or 400 cycles; prints the cycles, the gangs
            admitted, place() ms per cycle (median, p90, max, first) on the
            card and on the host, the rounds and the solve's share of
            place(). Any placement that differs from the numpy arm's, field
            by field (assignments, slices_used, reserved_nodes, score), in
            any cycle fails the run. The placer runs no kernel of its own:
            `solve_batch` is torch ops, as JAX's `_solve_batch` is XLA, so
            the `kernels` line does not change.
16. operator bench.py's burst through the port's own operator
            (burst.run_burst: the burst pool, build_workload(1000, seed=0)
            made into JAXJobs, PyTorchJobs and TFJobs by burst.make_job,
            DefaultScheduler, SimKubelet, OperatorManager with the three
            controllers, GangScheduler with prewarm, min_solve_interval 0.25
            s and incremental solving), once with TPUPacker() solving on the
            card and once with its numpy arm. (a) With charge_solve_time
            off: every job must succeed, and the card arm's records must
            equal the numpy arm's (each PodGroup's placement, reserved
            nodes, score and virtual admission time, each job's Running and
            Succeeded times, the cycles and each cycle's trace record);
            prints per arm the cycles, the makespan and the p50 and p90 of
            schedule-to-running (virtual seconds), the solve cycle's wall
            ms from the scheduler's trace (median, p90, max, first), the solve's
            share of it and the wall seconds. (b) With charge_solve_time
            on, as bench.run_burst runs: each solve's wall time moves the
            virtual clock, so the arms are not compared; prints bench's
            keys per arm. No kernel of the `kernels` line runs here.
17. head     the head's fp32 products (trainer/head_gemm.py: logits, dX
            and dW on csrc/head_gemm_fp32.cu's 3xTF32 wgmma kernel) at the
            benchmark cells' head shapes (bench.HEAD_SHAPES): each one's ms
            beside its bound (2 T D V at 165 TFLOP/s) and torch.matmul's
            fp32 SGEMM (`library_ms`), and its max error against float64 on
            256 sampled rows or columns beside SGEMM's and TF32's
            (torch.matmul with allow_tf32, set here for the comparison
            alone). Fails where the kernel's error passes 4x SGEMM's or
            1/100 of TF32's. Phase 4 holds each step to 2 logits, 1 dX and
            1 dW launches (remat_head), phase 14 the same.
18. adamw    the fused clip + AdamW (trainer/adamw.py on
            csrc/adamw_fp32.cu: the norm's two passes and the update) over
            the parameters of each configuration in BENCHMARK.json, in fp32
            (bench.bench_adamw): first one fused step against the loop of
            torch ops (adamw.plain_update) from the same first values, a
            parameter's tensors at a time; fails where p, mu, nu or the norm
            differs by more than ADAMW_TOL of the largest magnitude (the
            `errors` of the row). Then the step's ms and the norm's, means
            of 10 calls by CUDA events, beside the bound (32 bytes a
            parameter at 3.35 TB/s), the loop's ms and torch's own
            multi-tensor kernels' (`library_ms`: _foreach_norm and
            _fused_adamw_). Phase 4 holds each step to one launch of each
            pass; tests/test_torch_cuda.py holds the kernels to the loop at
            small sizes.
19. permute  the dropless expert layer's token permutation (trainer/
            permute.py on csrc/moe_permute.cu: the scatter and the gather-sum,
            each with and without the gate) at OLMoE's shape
            (bench.PERMUTE_SHAPE: 16,384 tokens of 2048, top-8 of 64) on the
            layer's own routing (bench.bench_permute): the dispatch and y's
            gradient bit for bit against the torch ops (padding rows zero),
            the combine and the dispatch's backward within one bf16 ulp, the
            gate's gradient at least as close to float64 as the torch ops';
            fails otherwise. Then each use's ms, a mean of 10 calls by CUDA
            events, beside the torch ops' (`plain_ms`) and its byte bound
            (bench.permute_bytes at 3.35 TB/s), and ms / bound. ~20 s.

The last lines are the `kernels` JSON line, the card's name and power
limit, and `{"ok": true, "device": {...}}`. The `kernels` line has a row per
wgmma kernel (bf16 launches in phases 4, 6, 8, 9, 10 and 13; time, bound,
plain and SDPA times and error at the flagship shape and, in the `_d256`
keys, at [1, 4096, 8, 256]; the same for the fp16 instantiation in the
`_fp16` and `_fp16_d256` keys), a row per fp32 kernel (`<name>_fp32`: phase 14's launches
and the same fields in fp32) and a row per head product (`head_<product>`:
phase 4's launches, phase 17's times, bounds, SGEMM's ms and float64
errors per cell shape), a row for clip + AdamW (`adamw`: phase 4's
launches, phase 18's times and bounds per configuration) and a row for the
expert layer's permutation (`moe_permute`: phase 19's uses).

Tolerances, bf16 kernel against the plain version in fp32 on the same bf16
inputs:
- out: |kernel - plain| <= 1e-2 + 1e-2*|plain| elementwise. The kernel
  rounds the probabilities to bf16 before p v and rounds out to bf16
  (2^-9 relative each); 1e-2 leaves room for both.
- lse: |kernel - plain| <= 1e-3. lse never passes through bf16: products of
  bf16 inputs are exact in fp32 and only summation order and the fast exp
  differ.
- fp16: the bf16 rules (fp16 rounds at 2^-11, inside them).
- fp32: out and lse within FP32_OUT_TOL, dq, dk, dv within FP32_GRAD_TOL,
  max abs error; see those constants.
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
  GRAD_REL_TOL in relative Frobenius norm per layer. Phase 13 the same,
  with the loss within D256_LOSS_TOL.
- loop: the restore bit for bit; the step after it within 1e-6 of the live
  state's (the same parameters, batch and kernels: any difference would be
  the card's summation order, which the kernels fix); the graft entry's
  loss within 1e-6 of loss_fn on the same arguments.
- ring: phase 3's rules for out, lse, dq, dk, dv. The ring rounds each
  block's out, dq, dk and dv to bf16 before the fp32 merge or sum, so its
  errors sit above one kernel's: on an H100 the scaled gradient errors
  read 0.013-0.015 against GRAD_TOL's 0.02.
- vision: the bf16 logits within VISION_BF16_TOL of the largest fp32
  logit, the same argmax. bf16 rounds the conv and dense inputs, weights
  and outputs (2^-9 relative each); on an H100 the gap reads 3.1e-3 of
  the largest logit after the 60 steps (3.3e-3 on the CPU, 5.0e-3 at the
  init).
- solver, placer, operator: equal, bit for bit: the rounds are integer arithmetic,
  the placer's ordering and stitching the same Python on both arms.
- mesh: 1e-5 relative. A world of one runs the unsharded path's products
  and kernels on the same values; only the vocab-parallel logsumexp (max,
  exp, sum and log written out) and the copies of the size-1 collectives
  differ from it, all in fp32.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def check_kernels(flash, shape, causal, seed, dtype=None):
    """Runs the three kernels once on random inputs of `shape` and `dtype`
    (bf16 by default) and returns their max errors against the plain
    versions; raises beyond the tolerances in the module docstring (fp32's
    FP32_OUT_TOL and FP32_GRAD_TOL, the 2-byte types' elementwise rules)."""
    import torch

    dtype = dtype or torch.bfloat16
    b, s, h, d = shape
    where = f"at {shape} {dtype} causal={causal}"
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda", dtype=dtype)
                   for _ in range(4))
    out, lse = flash.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    ref_out, ref_lse = flash.flash_fwd_plain(qf, kf, vf, causal)
    out_err = (out.float() - ref_out).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    fp32 = dtype == torch.float32
    out_ok = (out_err.max().item() <= FP32_OUT_TOL if fp32
              else bool((out_err <= 1e-2 + 1e-2 * ref_out.abs()).all()))
    if not out_ok:
        raise AssertionError(f"flash_fwd out disagrees {where}: max abs err "
                             f"{out_err.max().item()}")
    if not lse_err <= (FP32_OUT_TOL if fp32 else 1e-3):
        raise AssertionError(f"flash_fwd lse disagrees {where}: {lse_err}")
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, s)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    ref_dq = flash.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal)
    ref_dk, ref_dv = flash.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal)
    errs = {"out": out_err.max().item(), "lse": lse_err}
    for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        if fp32:
            err = (got - ref).abs().max().item()
            if not err <= FP32_GRAD_TOL:
                raise AssertionError(f"{name} disagrees {where}: max abs err {err}")
            errs[name] = err
        else:
            errs.update(grad_errors(name, got, ref, where))
    del q, k, v, do, out, lse, ref_out, ref_lse, dq, dk, dv, ref_dq, ref_dk, ref_dv
    torch.cuda.empty_cache()
    return errs


def grad_errors(name, got, ref, where) -> dict:
    """{name: max |got - ref|, name_scaled: the elementwise rule of the
    module docstring as one number}; raises above GRAD_TOL."""
    diff = (got.float() - ref).abs()
    row_rms = ref.square().mean(-1, keepdim=True).sqrt()
    floor = 1e-2 * ref.square().mean().sqrt()
    worst = (diff / (row_rms + ref.abs() + floor)).max().item()
    if not worst <= GRAD_TOL:
        raise AssertionError(f"{name} disagrees {where}: max |err| / (row rms + |plain|) "
                             f"= {worst}")
    return {name: diff.max().item(), name + "_scaled": worst}


# dq, dk, dv against their plain versions; see the module docstring. On an
# H100 the worst reading is 0.0093 at the flagship shape and 0.0081 at
# [2, 1000, 4, 64]: the largest of ~25M entries of 2^-9-sized noise.
GRAD_TOL = 2e-2

# fp32 kernels against their plain versions, max abs error: out and lse
# within the JAX package's own fp32 bar for its kernels
# (tests/test_trainer.py's forward check), dq, dk and dv within its fp32
# gradient bar (and tests/test_torch_flash.py's). The kernels' 3xTF32
# products drop ~2^-22 of each term, so they sit far inside both.
FP32_OUT_TOL = 2e-5
FP32_GRAD_TOL = 2e-4

# Phase 18's gate, the fused clip + AdamW against the loop of torch ops
# from the same first values: max |difference| over the largest magnitude
# of p, mu, nu and the norm (tests/test_torch_cuda.py's bar). The update
# takes the loop's roundings op for op, and its clip factor differs only by
# the norm's, whose fp64 sum in a fixed order lies within ~1e-7 of the
# loop's fp32 sum.
ADAMW_TOL = 1e-6

# Phase 14's gates, the fp32 flagship through the fp32 kernels against the
# same state through the plain attention path: both run every product in
# fp32 (the plain path's einsums as full-fp32 SGEMM, the kernels' as
# 3xTF32) and differ only in summation order and the split's dropped terms
# (~2^-22 of each), ~1e-6 of the attention outputs, so the gates sit far
# inside phase 4's bf16 ones (1e-4, 5e-2): the step-0 loss within
# FP32_LOSS_TOL absolute (~10x the loss's expected gap), the wq, wk, wv
# gradients within FP32_GRAD_REL_TOL per layer in relative Frobenius norm
# (the gradients' expected ~1e-5 after twelve layers' backward, times 100).
FP32_LOSS_TOL = 1e-5
FP32_GRAD_REL_TOL = 1e-3

# Step-0 gradients of wq, wk, wv, flash path against plain attention path,
# relative Frobenius norm per layer. Both paths round to bf16, at different
# places: the plain one its scores before the softmax and its probabilities,
# the kernels p and ds; the layers pass the differences on. On an
# H100 the worst layer reads 0.023 (wq, wk) and 0.016 (wv); the limit is
# about twice that.
GRAD_REL_TOL = 5e-2

# Phase 13's step-0 loss, flash path against plain attention path: the
# loss is a mean over 4,096 tokens, a quarter of phase 4's 16,384, so the
# two paths' per-token bf16 differences average out half as far: phase 4's
# 1e-4 scaled by sqrt(16384 / 4096) is 2e-4, and the limit is about twice
# that, as for the other gates.
D256_LOSS_TOL = 4e-4


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


def run_loop(config, batch, seq, card):
    """Phase 5; see the module docstring. Raises on any failed check."""
    import torch

    from training_operator_tpu_torch import graft_entry
    from training_operator_tpu_torch.trainer import flash
    from training_operator_tpu_torch.trainer.checkpoint import Checkpointer
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
    from training_operator_tpu_torch.trainer.model import loss_fn
    from training_operator_tpu_torch.trainer.standalone import export_final, train_loop
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
        state_dict,
        template_train_state,
    )

    scratch = tempfile.gettempdir()
    log(f"loop: scratch disk {scratch}: {shutil.disk_usage(scratch).free / 1e9:.1f} GB free "
        f"(a flagship checkpoint is ~6.6 GB; the overwrite holds two)")
    ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    export_dir = tempfile.mkdtemp(prefix="chip-smoke-export-")
    try:
        steps = 12
        optimizer = make_optimizer(warmup_steps=1, total_steps=100)
        state = init_train_state(config, optimizer)
        step_fn = make_train_step(config, optimizer)
        dataset = TokenDataset.synthetic(config.vocab_size, seq, num_rows=batch * 8, seed=1)
        loader = DataLoader(dataset, batch_size=batch, shuffle=True, seed=0, use_native=True)
        if not loader.use_native:
            raise AssertionError("the loader did not take the native gather")
        ckpt = Checkpointer(ckpt_dir, max_to_keep=1)
        flash.reset_launches()
        stats = train_loop(config, optimizer, state, loader, steps, ckpt, step_fn=step_fn,
                           save_every=6, log=lambda msg: log("loop: " + msg))
        loop_launches = dict(flash.launches)
        want = {name: steps * config.n_layers for name in loop_launches}
        if loop_launches != want:
            raise AssertionError(f"loop launches {loop_launches}, expected {want}")
        if stats["done"] != steps or stats["saves"] != 3 or ckpt.all_steps() != [steps]:
            raise AssertionError(f"loop ended at {stats['done']} with {stats['saves']} saves, "
                                 f"steps on disk {ckpt.all_steps()}")
        save_bytes = ckpt.step_bytes(steps)
        wall = stats["wall_s"]
        log(f"loop: {steps} steps in {wall:.3f} s, "
            f"{steps * batch * seq / wall:.1f} tokens/s wall, {stats['saves']} saves "
            f"(6, 12, forced 12) {stats['ckpt_s'] / stats['saves']:.3f} s and {save_bytes} "
            f"bytes each, data_pct {100 * stats['data_s'] / wall:.4f}, ckpt_pct "
            f"{100 * stats['ckpt_s'] / wall:.2f}, native gather on, launches {loop_launches} "
            f"on {card}")

        t = time.perf_counter()
        restored = ckpt.restore(template_train_state(config, optimizer))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        live, back = state_dict(state), state_dict(restored)
        unequal = [k for k in live if not (live[k].device == back[k].device
                                           and torch.equal(live[k], back[k]))]
        if unequal or restored.step != steps or restored.opt_state.count != steps:
            raise AssertionError(f"restore differs from the live state: {unequal[:5]}, "
                                 f"step {restored.step}, count {restored.opt_state.count}")
        example = next(iter(loader.epoch(7)))
        _, m_live = step_fn(state, example)
        _, m_back = step_fn(restored, example)
        a, b = m_live["loss"].item(), m_back["loss"].item()
        if not abs(a - b) <= 1e-6:
            raise AssertionError(f"step after restore: loss {b} vs live {a}")
        log(f"loop: restore {restore_s:.3f} s, {len(live)} entries bitwise equal; step "
            f"{steps + 1} loss live {a:.6f} restored {b:.6f} (bitwise equal: {a == b})")
        del state, restored, live, back
        torch.cuda.empty_cache()

        env = {"MODEL_EXPORT_URI": "file://" + export_dir, "PROCESS_ID": "0"}
        exported = export_final(ckpt_dir, steps, env)
        final_dir = os.path.join(ckpt_dir, str(steps))
        got = {n: os.path.getsize(os.path.join(export_dir, n)) for n in os.listdir(export_dir)}
        want_files = {n: os.path.getsize(os.path.join(final_dir, n))
                      for n in os.listdir(final_dir)}
        if got != want_files:
            raise AssertionError(f"export holds {sorted(got)}, the final step {sorted(want_files)}")
        log(f"loop: exported step {steps} only to {exported}: {len(got)} files, "
            f"{sum(got.values())} bytes")

        fn, args = graft_entry.entry()
        with torch.no_grad():
            loss = fn(*args).item()
            ref = loss_fn(*args, graft_entry._tiny_config()).item()
        if not (torch.isfinite(torch.tensor(loss)) and abs(loss - ref) <= 1e-6):
            raise AssertionError(f"graft entry loss {loss} vs loss_fn {ref}")
        log(f"loop: graft entry loss {loss:.6f} (loss_fn {ref:.6f})")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(export_dir, ignore_errors=True)


def plain_reference(flash, q, k, v, do, causal, lse, delta, rows):
    """The plain versions on the unsplit sequence in fp32, `rows` batch rows
    at a time (the score matrices of [2, 8192, 12, 128] take 3.2 GB per row):
    out and lse of the forward, and dq, dk, dv of the backward given `lse`
    and `delta` ([B*H, S(, 1)], the checked path's own, as phase 3 gives
    each kernel's)."""
    import torch

    h = q.shape[2]
    outs = {n: [] for n in ("out", "lse", "dq", "dk", "dv")}
    for i in range(0, q.shape[0], rows):
        qf, kf, vf, dof = (x[i:i + rows].float() for x in (q, k, v, do))
        out, ref_lse = flash.flash_fwd_plain(qf, kf, vf, causal)
        outs["out"].append(out)
        outs["lse"].append(ref_lse)
        lse_i, delta_i = lse[i * h:(i + rows) * h], delta[i * h:(i + rows) * h]
        outs["dq"].append(flash.flash_bwd_dq_plain(qf, kf, vf, dof, lse_i, delta_i, causal))
        dk, dv = flash.flash_bwd_dkv_plain(qf, kf, vf, dof, lse_i, delta_i, causal)
        outs["dk"].append(dk)
        outs["dv"].append(dv)
        del qf, kf, vf, dof, out, ref_lse, dk, dv
        torch.cuda.empty_cache()
    return {n: torch.cat(x, 0) for n, x in outs.items()}


def cuda_ms(fn, iters: int) -> float:
    """Mean ms of `fn()` over `iters` calls after one warm-up, CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Phase 8's cases: (the unsplit [B, S, H, D] shape, the ring's ranks).
RING_CASES = (((8, 2048, 12, 128), 2), ((8, 2048, 12, 128), 4), ((2, 8192, 12, 128), 4))


def run_ring(card) -> dict:
    """Phase 8; see the module docstring. Raises on any failed check and
    returns the launch counts of the checked calls, summed."""
    import torch

    from training_operator_tpu_torch.trainer import attention, flash

    totals = {n: 0 for n in flash.launches}
    for i, (shape, ns) in enumerate(RING_CASES):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
                       for _ in range(4))
        blocks = [[c.contiguous() for c in x.chunk(ns, 1)] for x in (q, k, v, do)]
        flash.reset_launches()
        outs, lses, dqs, dks, dvs = attention.ring_loopback(*blocks, True)
        torch.cuda.synchronize()
        got, causal = dict(flash.launches), dict(flash.launches_causal)
        want = ns * (ns + 1) // 2
        if got != {n: want for n in got} or causal != {n: ns for n in causal}:
            raise AssertionError(f"ring {list(shape)} NS={ns}: launches {got}, causal {causal}; "
                                 f"expected {want} of each, {ns} causal")
        for n in totals:
            totals[n] += got[n]
        b, s, h, _ = shape
        out = torch.cat(outs, 1)
        lse = torch.cat([x.reshape(b, h, -1) for x in lses], 2).reshape(b * h, s, 1)
        ref = plain_reference(flash, q, k, v, do, True, lse, flash.row_delta(do, out),
                              rows=1 if s > 4096 else b)
        out_err = (out.float() - ref["out"]).abs()
        lse_err = (lse - ref["lse"]).abs().max().item()
        if not bool((out_err <= 1e-2 + 1e-2 * ref["out"].abs()).all()) or lse_err > 1e-3:
            raise AssertionError(f"ring {list(shape)} NS={ns}: out max abs err "
                                 f"{out_err.max().item()}, lse {lse_err}")
        errs = {"out": out_err.max().item(), "lse": lse_err}
        for name, parts in (("dq", dqs), ("dk", dks), ("dv", dvs)):
            errs.update(grad_errors(name, torch.cat(parts, 1), ref[name],
                                    f"in the ring at {list(shape)} NS={ns}"))
        del ref, out, lse, out_err, outs, lses, dqs, dks, dvs
        torch.cuda.empty_cache()

        def unsplit():
            o, lse = flash.flash_fwd(q, k, v, True)
            delta = flash.row_delta(do, o)
            flash.flash_bwd_dq(q, k, v, do, lse, delta, True)
            flash.flash_bwd_dkv(q, k, v, do, lse, delta, True)

        ring_ms = cuda_ms(lambda: attention.ring_loopback(*blocks, True), iters=5)
        flat_ms = cuda_ms(unsplit, iters=5)
        log(f"ring: {list(shape)} bf16 causal NS={ns}: launches {got} ({ns} causal each), "
            + json.dumps(errs) + f"; forward+backward {ring_ms:.4f} ms loopback ring vs "
            f"{flat_ms:.4f} ms unsplit flash ({100 * (ring_ms / flat_ms - 1):+.1f}%) on {card}")
        del q, k, v, do, blocks
        torch.cuda.empty_cache()
    flash.reset_launches()
    return totals


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


MESH_ENV = {"COORDINATOR_ADDRESS": "127.0.0.1", "NUM_PROCESSES": "1", "PROCESS_ID": "0",
            "TPU_MESH_AXES": "fsdp=1,tensor=1"}


def rel_frobenius(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def run_mesh(config, batch, seq, card, phase4) -> dict:
    """Phase 6; see the module docstring. Raises on any failed check and
    returns the launch counts of its sharded steps."""
    import torch

    from training_operator_tpu_torch.trainer import distributed, flash
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
    from training_operator_tpu_torch.trainer.mesh import mesh_from_env, mesh_shape
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    saved_env = {k: os.environ.get(k) for k in (*MESH_ENV, "COORDINATOR_PORT")}
    os.environ.update(MESH_ENV, COORDINATOR_PORT=str(free_port()))
    try:
        device = distributed.initialize()
        mesh = mesh_from_env(device.type)
        log(f"mesh: world of {torch.distributed.get_world_size()} "
            f"({torch.distributed.get_backend()}) on {device}, mesh {mesh_shape(mesh)}")
        optimizer = make_optimizer(warmup_steps=1, total_steps=100)
        dataset = TokenDataset.synthetic(config.vocab_size, seq, num_rows=batch * 4, seed=0)
        loader = DataLoader(dataset, batch_size=batch, shuffle=True, seed=0, mesh=mesh)
        batches = [b for _, b in zip(range(6), loader.epoch(0))]
        batches += [b for _, b in zip(range(6 - len(batches)), loader.epoch(1))]

        # The unsharded step on the same parameters and the first two
        # batches; its parameters and mu after step 2 go to the host.
        ref = init_train_state(config, optimizer)
        ref_step = make_train_step(config, optimizer)
        ref, m = ref_step(ref, batches[0])
        ref_loss = m["loss"].item()
        ref, _ = ref_step(ref, batches[1])
        want = {n: (p.detach().cpu(), ref.opt_state.mu[n].cpu())
                for n, p in ref.model.named_parameters()}
        del ref, ref_step, m
        torch.cuda.empty_cache()

        state = init_train_state(config, optimizer, mesh=mesh)
        step_fn = make_train_step(config, optimizer, mesh=mesh)
        per_step = {"flash_fwd": config.n_layers, "flash_bwd_dq": config.n_layers,
                    "flash_bwd_dkv": config.n_layers}
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launches()
        times = []
        for i, data in enumerate(batches):
            before = dict(flash.launches)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            state, metrics = step_fn(state, data)
            end.record()
            loss = metrics["loss"].item()
            ms = start.elapsed_time(end)
            grew = {n: flash.launches[n] - before[n] for n in per_step}
            if grew != per_step:
                raise AssertionError(f"mesh step {i}: launches grew by {grew}, "
                                     f"expected {per_step}")
            if not torch.isfinite(metrics["loss"]) or not torch.isfinite(metrics["grad_norm"]):
                raise AssertionError(f"mesh step {i}: non-finite loss or grad norm: {metrics}")
            if i > 0:
                times.append(ms)
            log(f"mesh: step {i} loss {loss:.6f} grad_norm {metrics['grad_norm'].item():.6f} "
                f"{ms:.2f} ms device" + (" (warm-up)" if i == 0 else ""))
            if i == 0 and not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss):
                raise AssertionError(f"mesh step-0 loss {loss} vs unsharded {ref_loss}")
            if i == 1:
                errs = {}
                for n, p in state.model.named_parameters():
                    wp, wmu = want[n]
                    errs[n] = max(rel_frobenius(p.detach(), wp.to(p.device)),
                                  rel_frobenius(state.opt_state.mu[n], wmu.to(p.device)))
                worst = max(errs, key=errs.get)
                if not errs[worst] <= 1e-5:
                    raise AssertionError(f"after two steps, sharded vs unsharded: {errs}")
                log(f"mesh: after two steps every parameter and mu within 1e-5 of the "
                    f"unsharded step (worst {worst} {errs[worst]:.3e}); step-0 loss "
                    f"{ref_loss:.6f} unsharded")
                del want
        launches = dict(flash.launches)
        step_ms = sum(times) / len(times)
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"mesh: {step_ms:.2f} ms/step (mean of {len(times)}; phase 4 "
            f"{phase4['step_ms']:.2f}), {batch * seq / (step_ms / 1e3):.1f} tokens/s (phase 4 "
            f"{phase4['tokens_s']:.1f}), peak memory {peak:.2f} GB (phase 4 "
            f"{phase4['peak_gb']:.2f}), launches {launches} on {card}")
        del state, step_fn, batches, loader, metrics
        torch.cuda.empty_cache()

        # The trainer entry under the operator's env, then relaunched.
        ckpt_dir = tempfile.mkdtemp(prefix="chip-smoke-mesh-ckpt-")
        try:
            for steps, want_lines in ((4, ["done at step 4"]),
                                      (6, ["resumed at step 4", "done at step 6"])):
                env = {**os.environ, "COORDINATOR_PORT": str(free_port())}
                env.pop("MODEL_EXPORT_URI", None)
                t = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", "training_operator_tpu_torch.trainer.standalone",
                     "--steps", str(steps), "--checkpoint-dir", ckpt_dir],
                    env=env, capture_output=True, text=True, timeout=300)
                lines = proc.stdout.splitlines()
                if proc.returncode != 0 or not all(w in lines for w in want_lines):
                    raise AssertionError(f"trainer entry --steps {steps}: rc {proc.returncode}, "
                                         f"stdout {lines}, stderr {proc.stderr[-2000:]}")
                log(f"mesh: trainer entry --steps {steps} in {time.perf_counter() - t:.1f} s: "
                    + " | ".join(lines))
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        distributed.shutdown()
        return launches
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed_steps(step_fn, state, batches, per_step, label, head_per_step=None):
    """Runs `step_fn` over `batches`: each step must launch `per_step` of
    each kernel (and `head_per_step` of each head product, where given) and
    give a finite loss and norm. Returns (state, losses, device ms of each
    step after the first)."""
    import torch

    from training_operator_tpu_torch.trainer import flash, head_gemm

    losses, times = [], []
    for i, data in enumerate(batches):
        before, head_before = dict(flash.launches), dict(head_gemm.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, data)
        end.record()
        loss = metrics["loss"].item()
        ms = start.elapsed_time(end)
        grew = {n: flash.launches[n] - before[n] for n in per_step}
        if grew != per_step:
            raise AssertionError(f"{label} step {i}: launches grew by {grew}, expected {per_step}")
        head_grew = {n: head_gemm.launches[n] - head_before[n] for n in head_gemm.launches}
        if head_per_step is not None and head_grew != head_per_step:
            raise AssertionError(f"{label} step {i}: head launches grew by {head_grew}, "
                                 f"expected {head_per_step}")
        if not torch.isfinite(metrics["loss"]) or not torch.isfinite(metrics["grad_norm"]):
            raise AssertionError(f"{label} step {i}: non-finite loss or grad norm: {metrics}")
        losses.append(loss)
        if i > 0:
            times.append(ms)
        log(f"{label}: step {i} loss {loss:.6f} grad_norm {metrics['grad_norm'].item():.6f} "
            f"{ms:.2f} ms device" + (" (warm-up)" if i == 0 else ""))
    return state, losses, times


def example_batches(config, batch, seq, n):
    from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset

    dataset = TokenDataset.synthetic(config.vocab_size, seq, num_rows=batch * 2, seed=0)
    loader = DataLoader(dataset, batch_size=batch, shuffle=True, seed=0)
    return [b for e in range(n) for b in loader.epoch(e)][:n]


def routing_gap(model, batch, config):
    """Forward losses of a MoE model on `batch` (no grad): through the
    flash kernels, through the plain attention path, and through the plain
    path with every layer's routing pinned to the flash run's (moe.route's
    `choice`); and per layer how many tokens the plain path sends to
    another expert. Top-1 routing is discontinuous: the two attention
    paths differ in bf16's last bits, which moves near-tied tokens to
    other experts, each a different MLP; the pinned loss holds the
    attention paths to one routing, as phase 4's gate holds them in a
    dense model."""
    import torch

    from training_operator_tpu_torch.trainer import moe
    from training_operator_tpu_torch.trainer.model import loss_fn

    original, recorded, flips = moe.route, [], []

    def record(h, router, cfg, mesh=None, choice=None):
        out = original(h, router, cfg, mesh, choice)
        recorded.append(out[0])
        return out

    def replay(h, router, cfg, mesh=None, choice=None):
        pinned = recorded.pop(0)
        flips.append(int((original(h, router, cfg, mesh)[0] != pinned).sum()))
        return original(h, router, cfg, mesh, pinned)

    plain = dataclasses.replace(config, attn_impl="xla")
    try:
        with torch.no_grad():
            moe.route = record
            flash_loss = loss_fn(model, batch, config).item()
            moe.route = original
            plain_loss = loss_fn(model, batch, plain).item()
            moe.route = replay
            pinned_loss = loss_fn(model, batch, plain).item()
    finally:
        moe.route = original
    return flash_loss, plain_loss, pinned_loss, flips


def run_moe(card) -> dict:
    """Phase 9; see the module docstring. Raises on any failed check and
    returns the launch counts of its steps."""
    import torch

    from training_operator_tpu_torch.trainer import bench, flash
    from training_operator_tpu_torch.trainer.model import loss_fn
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    config, batch, seq = bench.moe_config()
    optimizer = make_optimizer(warmup_steps=1, total_steps=100)
    state = init_train_state(config, optimizer)
    step_fn = make_train_step(config, optimizer)
    total, active = bench._count_params(state.model)
    batches = example_batches(config, batch, seq, 6)
    flash_loss, plain_loss, pinned_loss, flips = routing_gap(state.model, batches[0], config)
    routing = bench.moe_routing(state.model, batches[0]["tokens"])
    starved = [(layer, e) for layer, shares in enumerate(routing["expert_shares"])
               for e, share in enumerate(shares) if share == 0]
    if starved:
        raise AssertionError(f"moe: (layer, expert) with no tokens at step 0: {starved}")
    per_step = {n: config.n_layers for n in flash.launches}
    flash.reset_launches()
    state, losses, times = timed_steps(step_fn, state, batches, per_step, "moe")
    launches = dict(flash.launches)
    if abs(losses[0] - pinned_loss) > 1e-4:
        raise AssertionError(f"moe step-0 loss {losses[0]} vs plain-attention loss "
                             f"{pinned_loss} on the same routing")
    step_ms = sum(times) / len(times)
    mfu = bench.flops_per_step(config, active, batch, seq) / (step_ms / 1e3) \
        / bench.PEAK_BF16_FLOPS["H100"]
    log(f"moe: {total / 1e6:.1f}M params ({active / 1e6:.1f}M active in products), "
        f"{config.n_experts} experts at capacity {config.expert_capacity}, batch {batch} x "
        f"seq {seq}, {config.dtype}; step-0 loss flash {losses[0]:.6f} (no-grad forward "
        f"{flash_loss:.6f}), plain attention on the flash run's routing {pinned_loss:.6f}, "
        f"on its own routing {plain_loss:.6f} (tokens routed elsewhere per layer: {flips}); "
        f"{step_ms:.2f} ms/step (mean of {len(times)}), "
        f"{batch * seq / (step_ms / 1e3):.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s bf16 "
        f"[{bench.FLOPS_RULE}], peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"launches {launches} on {card}")
    log("moe: step 0 routing, dropped share per layer "
        + json.dumps([round(x, 6) for x in routing["dropped_share"]])
        + "; expert shares per layer "
        + json.dumps([[round(x, 6) for x in row] for row in routing["expert_shares"]]))
    del state, step_fn, batches
    torch.cuda.empty_cache()
    return launches


# Phase 11's bf16 forward against fp32, relative to the largest fp32 logit.
VISION_BF16_TOL = 2e-2


def run_vision(card) -> None:
    """Phase 11; see the module docstring. Raises on any failed check."""
    import math

    import torch

    from training_operator_tpu_torch.trainer import vision

    config, batch, steps = vision.VisionConfig(), 256, 60
    torch.cuda.reset_peak_memory_stats()
    out = vision.train_synthetic(config, steps=steps, batch=batch,
                                 log=lambda msg: log("vision: " + msg))
    losses, accs = out["losses"], out["accuracies"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"vision: a loss is not finite: {losses}")
    if not accs[-1] > 0.9:
        raise AssertionError(f"vision: final accuracy {accs[-1]} is not above 0.9")
    timed = out["step_ms"][1:]
    step_ms = sum(timed) / len(timed)
    log(f"vision: {step_ms:.4f} ms/step (mean of steps 1-{steps - 1}), "
        f"{batch / (step_ms / 1e3):.1f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.4f} GB, loss/accuracy "
        + ", ".join(f"{i}: {losses[i]:.6g}/{accs[i]:.3f}"
                    for i in (*range(0, steps, 10), steps - 1))
        + f" on {card}")
    with torch.no_grad():
        low = vision.vision_forward(out["params"], out["batch"]["images"], config)
        ref = vision.vision_forward(out["params"], out["batch"]["images"],
                                    dataclasses.replace(config, dtype=torch.float32))
    gap = (low - ref).abs().max().item() / ref.abs().max().item()
    if not gap <= VISION_BF16_TOL or not torch.equal(low.argmax(-1), ref.argmax(-1)):
        raise AssertionError(f"vision: bf16 forward vs fp32 {gap} of the largest logit "
                             f"(limit {VISION_BF16_TOL}) or the argmax differs")
    log(f"vision: bf16 vs fp32 forward {gap:.6f} of the largest logit "
        f"({ref.abs().max().item():.3f}), argmax equal on {batch} images")


def run_solver(card) -> None:
    """Phase 12; see the module docstring. Raises on any failed check."""
    import statistics

    import numpy as np

    from training_operator_tpu_torch.scheduler import packer

    inst = packer.scale_instance()
    free, cands, item_class, item_active = inst[0], inst[1:5], inst[5], inst[6]
    host_ms, ref = [], None
    for _ in range(5):
        t = time.perf_counter()
        ref = packer.solve_batch_numpy(*inst)
        host_ms.append((time.perf_counter() - t) * 1e3)
    solver = packer.TorchSolver()
    k, c = cands[2].shape
    solver.prewarm(free.shape[0], free.shape[1], items=len(item_class), cands=c, classes=k)

    def timed(generation) -> float:
        t = time.perf_counter()
        chosen = solver.solve(free, cands, item_class, item_active, generation=generation)
        ms = (time.perf_counter() - t) * 1e3
        if chosen.dtype != np.int32 or not np.array_equal(chosen, ref):
            bad = np.nonzero(chosen != ref)[0]
            raise AssertionError(f"solver: card placements differ from the numpy arm at "
                                 f"{bad.size} items, first {bad[:5].tolist()}")
        return ms

    cold = [timed(("cold", i)) for i in range(5)]
    timed("warm")  # uploads the candidates once
    warm = [timed("warm") for _ in range(5)]
    stats = solver.last_stats
    log(f"solver: {free.shape[0] * free.shape[1]} hosts, {len(item_class)} gangs, "
        f"{int((ref >= 0).sum())} admitted, {stats['rounds']} rounds, padded (G, K, C) "
        f"{stats['padded']}: placements equal the numpy arm's bit for bit; "
        f"card {statistics.median(cold):.4f} ms cold (upload included), "
        f"{statistics.median(warm):.4f} ms warm (median of 5 each, host clock, result on "
        f"the host) on {card}; numpy arm {statistics.median(host_ms):.4f} ms "
        f"(host time, median of 5, this machine's CPU)")


def run_pipeline(card, phase4) -> dict:
    """Phase 10; see the module docstring. Raises on any failed check and
    returns the launch counts of its steps."""
    import torch

    from training_operator_tpu_torch.trainer import bench, flash, pipeline
    from training_operator_tpu_torch.trainer.model import loss_fn
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    config, batch, seq, stages = bench.pipeline_config()
    optimizer = make_optimizer(warmup_steps=1, total_steps=100)
    state = init_train_state(config, optimizer)
    step_fn = make_train_step(config, optimizer)
    batches = example_batches(config, batch, seq, 6)
    model = state.model

    def loss_and_grads():
        loss = loss_fn(model, batches[0], config)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    flat_loss, flat_grads = loss_and_grads()
    pipeline.loopback(model, stages)
    pipe_loss, pipe_grads = loss_and_grads()
    errs = {n: rel_frobenius(pipe_grads[n], flat_grads[n]) for n in flat_grads}
    worst = max(errs, key=errs.get)
    del flat_grads, pipe_grads
    if not abs(pipe_loss - flat_loss) <= 1e-4 * abs(flat_loss) or errs[worst] > GRAD_REL_TOL:
        raise AssertionError(f"pipeline vs unpipelined: loss {pipe_loss} vs {flat_loss}, "
                             f"gradient errors {errs}")
    log(f"pipeline: {stages} loopback stages x {config.pipeline_microbatches} microbatches of "
        f"{batch // config.pipeline_microbatches} x {seq}; step-0 loss {pipe_loss:.6f} "
        f"(unpipelined {flat_loss:.6f}); worst gradient {worst} {errs[worst]:.3e} relative")
    per_step = {n: config.n_layers * config.pipeline_microbatches for n in flash.launches}
    flash.reset_launches()
    state, losses, times = timed_steps(step_fn, state, batches, per_step, "pipeline")
    launches = dict(flash.launches)
    step_ms = sum(times) / len(times)
    log(f"pipeline: {step_ms:.2f} ms/step (mean of {len(times)}; phase 4 unpipelined "
        f"{phase4['step_ms']:.2f}): the two stages run one after another on one card, so this "
        f"is the schedule's and the smaller launches' cost, not a bubble or a hand-off (NCCL "
        f"cannot put two ranks on one card); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {launches} on {card}")
    del state, step_fn, batches, model
    torch.cuda.empty_cache()
    return launches


def run_d256(card) -> dict:
    """Phase 13; see the module docstring. Raises on any failed check and
    returns the launch counts of its steps."""
    import torch

    from training_operator_tpu_torch.trainer import bench, flash
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    config, batch, seq = bench.gemma2b_config()
    optimizer = make_optimizer(warmup_steps=1, total_steps=100)
    state = init_train_state(config, optimizer)
    step_fn = make_train_step(config, optimizer)
    total, n_matmul = bench._count_params(state.model)
    batches = example_batches(config, batch, seq, 6)
    xla_loss, xla_grads = attention_grads(state.model, batches[0],
                                          dataclasses.replace(config, attn_impl="xla"))
    flash_loss, flash_grads = attention_grads(state.model, batches[0], config)
    grad_errs = {
        n: max(rel_frobenius(flash_grads[n][i], xla_grads[n][i])
               for i in range(config.n_layers))
        for n in xla_grads
    }
    del xla_grads, flash_grads
    torch.cuda.empty_cache()
    log(f"d256: {total} params ({n_matmul} in products), head_dim {config.head_dim}, "
        f"{config.n_heads} heads over {config.n_kv_heads} kv head, batch {batch} x seq {seq}, "
        f"{config.dtype}, remat {config.remat_policy} + head; step-0 loss plain attention "
        f"{xla_loss:.6f} flash {flash_loss:.6f}; gradient rel err flash vs plain, worst "
        f"layer: " + json.dumps(grad_errs))
    if not max(grad_errs.values()) <= GRAD_REL_TOL:
        raise AssertionError(f"d256 step-0 attention gradients, flash vs plain: {grad_errs} "
                             f"beyond {GRAD_REL_TOL}")
    per_step = {n: config.n_layers for n in flash.launches}
    flash.reset_launches()
    state, losses, times = timed_steps(step_fn, state, batches, per_step, "d256")
    launches = dict(flash.launches)
    gap = losses[0] - xla_loss
    if not abs(gap) <= D256_LOSS_TOL:
        raise AssertionError(f"d256 step-0 loss {losses[0]} vs plain-attention loss "
                             f"{xla_loss}: gap {gap} beyond {D256_LOSS_TOL}")
    step_ms = sum(times) / len(times)
    mfu = bench.flops_per_step(config, n_matmul, batch, seq) / (step_ms / 1e3) \
        / bench.PEAK_BF16_FLOPS["H100"]
    log(f"d256: step-0 loss gap flash - plain {gap:.3e} (limit {D256_LOSS_TOL}); "
        f"{step_ms:.2f} ms/step (mean of {len(times)}), {batch * seq / (step_ms / 1e3):.1f} "
        f"tokens/s, MFU {mfu:.4f} of 989 TFLOP/s bf16 [{bench.FLOPS_RULE}], peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {launches} on {card}")
    del state, step_fn, batches
    torch.cuda.empty_cache()
    return launches


def _ms_summary(values) -> str:
    """median, p90, max and first of per-cycle ms."""
    import statistics

    ordered = sorted(values)
    p90 = ordered[min(len(ordered) - 1, int(0.9 * len(ordered)))]
    return (f"median {statistics.median(ordered):.4f}, p90 {p90:.4f}, max {ordered[-1]:.4f}, "
            f"first {values[0]:.4f}")


def run_placer(card) -> None:
    """Phase 15; see the module docstring. Raises on any difference between
    the card's placements and the numpy arm's."""
    import statistics

    from training_operator_tpu_torch.scheduler import burst, packer

    # (a) the 10k-node block: one cold place(), then one warm one on a fresh
    # snapshot of the same inventory; the numpy arm on a copy of each.
    nodes = burst.scale_pool()
    card_p, host_p = packer.TPUPacker(), packer.TPUPacker(kernel="numpy")
    card_reqs, host_reqs = burst.scale_requests(), burst.scale_requests()
    for label in ("cold", "warm"):
        t = time.perf_counter()
        snap = burst.usage_snapshot(nodes, inventory_gen=1)
        build_s = time.perf_counter() - t
        t = time.perf_counter()
        got = card_p.place(card_reqs, snap, now=10_000.0)
        card_ms = (time.perf_counter() - t) * 1e3
        stats = dict(card_p.last_solve_stats)
        t = time.perf_counter()
        want = host_p.place(host_reqs, burst.usage_snapshot(nodes, inventory_gen=1),
                            now=10_000.0)
        host_ms = (time.perf_counter() - t) * 1e3
        bad = burst.placement_diff(want, got)
        if bad:
            raise AssertionError(f"placer: the 10k-node block's {label} place() on the card "
                                 f"differs from the numpy arm on {len(bad)} gangs: {bad[:3]}")
        admitted = sum(p is not None for p in got.values())
        if not admitted or stats.get("kernel") != "torch" or not stats.get("rounds"):
            raise AssertionError(f"placer: the 10k-node block's {label} place() admitted "
                                 f"{admitted} gangs with solve stats {stats}")
        log(f"placer: 10k block {label}: {len(nodes)} nodes, {len(card_reqs)} gangs, "
            f"{admitted} admitted (equal to the numpy arm's, field by field); snapshot build "
            f"{build_s:.4f} s; place() {card_ms:.4f} ms on the card ({stats['rounds']:.0f} "
            f"rounds, {stats['batch_items']:.0f} items, padded classes x candidates "
            f"{stats['classes']:.0f} x {stats['candidates']:.0f}, solve {stats['solve_ms']:.4f} "
            f"ms), numpy arm {host_ms:.4f} ms (host time, this machine's CPU); {card}")

    # (b) the burst pool at bench.py's geometry, replayed cycle by cycle,
    # the card's placements held to the numpy arm's in every cycle.
    nodes = burst.burst_pool()
    card_p = packer.TPUPacker()
    card_p.prewarm(burst.usage_snapshot(nodes))
    t = time.perf_counter()
    out = burst.replay([card_p, packer.TPUPacker(kernel="numpy")], nodes,
                       burst.build_workload(1000, 0), max_cycles=400)
    wall = time.perf_counter() - t
    if not out["admitted"] or not out["rounds"]:
        raise AssertionError(f"placer: the burst admitted {out['admitted']} gangs in "
                             f"{out['cycles']} cycles, {len(out['rounds'])} card solves")
    card_ms, host_ms = out["place_ms"]
    share = [sum(s) / sum(p) for s, p in zip(out["solve_ms"], out["place_ms"])]
    log(f"placer: burst {out['gangs']} gangs on {len(nodes)} nodes: {out['cycles']} cycles "
        f"(cap 400), {out['admitted']} admitted by t={out['end_t']:.0f} s of the "
        f"replay's cycle model, placements equal to the numpy arm's in every cycle; "
        f"{len(out['rounds'])} card solves, rounds median "
        f"{statistics.median(out['rounds']):.0f}, max {max(out['rounds']):.0f}; {wall:.2f} s")
    log(f"placer: burst place() ms per cycle, card: {_ms_summary(card_ms)}; solve share "
        f"{share[0]:.4f}")
    log(f"placer: burst place() ms per cycle, numpy arm (host time, this machine's CPU): "
        f"{_ms_summary(host_ms)}; solve share {share[1]:.4f}; {card}")


def run_operator(card) -> None:
    """Phase 16; see the module docstring. Raises on any difference between
    the card arm's records and the numpy arm's, or on any job that does not
    succeed."""
    import statistics

    import torch

    from training_operator_tpu_torch.scheduler import burst, packer

    specs = burst.build_workload(1000, 0)
    arms = (("card", lambda: packer.TPUPacker()),
            ("numpy arm", lambda: packer.TPUPacker(kernel="numpy")))

    def run(make, charge):
        placer = make()
        out = burst.run_burst(specs, placer, charge_solve_time=charge)
        missing = sorted(set(s[1] for s in specs) - set(out["succeeded"]))
        if missing or len(out["admitted"]) != len(specs):
            raise AssertionError(f"operator: {len(missing)} jobs did not succeed (first "
                                 f"{missing[:3]}), {len(out['admitted'])} of {len(specs)} "
                                 f"gangs admitted")
        if placer.kernel == "torch":
            torch.cuda.synchronize()
            kernels = {r["solver"]["kernel"] for r in out["trace"] if "solver" in r}
            if kernels != {"torch"} or placer.device.type != "cuda":
                raise AssertionError(f"operator: the card arm solved with {kernels} on "
                                     f"{placer.device}")
        return out

    # (a) parity: charge_solve_time off, so virtual time is a function of
    # the placements alone and both arms must give the same records.
    runs = {}
    for label, make in arms:
        out = runs[label] = run(make, False)
        cycle_ms = [r["solve_wall_s"] * 1e3 for r in out["trace"]]
        solve_ms = sum(r["solver"].get("solve_ms", 0.0) for r in out["trace"] if "solver" in r)
        ordered = sorted(cycle_ms)
        log(f"operator (a) {label}: {len(specs)} jobs, all succeeded; {out['cycles']} cycles, "
            f"makespan {out['makespan_s']} s, schedule-to-running p50 {out['p50_s']} s, p90 "
            f"{out['p90_s']} s (virtual); solve cycle (snapshot, requests, place()) ms "
            f"median {statistics.median(ordered):.4f}, p90 "
            f"{ordered[int(0.9 * (len(ordered) - 1))]:.4f}, max {ordered[-1]:.4f}, first "
            f"{cycle_ms[0]:.4f}, the solve's share {solve_ms / sum(cycle_ms):.4f}; wall "
            f"{out['bench_wall_s']:.2f} s; "
            f"{card}")
    want, got = runs["numpy arm"], runs["card"]
    for key in ("admitted", "running", "succeeded", "cycles"):
        if got[key] != want[key]:
            bad = (sorted(k for k in set(got[key]) | set(want[key])
                          if got[key].get(k) != want[key].get(k))[:3]
                   if isinstance(want[key], dict) else [got[key], want[key]])
            raise AssertionError(f"operator: the card arm's {key} differ from the numpy "
                                 f"arm's: {bad}")
    if burst.trace_records(got["trace"]) != burst.trace_records(want["trace"]):
        raise AssertionError("operator: the card arm's solve cycles differ from the numpy "
                             "arm's")
    log(f"operator (a): the card arm equals the numpy arm: every PodGroup's placement, "
        f"reserved nodes, score and admission time, every job's Running and Succeeded "
        f"times, {got['cycles']} cycles")

    # (b) bench's own setting: each solve's wall time charged to the clock.
    keys = ("p50_s", "p90_s", "p99_s", "makespan_s", "solver_wall_s", "solver_cycles",
            "solver_incremental_cycles", "bench_wall_s")
    for label, make in arms:
        out = run(make, True)
        log(f"operator (b) {label}, charge_solve_time=True: "
            f"{json.dumps({k: out[k] for k in keys})}; {card}")


def run_fp32(card) -> dict:
    """Phase 14; see the module docstring. Raises on any failed check and
    returns the launch counts of its steps (all fp32)."""
    import torch

    from training_operator_tpu_torch.trainer import bench, flash
    from training_operator_tpu_torch.trainer.train import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    config, batch, seq = bench.flagship_fp32_config()
    optimizer = make_optimizer(warmup_steps=1, total_steps=100)
    state = init_train_state(config, optimizer)
    step_fn = make_train_step(config, optimizer)
    total, n_matmul = bench._count_params(state.model)
    batches = example_batches(config, batch, seq, 4)
    xla_loss, xla_grads = attention_grads(state.model, batches[0],
                                          dataclasses.replace(config, attn_impl="xla"))
    flash_loss, flash_grads = attention_grads(state.model, batches[0], config)
    grad_errs = {
        n: max(rel_frobenius(flash_grads[n][i], xla_grads[n][i])
               for i in range(config.n_layers))
        for n in xla_grads
    }
    del xla_grads, flash_grads
    torch.cuda.empty_cache()
    gap = flash_loss - xla_loss
    log(f"fp32: {total} params ({n_matmul} in products), batch {batch} x seq {seq}, "
        f"{config.dtype}, remat {config.remat_policy} + head; step-0 loss plain attention "
        f"{xla_loss:.7f} flash {flash_loss:.7f} (gap {gap:.3e}, limit {FP32_LOSS_TOL}); "
        f"gradient rel err flash vs plain, worst layer: " + json.dumps(grad_errs)
        + f" (limit {FP32_GRAD_REL_TOL})")
    if not abs(gap) <= FP32_LOSS_TOL:
        raise AssertionError(f"fp32 step-0 loss {flash_loss} vs plain-attention loss "
                             f"{xla_loss}: gap {gap} beyond {FP32_LOSS_TOL}")
    if not max(grad_errs.values()) <= FP32_GRAD_REL_TOL:
        raise AssertionError(f"fp32 step-0 attention gradients, flash vs plain: {grad_errs} "
                             f"beyond {FP32_GRAD_REL_TOL}")
    per_step = {n: config.n_layers for n in flash.launches}
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launches()
    state, losses, times = timed_steps(step_fn, state, batches, per_step, "fp32",
                                       head_per_step={"logits": 2, "dx": 1, "dw": 1})
    launches = dict(flash.launches)
    by_type = {t: dict(c) for t, c in flash.launches_dtype.items()}
    want = {"fp32": {n: len(batches) * c for n, c in per_step.items()},
            "bf16": dict.fromkeys(per_step, 0), "fp16": dict.fromkeys(per_step, 0)}
    if by_type != want:
        raise AssertionError(f"fp32 steps launched {by_type}, expected {want}")
    step_ms = sum(times) / len(times)
    mfu = bench.flops_per_step(config, n_matmul, batch, seq) / (step_ms / 1e3) \
        / bench.PEAK_BF16_FLOPS["H100"]
    log(f"fp32: {step_ms:.2f} ms/step (mean of {len(times)}), "
        f"{batch * seq / (step_ms / 1e3):.1f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s bf16 "
        f"[{bench.FLOPS_RULE}; the bf16 peak, as every phase, though the step runs in fp32], "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches by type "
        f"{json.dumps(by_type)} on {card}")
    del state, step_fn, batches
    torch.cuda.empty_cache()
    return launches


def run_head(card) -> dict:
    """Phase 17; see the module docstring. Raises where a product's float64
    error passes its limits; returns {product: {cell shape: fields}}."""
    import torch

    from training_operator_tpu_torch.trainer import bench

    rows = {}
    for label, (t, d, v) in bench.HEAD_SHAPES.items():
        times = bench.bench_head(t, d, v)
        errs = bench.head_float64_errors(t, d, v)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = bench.head_float64_errors(t, d, v)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        for product, row in times.items():
            e = errs[product]
            row.update(err=e["kernel"], sgemm_err=e["library"], tf32_err=tf32[product]["library"],
                       max_abs=e["max_abs"])
            rows.setdefault(product, {})[label] = row
            log(f"head: {product} {label} [T, D, V] {row['shape']} " + json.dumps(row))
            if not (e["kernel"] <= 4 * e["library"] and e["kernel"] <= row["tf32_err"] / 100):
                raise AssertionError(f"head {product} at {label}: error {e['kernel']} against "
                                     f"SGEMM's {e['library']} and TF32's {row['tf32_err']}")
        torch.cuda.empty_cache()
    log(f"head: done on {card}")
    return rows


def run_adamw(card) -> dict:
    """Phase 18; see the module docstring. Returns {configuration: fields}."""
    import torch

    from benchmark import families
    from training_operator_tpu_torch.trainer import bench

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    rows = {}
    for entry in configs:
        with open(os.path.join(root, entry["file"])) as f:
            config = json.load(f)
        family = families.load(root, config.get("family", families.DEFAULT))
        row = bench.bench_adamw(family.param_shapes(family.dims(config)))
        log(f"adamw: {entry['name']} " + json.dumps(row))
        if row["launches"] != {"sumsq": 1, "update": 1}:
            raise AssertionError(f"adamw at {entry['name']}: launches a call {row['launches']}")
        if max(row["errors"].values()) > ADAMW_TOL:
            raise AssertionError(f"adamw at {entry['name']}: the kernels differ from the loop "
                                 f"by more than {ADAMW_TOL}: {row['errors']}")
        rows[entry["name"]] = row
        torch.cuda.empty_cache()
    log(f"adamw: done on {card}")
    return rows


def run_permute(card) -> dict:
    """Phase 19; see the module docstring. Returns {use: fields}."""
    import torch

    from training_operator_tpu_torch.trainer import bench

    rows = bench.bench_permute()
    for use, row in rows.items():
        log(f"permute: {use} {bench.PERMUTE_SHAPE} " + json.dumps(row))
    wrong = {use: row for use, row in rows.items()
             if not row.get("exact", True) or row.get("ulps", 0) > 1
             or row.get("err", 0) > row.get("plain_err", 0)}
    if wrong:
        raise AssertionError(f"permute: the kernels differ from the torch ops: {wrong}")
    torch.cuda.empty_cache()
    log(f"permute: done on {card}")
    return rows


def kernel_type(mangled: str) -> str:
    """The element type of a kernel instantiation from its mangled name:
    fp16 (`__half`) or bf16 (`__nv_bfloat16`) for the wgmma kernels, fp32
    for the fp32 sources' (which take no type parameter)."""
    return "fp16" if "6__half" in mangled else "bf16" if "nv_bfloat16" in mangled else "fp32"


def run_build() -> dict:
    """Phase 2; see the module docstring. Raises on a failed build, a
    kernel instantiation without its design's instructions or any spill;
    returns the per-source SASS counts and the build's seconds."""
    from training_operator_tpu_torch.trainer import kernels

    k = kernels.load()
    sass = kernels.sass_counts(k.libraries)
    log(f"build: {k.build_seconds:.1f} s for {len(kernels.SOURCES)} sources (one nvcc each, "
        f"in parallel); SASS " + "; ".join(
            f"{src} ({kernels.DESIGN[src]}) " + " ".join(f"{op} {n[op]}" for op in
                                                         kernels.DESIGN_SASS[kernels.DESIGN[src]])
            for src, n in sass.items()))
    for line in k.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "warning")) \
                or line.startswith("=="):
            log("  ptxas " + line.strip())
    per_kernel = kernels.kernel_sass_counts(k.libraries)
    for src, fns in per_kernel.items():
        log(f"build: {src} per kernel " + json.dumps(fns))
        need = kernels.DESIGN_SASS[kernels.DESIGN[src]]
        by_type = {}
        for f, n in fns.items():
            required = kernels.required_sass(src, f)
            if "_kernel" in f and required:
                by_type.setdefault(kernel_type(f), []).append(min(n[op] for op in required))
        log(f"build: {src} instantiations by type, each with {' and '.join(need)} "
            f"(or what kernels.KERNEL_SASS names): "
            + ", ".join(f"{t} {len(v)} (fewest {min(v)})" for t, v in sorted(by_type.items())))
    missing = kernels.missing_sass(per_kernel)
    if missing:
        raise AssertionError(f"kernels without their design's instructions: {missing}")
    spills = [line.strip() for line in k.log.splitlines()
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")
    return {"sass": sass, "seconds": k.build_seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from training_operator_tpu_torch.trainer import adamw, bench, flash, head_gemm, kernels
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
    build = run_build()

    # 3. kernels
    flagship = (8, 2048, 12, 128)
    d256_config, d256_batch, d256_seq = bench.gemma2b_config()
    d256 = (d256_batch, d256_seq, d256_config.n_heads, d256_config.head_dim)
    cases = [(flagship, True), ((2, 1000, 4, 64), True), ((2, 1000, 4, 64), False),
             (d256, True), ((2, 1000, 4, 256), False), ((4097, 32, 16, 64), True)]
    # fp16 and fp32: the flagship and d256 shapes (timed) and the odd length;
    # fp32 also D=256 not causal, ragged in dk/dv's key and q tiles.
    typed = [(flagship, True), ((2, 1000, 4, 64), True), ((2, 1000, 4, 64), False),
             (d256, True)]
    fp32_only = [((2, 1000, 4, 256), False)]
    errors = {}
    for i, (shape, causal, dtype) in enumerate(
            [(sh, c, torch.bfloat16) for sh, c in cases]
            + [(sh, c, dt) for dt in (torch.float16, torch.float32) for sh, c in typed]
            + [(sh, c, torch.float32) for sh, c in fp32_only]):
        errs = check_kernels(flash, shape, causal, seed=i, dtype=dtype)
        errors[(shape, causal, dtype)] = errs
        log(f"kernels: {list(shape)} {str(dtype).removeprefix('torch.')} (batch*heads "
            f"{shape[0] * shape[2]}) causal={causal} " + json.dumps(errs))
    timing, timing_d256 = {}, {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        timing[dtype] = bench.bench_attention(*flagship, causal=True, iters=10, dtype=dtype)
        timing_d256[dtype] = bench.bench_attention(*d256, causal=True, iters=10, dtype=dtype)
        for name, row in (*timing[dtype].items(), *timing_d256[dtype].items()):
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
        f"batch {batch} x seq {seq}, {config.dtype}, remat {config.remat_policy} + head; "
        f"step-0 loss plain attention {xla_loss:.6f} flash {flash_loss:.6f}; "
        f"gradient rel err flash vs plain, worst layer: " + json.dumps(grad_errs))
    if not max(grad_errs.values()) <= GRAD_REL_TOL:
        raise AssertionError(f"step-0 attention gradients, flash vs plain: {grad_errs} "
                             f"beyond {GRAD_REL_TOL}")

    per_step = {"flash_fwd": config.n_layers, "flash_bwd_dq": config.n_layers,
                "flash_bwd_dkv": config.n_layers}
    head_per_step = {"logits": 2, "dx": 1, "dw": 1}  # remat_head: the logits recomputed
    flash.reset_launches()
    head_gemm.reset_launches()
    adamw.reset_launches()
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    data = first
    for i in range(6):
        before, head_before = dict(flash.launches), dict(head_gemm.launches)
        adamw_before = dict(adamw.launches)
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
        head_grew = {n: head_gemm.launches[n] - head_before[n] for n in head_per_step}
        if head_grew != head_per_step:
            raise AssertionError(f"step {i}: head launches grew by {head_grew}, expected "
                                 f"{head_per_step}")
        adamw_grew = {n: adamw.launches[n] - adamw_before[n] for n in adamw.launches}
        if adamw_grew != {"sumsq": 1, "update": 1}:
            raise AssertionError(f"step {i}: clip + AdamW launches grew by {adamw_grew}, "
                                 "expected one of each pass")
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
    # paths differ by bf16 rounding of p and of the attention output. On an
    # H100 this batch's gap reads 7.6e-5 at a loss near ln(32768) = 10.4;
    # over six batches of 16,384 tokens the gap spread by 1.28e-4.
    if abs(losses[0] - xla_loss) > 1e-4:
        raise AssertionError(f"step-0 loss {losses[0]} vs plain-attention loss {xla_loss}")
    step_ms = sum(times) / len(times)
    tokens_s = batch * seq / (step_ms / 1e3)
    fps = bench.flops_per_step(config, n_matmul, batch, seq)
    mfu = fps / (step_ms / 1e3) / bench.PEAK_BF16_FLOPS["H100"]
    train_launches = dict(flash.launches)
    head_launches = dict(head_gemm.launches)
    adamw_launches = dict(adamw.launches)
    phase4 = {"step_ms": step_ms, "tokens_s": tokens_s,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"train: {step_ms:.2f} ms/step (mean of {len(times)}), {tokens_s:.1f} tokens/s, "
        f"MFU {mfu:.4f} of 989 TFLOP/s bf16, peak memory "
        f"{phase4['peak_gb']:.2f} GB, launches {train_launches}, head {head_launches} "
        f"on {card}")

    # The earlier path: one step with every layer under remat "full".
    full = dataclasses.replace(config, remat_policy="full")
    full_step = make_train_step(full, optimizer)
    flash.reset_launches()
    state, metrics = full_step(state, next(it))
    full_loss = metrics["loss"].item()
    want = {**per_step, "flash_fwd": 2 * config.n_layers}
    if dict(flash.launches) != want or not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"remat full step: launches {dict(flash.launches)}, expected "
                             f"{want}; loss {full_loss}")
    log(f"train: one step under remat full, loss {full_loss:.6f}, launches "
        f"{dict(flash.launches)}")
    del state, step_fn, full_step, first, data, metrics, it, loader
    torch.cuda.empty_cache()

    # 5. loop
    run_loop(config, batch, seq, card)

    # 6. mesh
    mesh_launches = run_mesh(config, batch, seq, card, phase4)

    # 7. dryrun, on the host CPU
    from training_operator_tpu_torch import graft_entry

    t = time.perf_counter()
    log("dryrun: graft_entry.dryrun_multichip(8), 8 gloo processes on the host CPU "
        "(CPU numbers, not the card's):")
    passes = graft_entry.dryrun_multichip(8)
    log(f"dryrun: {len(passes)} passes with parity in {time.perf_counter() - t:.1f} s "
        f"host wall (CPU): " + "; ".join(f"{p['mesh']}" for p in passes))
    if graft_entry._pass1_axes(8).get("sequence") != 2 or passes[0]["mesh"]["sequence"] != 2:
        raise AssertionError(f"dryrun pass 1 ran on {passes[0]['mesh']}, not sequence=2")
    if len(passes) != 3 or (passes[1]["mesh"]["pipeline"], passes[1]["mesh"]["expert"]) != (2, 2):
        raise AssertionError(f"dryrun ran {[p['mesh'] for p in passes]}: no pass 2 on "
                             "pipeline=2,expert=2")

    # 8. ring
    ring_launches = run_ring(card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 9. moe
    moe_launches = run_moe(card)
    torch.cuda.reset_peak_memory_stats()

    # 10. pipeline
    pipeline_launches = run_pipeline(card, phase4)
    torch.cuda.empty_cache()

    # 11. vision
    run_vision(card)

    # 12. solver
    run_solver(card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 13. d256
    d256_launches = run_d256(card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 14. fp32
    fp32_launches = run_fp32(card)

    # 15. placer
    run_placer(card)

    # 16. operator
    run_operator(card)

    # 17. head
    head = run_head(card)

    # 18. adamw
    optimizer_rows = run_adamw(card)

    # 19. permute
    permute_rows = run_permute(card)

    # report
    sass = build["sass"]
    replaces = {
        "flash_fwd": "training_operator_tpu/trainer/flash.py:89",
        "flash_bwd_dq": "training_operator_tpu/trainer/flash.py:177",
        "flash_bwd_dkv": "training_operator_tpu/trainer/flash.py:217",
    }

    def err_of(shape, dtype):
        errs = errors[(shape, True, dtype)]
        return {"flash_fwd": errs["out"], "flash_bwd_dq": errs["dq"],
                "flash_bwd_dkv": max(errs["dk"], errs["dv"])}

    def timed(name, dtype, suffix=""):
        """The timing fields of one kernel at the flagship shape and (the
        `_d256` keys) at [1, 4096, 8, 256], each key with `suffix` before
        `_d256`. dq and dk/dv have no call of their own: `library_bwd_ms`
        is SDPA's whole backward, the time of the pair (the `flash_bwd`
        timing line)."""
        out = {}
        for tail, t, shape in (("", timing[dtype][name], flagship),
                               ("_d256", timing_d256[dtype][name], d256)):
            out.update({f"{key}{suffix}{tail}": t[key] for key in
                        ("ms", "plain_ms", "bound_ms", "library_ms", "library_bwd_ms")})
            out[f"max_abs_err{suffix}{tail}"] = err_of(shape, dtype)[name]
        return out

    rows = []
    for name in per_step:
        src = f"{name}.cu"
        t = timing[torch.bfloat16][name]
        rows.append({
            "name": name,
            "route": "cuda",
            "design": kernels.DESIGN[src],
            "hgmma": sass[src]["HGMMA"],
            "utmaldg": sass[src]["UTMALDG"],
            "source": f"training_operator_tpu_torch/trainer/csrc/{src}",
            "replaces": replaces[name],
            "launches": train_launches[name],
            "launches_mesh": mesh_launches[name],
            "launches_ring": ring_launches[name],
            "launches_moe": moe_launches[name],
            "launches_pipeline": pipeline_launches[name],
            "launches_d256": d256_launches[name],
            "bound_by": t["bound_by"],
            # bf16 at both shapes; the fp16 instantiation's fields beside
            # them (`_fp16`), held to the same rules and the same bound.
            **timed(name, torch.bfloat16),
            **timed(name, torch.float16, "_fp16"),
        })
    for name in per_step:
        src = f"{name}_fp32.cu"
        rows.append({
            "name": f"{name}_fp32",
            "route": "cuda",
            "design": kernels.DESIGN[src],
            "hmma_tf32": sass[src]["HMMA.TF32"],
            "source": f"training_operator_tpu_torch/trainer/csrc/{src}",
            "replaces": replaces[name],
            "launches": fp32_launches[name],
            "bound_by": timing[torch.float32][name]["bound_by"],
            "bound_rule": timing[torch.float32][name]["bound_rule"],
            **timed(name, torch.float32),
        })
    src = "head_gemm_fp32.cu"
    for product, by_shape in head.items():
        rows.append({
            "name": f"head_{product}",
            "route": "cuda",
            "design": kernels.DESIGN[src],
            "hgmma": sass[src]["HGMMA"],
            "utmaldg": sass[src]["UTMALDG"],
            "source": f"training_operator_tpu_torch/trainer/csrc/{src}",
            "replaces": "none: the JAX head is XLA's dot (training_operator_tpu/trainer/model.py)",
            "launches": head_launches[product],
            "bound_by": "operations",
            "bound_rule": bench.FLOP_RULES[torch.float32],
            "cells": by_shape,
        })
    src = "adamw_fp32.cu"
    rows.append({
        "name": "adamw",
        "route": "cuda",
        "design": kernels.DESIGN[src],
        "ldg128": sass[src]["LDG.128"],
        "stg128": sass[src]["STG.128"],
        "source": f"training_operator_tpu_torch/trainer/csrc/{src}",
        "replaces": "none: the JAX optimizer is optax on XLA (training_operator_tpu/trainer/"
                    "train.py)",
        "launches": adamw_launches,
        "bound_by": "bytes",
        "bound_rule": f"{bench.ADAMW_BYTES} bytes a parameter at 3.35 TB/s",
        "configs": optimizer_rows,
    })
    src = "moe_permute.cu"
    rows.append({
        "name": "moe_permute",
        "route": "cuda",
        "design": kernels.DESIGN[src],
        "ldg128": sass[src]["LDG.128"],
        "stg128": sass[src]["STG.128"],
        "source": f"training_operator_tpu_torch/trainer/csrc/{src}",
        "replaces": "none: the JAX package has no dropless layer (its switch layer's one-hot "
                    "einsums, training_operator_tpu/trainer/model.py)",
        "bound_by": "bytes",
        "bound_rule": "bench.permute_bytes at 3.35 TB/s",
        "uses": permute_rows,
    })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
