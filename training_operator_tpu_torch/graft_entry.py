"""Graft entry points of the port.

Counterpart of the repo's `__graft_entry__.py`: `entry()`, the forward and
loss of the tiny decoder as a function and its example arguments, and
`dryrun_multichip(n)`, the full sharded train step run once on n-process
meshes, each pass held to the single-process loss of the same parameters
and batch (`_run_gate_pass`, the JAX gate). The n processes are CPU
processes over gloo on this host (distributed.spawn): the gate checks the
sharded math, not a card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import torch

from training_operator_tpu_torch.trainer import distributed
from training_operator_tpu_torch.trainer.mesh import (
    MeshSpec,
    build_mesh,
    mesh_from_env,
    mesh_shape,
    shard_batch,
)
from training_operator_tpu_torch.trainer.model import (
    TransformerConfig,
    init_params,
    loss_fn,
    resolve_device,
)
from training_operator_tpu_torch.trainer.train import (
    init_train_state,
    make_example_batch,
    make_optimizer,
    make_train_step,
)


def _tiny_config(vocab: int = 256, seq: int = 128) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, d_model=128, n_layers=2, n_heads=8,
                             n_kv_heads=8, d_ff=256, max_seq_len=seq)


def entry(device=None):
    """(fn, (model, batch)): `fn(model, batch)` is the tiny config's forward
    and mean cross-entropy, with parameters and a batch of 4 x 128 tokens
    made from seed 0, on the card unless `device` says otherwise."""
    device = resolve_device(device)
    config = _tiny_config()
    model = init_params(config, torch.Generator(device=device).manual_seed(0), device)
    batch = make_example_batch(config, batch=4, seq=128, device=device)

    def fn(model, batch):
        return loss_fn(model, batch, config)

    return fn, (model, batch)


def _run_gate_pass(label: str, config: TransformerConfig, mesh, seed: int,
                   batch_size: int = 4, seq: int = 128, rtol: float = 5e-3) -> Dict:
    """One dry-run pass in every rank of a CPU world: the full sharded train
    step on `mesh`, whose loss must match the same parameters and batch
    evaluated unsharded in this process (rtol 5e-3, the JAX gate): a missing
    sum or a shard counted twice fails it, where `loss > 0` would not."""
    cpu = torch.device("cpu")
    optimizer = make_optimizer(total_steps=10)
    batch = make_example_batch(config, batch=batch_size, seq=seq,
                               generator=torch.Generator().manual_seed(seed), device=cpu)
    with torch.no_grad():
        full = init_params(config, torch.Generator().manual_seed(seed), cpu)
        ref_loss = loss_fn(full, batch, config).item()
    del full
    state = init_train_state(config, optimizer, torch.Generator().manual_seed(seed), cpu, mesh)
    step = make_train_step(config, optimizer, device=cpu, mesh=mesh)
    state, metrics = step(state, shard_batch(batch, mesh, config.pipeline_microbatches))
    loss = metrics["loss"].item()
    if not (loss == loss and loss > 0 and ref_loss == ref_loss and ref_loss > 0):
        raise AssertionError(f"{label}: bad loss {loss} or reference loss {ref_loss}")
    if abs(loss - ref_loss) > rtol * abs(ref_loss):
        raise AssertionError(
            f"{label}: sharded loss {loss:.6f} != single-process loss {ref_loss:.6f} "
            f"(rtol {rtol}): the mesh compute is WRONG, not just slow")
    return {"label": label, "mesh": mesh_shape(mesh), "loss": loss, "ref_loss": ref_loss}


def _pass1_axes(n: int) -> Dict[str, int]:
    """The JAX pass 1 factorization of n over (tensor, sequence, fsdp,
    data): a factor of 2 for each of the first three while n divides, the
    rest on data."""
    axes: Dict[str, int] = {}
    for name in ("tensor", "sequence", "fsdp", "data"):
        if n % 2 == 0 and name != "data":
            axes[name] = 2
            n //= 2
        elif n > 1 and name == "data":
            axes[name] = n
            n = 1
    return axes


def _dryrun_rank(n: int) -> List[Dict]:
    """The dry-run passes, in one rank of an n-process world."""
    passes = [_run_gate_pass(f"dryrun_multichip({n})", _tiny_config(seq=128),
                             build_mesh(MeshSpec(_pass1_axes(n)), "cpu"), seed=0)]
    if n % 8 == 0:
        # Pass 2: a 2-stage GPipe pipeline x the expert-parallel switch MoE x
        # tensor parallelism, the JAX pass's config (seed 1).
        config2 = dataclasses.replace(_tiny_config(seq=128), n_experts=2,
                                      pipeline_microbatches=2)
        mesh2 = build_mesh(MeshSpec({"pipeline": 2, "expert": 2, "tensor": 2}), "cpu")
        passes.append(_run_gate_pass(f"dryrun_multichip({n}) pp/ep", config2, mesh2, seed=1))
        # Pass 3, multi-slice data parallelism from the operator's
        # multi-slice env: `data` spans the slices, fsdp/tensor stay inside.
        ms_env = {"TPU_NUM_SLICES": "2", "TPU_MESH_AXES": "data=2,fsdp=2,tensor=2",
                  "MEGASCALE_NUM_SLICES": "2"}
        saved = {k: os.environ.get(k) for k in ms_env}
        os.environ.update(ms_env)
        try:
            mesh3 = mesh_from_env("cpu")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if mesh_shape(mesh3)["data"] != 2:
            raise AssertionError(f"multi-slice mesh {mesh_shape(mesh3)}: data is not 2")
        passes.append(_run_gate_pass(f"dryrun_multichip({n}) multi-slice dp",
                                     _tiny_config(seq=128), mesh3, seed=2))
    return passes


def dryrun_multichip(n_devices: int) -> List[Dict]:
    """The full sharded train step, once, on n-process meshes of gloo CPU
    processes: pass 1 (tensor/sequence/fsdp/data, the ring over gloo) and,
    when n divides by 8, pass 2 (pipeline=2 x expert=2 x tensor=2: the
    GPipe schedule over gloo with the expert-parallel switch MoE) and pass 3
    (multi-slice dp from TPU_MESH_AXES=data=2,fsdp=2,tensor=2). Each pass's
    loss must match the single-process loss (rtol 5e-3; for pass 2 the
    unpipelined loss, whose MoE capacity counts the whole batch where the
    pipeline's counts each microbatch); any failure raises. Prints one line
    per pass and returns rank 0's results."""
    passes = distributed.spawn(_dryrun_rank, n_devices, (n_devices,))[0]
    for p in passes:
        print(f"{p['label']}: mesh={p['mesh']} loss={p['loss']:.4f} "
              f"(parity ok, ref {p['ref_loss']:.4f})")
    return passes
