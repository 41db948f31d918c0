"""Train step: clip-by-global-norm + AdamW with a warmup-cosine schedule.
(`SGD`, optax.sgd with momentum, is the vision family's optimizer.)

Counterpart of training_operator_tpu/trainer/train.py on one device. The
optimizer is written out by hand to match the JAX package's
`optax.chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule))`
step for step:

- the global norm is taken over the raw gradients, and gradients are scaled
  by clip/norm only when the norm is at or above `clip_norm`;
- moments mu = b1*mu + (1-b1)*g and nu = b2*nu + (1-b2)*g^2, bias-corrected
  with the count AFTER the increment; update = mu_hat / (sqrt(nu_hat) + eps);
- weight decay adds wd*param to the update of every parameter, norms and
  embedding included;
- the learning rate is the schedule read at the count BEFORE the increment,
  so the first step runs at lr 0 when the schedule starts at 0.

Where JAX donates the state to the jitted step, the port updates the
parameters and moments in place (trainer/adamw.py): on the card as two
multi-tensor passes of hand-written kernels, the norm's and the update's,
which take float32, contiguous tensors of one shape across p, g, mu and nu
and refuse any other with an error; on the CPU as a loop of torch ops
(`adamw.plain_update`), the reference the kernels are held to. Under a
profiler the step writes the share of elements the kernels updated into
the trace (the counter `train.optimizer.fused_share`).

Under a mesh (JAX `train.py:56-174`) the state holds this rank's shards
(built straight into the shards, model.init_params) and the moments are
shards of the same layout. The step sums the gradients over the batch axes
and `sequence`, and on a pipeline mesh the stage-replicated parameters'
over `pipeline` (model.reduce_gradients), takes the global norm with each
element counted once (`sequence`, like `data`, replicates every
parameter), and runs clip and AdamW
elementwise on the local shards with the same count and lr on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.observe.spans import (
    BACKWARD,
    BACKWARD_WAIT,
    FORWARD,
    OPTIMIZER,
    OPTIMIZER_FUSED_SHARE,
    STEP,
    collect_counts,
    emit_counts,
    host_count,
    span,
)
from training_operator_tpu_torch.trainer import adamw
from training_operator_tpu_torch.trainer.mesh import AXIS_ORDER
from training_operator_tpu_torch.trainer.model import (
    Transformer,
    TransformerConfig,
    init_params,
    loss_fn,
    param_placements,
    param_shapes,
    Specs,
    reduce_gradients,
    resolve_device,
    spec_axes,
    zeros_sharded,
)

@dataclass
class AdamWState:
    count: int = 0  # updates applied so far
    mu: Dict[str, torch.Tensor] = field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass
class TrainState:
    step: int
    model: Transformer
    opt_state: AdamWState

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule: linear init->peak over
    `warmup_steps`, then cosine decay to `end_value` at `decay_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """clip_by_global_norm(clip_norm) then AdamW with optax's defaults
    (b1 0.9, b2 0.999, eps 1e-8); see the module docstring."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float = 3e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 100, total_steps: int = 10_000,
                 clip_norm: float = 1.0):
        self.schedule = warmup_cosine_decay(
            0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1)
        )
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor],
               mesh: Optional[DeviceMesh] = None,
               specs: Optional[Specs] = None) -> torch.Tensor:
        """One step, in place on `params` and `state`; returns the global
        norm of the raw `grads` (local shards under a mesh, laid out by
        `specs`, the model's)."""
        g_norm = global_norm(grads, mesh, specs)
        hyper = self.advance(state)
        card = [n for n in params
                if adamw.fused(n, params[n], grads[n], state.mu[n], state.nu[n])]
        taken = set(card)
        cpu = [n for n in params if n not in taken]
        for run, names in ((adamw.update, card), (adamw.plain_update, cpu)):
            if names:
                run(*([d[n] for n in names] for d in (params, grads, state.mu, state.nu)),
                    g_norm, **hyper)
        total = sum(p.numel() for p in params.values())
        host_count(OPTIMIZER_FUSED_SHARE,
                   sum(params[n].numel() for n in card) / total if total else 0.0)
        return g_norm

    def advance(self, state: AdamWState) -> Dict[str, float]:
        """Counts a step on `state` and returns its hyper-parameters as
        `adamw.update` and `adamw.plain_update` take them: lr from the
        schedule at the count before, the bias corrections at the count
        after, rounded to fp32 as optax computes them."""
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** state.count
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** state.count
        return dict(clip_norm=self.clip_norm, lr=lr, b1=self.b1, b2=self.b2, bc1=bc1.item(),
                    bc2=bc2.item(), eps=self.eps, weight_decay=self.weight_decay)


@dataclass
class SGDState:
    trace: Dict[str, torch.Tensor] = field(default_factory=dict)  # the momentum


class SGD:
    """optax.sgd(learning_rate, momentum): the trace mu = g + momentum*mu
    from zeros (so the first step's mu is g), then update = -lr*mu; no
    dampening, no Nesterov, no weight decay. The vision family's optimizer."""

    def __init__(self, learning_rate: float = 0.1, momentum: float = 0.9):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params: Dict[str, torch.Tensor]) -> SGDState:
        return SGDState(trace={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: SGDState,
               params: Dict[str, torch.Tensor]) -> None:
        """One step, in place on `params` and `state`."""
        for name, p in params.items():
            mu = state.trace[name]
            mu.mul_(self.momentum).add_(grads[name])
            p.sub_(self.learning_rate * mu)


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   clip_norm: float = 1.0) -> AdamW:
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, clip_norm)


def global_norm(tensors: Dict[str, torch.Tensor],
                mesh: Optional[DeviceMesh] = None,
                specs: Optional[Specs] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, fp32, on their device.
    Tensors on the card have their sums from one multi-tensor pass
    (adamw.square_sums; `adamw.fused` raises for one it refuses), CPU
    tensors from torch ops. Under a mesh the tensors are the local shards,
    laid out by `specs`, of the parameters of the same names, and each
    element counts once: a shard adds its squares on the one rank at
    coordinate 0 of every axis that replicates it, then one all-reduce sums
    over the world."""
    card = [n for n in tensors if adamw.fused(n, tensors[n])]
    fused = {}
    if card:
        sums, norm = adamw.square_sums([tensors[n] for n in card])
        if mesh is None and len(card) == len(tensors):
            return norm
        fused = dict(zip(card, sums.unbind()))

    def square(name):
        return fused[name] if name in fused else tensors[name].float().square().sum()

    if mesh is None:
        return torch.sqrt(sum(square(name) for name in tensors))
    total = None
    for name, t in tensors.items():
        sharded = spec_axes(name, specs)
        owner = all(mesh.get_local_rank(a) == 0 for a in AXIS_ORDER if a not in sharded)
        sq = square(name) if owner else t.new_zeros((), dtype=torch.float32)
        total = sq if total is None else total + sq
    dist.all_reduce(total)
    return torch.sqrt(total)


def init_train_state(config: TransformerConfig, optimizer: AdamW,
                     generator: Optional[torch.Generator] = None,
                     device=None, mesh: Optional[DeviceMesh] = None) -> TrainState:
    """Params from `init_params` (generator seeded 0 by default) and zero
    moments, on the card unless `device` says otherwise. Under a mesh every
    rank draws the same parameters one at a time and keeps only its shard
    of each (the shards of the unsharded init, never the whole model); the
    moments take the same layout."""
    device = resolve_device(device)
    model = init_params(config, generator, device, mesh)
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(dict(model.named_parameters())))


def template_train_state(config: TransformerConfig, optimizer: AdamW,
                         device=None, mesh: Optional[DeviceMesh] = None) -> TrainState:
    """A zero-filled TrainState, the checkpoint-restore target: no generator
    and no init compute (a restore overwrites every value; only shapes,
    dtypes, the device and the mesh layout matter). On the card unless
    `device` says otherwise. Under a mesh only this rank's shards are
    allocated."""
    device = resolve_device(device)
    if mesh is not None:
        model = zeros_sharded(config, mesh, device)
    else:
        model = Transformer(config, device)
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(dict(model.named_parameters())))


def state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The flat state dict of a TrainState: `step` and the AdamW `count` as
    0-d int64 CPU tensors, and `params.<name>`, `mu.<name>`, `nu.<name>` for
    every parameter. The tensors are the state's own (no copies), so loading
    into this dict in place fills the state (`load_state_dict`). Under a
    mesh each shard is wrapped as a DTensor with its parameter's placements
    and global shape, so a checkpoint records the layout and a restore onto
    another mesh (or none) reshards on read."""
    out = {"step": torch.tensor(state.step, dtype=torch.int64),
           "count": torch.tensor(state.opt_state.count, dtype=torch.int64)}
    model = state.model
    full = param_shapes(model.config)
    for name, p in model.named_parameters():
        for key, t in (("params.", p.detach()), ("mu.", state.opt_state.mu[name]),
                       ("nu.", state.opt_state.nu[name])):
            if model.mesh is not None:
                t = _as_dtensor(t, model.mesh, param_placements(name, model.specs), full[name])
            out[key + name] = t
    return out


def _as_dtensor(local: torch.Tensor, mesh: DeviceMesh, placements, shape) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def load_state_dict(state: TrainState, flat: Dict[str, torch.Tensor]) -> TrainState:
    """Copies a flat state dict (as `state_dict` lays it out) into `state`,
    on the state's device and dtypes; every key must be present."""
    own = state_dict(state)
    if set(own) != set(flat):
        raise ValueError(f"state dict keys differ: missing {sorted(set(own) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(own))}")
    for key, dst in own.items():
        # A dict from `state_dict(state)` that was loaded in place already
        # holds the state's own tensors.
        dst, src = _local(dst), _local(flat[key])
        if key not in ("step", "count") and dst.data_ptr() != src.data_ptr():
            dst.copy_(src)
    state.step = int(flat["step"])
    state.opt_state.count = int(flat["count"])
    return state


def make_train_step(config: TransformerConfig, optimizer: AdamW, device=None,
                    mesh: Optional[DeviceMesh] = None):
    """Returns `step(state, batch) -> (state, metrics)`: loss, gradient,
    clip + AdamW in place. Metrics: `loss`, `grad_norm` (of the raw
    gradients) and `step`, as tensors on the device except `step`; under a
    mesh, the global loss and norm on every rank. The batch must already lie
    on the step's device (the DataLoader puts it there); under a mesh it is
    this rank's rows, and the state must be sharded on `mesh`. A pipelined
    model's backward is its schedule's (pipeline.pipeline_loss). Under a
    profiler the step, its loss, its backward and the optimizer are ranges,
    and the counters the forward computes are written into the trace at the
    step's end, after one host sync (observe/spans.py)."""
    device = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        if batch["tokens"].device.type != device.type:
            raise ValueError(f"batch on {batch['tokens'].device}, step on {device}")
        if model.mesh is not mesh:
            raise ValueError("the state's mesh is not the step's: shard the state with "
                             "init_train_state/template_train_state(..., mesh=mesh)")
        with span(STEP):
            params = dict(model.named_parameters())
            for p in params.values():
                p.grad = None
            with span(FORWARD), collect_counts() as counts:
                loss = loss_fn(model, batch, config)
            with span(BACKWARD), span(BACKWARD_WAIT):
                loss.backward()
            if mesh is not None:
                reduce_gradients(model)
            grads = {n: p.grad for n, p in params.items()}
            with span(OPTIMIZER):
                grad_norm = optimizer.update(grads, state.opt_state, params, mesh, model.specs)
            for p in params.values():
                p.grad = None
            emit_counts(counts)
            state.step += 1
            return state, {"loss": loss.detach(), "grad_norm": grad_norm, "step": state.step}

    return step


def make_example_batch(config: TransformerConfig, batch: int, seq: int,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, config.vocab_size, (batch, seq), generator=generator,
                           device=device, dtype=torch.int32)
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((batch, seq), dtype=torch.float32, device=device)
    return {"tokens": tokens, "targets": targets, "mask": mask}
