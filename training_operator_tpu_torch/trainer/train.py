"""Train step: clip-by-global-norm + AdamW with a warmup-cosine schedule.

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
parameters and moments in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from training_operator_tpu_torch.trainer.model import (
    Transformer,
    TransformerConfig,
    init_params,
    loss_fn,
    resolve_device,
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
               params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step, in place on `params` and `state`; returns the global
        norm of the raw `grads`."""
        g_norm = global_norm(grads)
        clip = g_norm >= self.clip_norm
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** state.count
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** state.count
        for name, p in params.items():
            g = grads[name]
            g = torch.where(clip, g / g_norm * self.clip_norm, g)
            mu, nu = state.mu[name], state.nu[name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / bc1.item()) / ((nu / bc2.item()).sqrt_() + self.eps)
            upd.add_(p, alpha=self.weight_decay)
            p.add_(upd, alpha=-lr)
        return g_norm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 100, total_steps: int = 10_000,
                   clip_norm: float = 1.0) -> AdamW:
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps, clip_norm)


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, fp32, on their device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors.values()))


def init_train_state(config: TransformerConfig, optimizer: AdamW,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Params from `init_params` (generator seeded 0 by default) and zero
    moments, on the card unless `device` says otherwise."""
    device = resolve_device(device)
    model = init_params(config, generator, device)
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(dict(model.named_parameters())))


def make_train_step(config: TransformerConfig, optimizer: AdamW, device=None):
    """Returns `step(state, batch) -> (state, metrics)`: loss, gradient,
    clip + AdamW in place. Metrics: `loss`, `grad_norm` (of the raw
    gradients) and `step`, as tensors on the device except `step`. The batch
    must already lie on the step's device (the DataLoader puts it there)."""
    device = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model
        if batch["tokens"].device.type != device.type:
            raise ValueError(f"batch on {batch['tokens'].device}, step on {device}")
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        grad_norm = optimizer.update(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None
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
