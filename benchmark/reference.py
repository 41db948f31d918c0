"""The plain reference: the model family's loss (its file under
`benchmark/families/`), its gradients and clip + AdamW, in fp32 with TF32
off, in plain PyTorch.

A frozen statement of what the port's training step computes, written
from the equations and importing nothing of the port:

- the loss, as the cell's model family writes it (`family.loss`);
- clip by the global norm of the raw gradients (scaled by clip / norm when
  the norm is at or above `clip_norm`), then AdamW (b1 0.9, b2 0.999, eps
  1e-8, bias correction with the count after the increment, weight decay
  on every leaf added to the update) at a learning rate read from the
  warmup-cosine schedule at the count before the increment: optax's
  `chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))`.

`Numerics` says how it computes, from the configuration's `run` block
(`numerics`): the RMSNorm eps as run (`rms_norm_eps`), and for the control
the precision next below the one the configuration states
(`run.control`): `body` names the rounding of the operands of every
product the layers run (the weight products, and attention's q kᵀ and
p v), `head` that of the head's product, each one of `ROUNDINGS`. The
products then run in fp32 on the rounded values, as such hardware sums.
`half_batch=True` is a planted fault: the loss is the mean over the first
half of the tokens only.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark import inputs

B1, B2, EPS = 0.9, 0.999, 1e-8
# Elements AdamW treats at once, to bound its temporaries.
CHUNK = 1 << 26
FP8_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    """Operands rounded to fp8 e4m3 under a per-tensor scale; the gradient
    passes through unrounded (what an fp8 product's backward sees)."""

    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


# Roundings a configuration's `run.control` may name, each with a
# straight-through gradient.
ROUNDINGS = {"fp8_e4m3": _RoundFP8.apply, "tf32": _RoundTF32.apply}


class Numerics:
    """How the reference computes: the RMSNorm eps, and which operands it
    rounds before a product (none, unless `body` or `head` names a
    rounding)."""

    def __init__(self, eps: float, body: Optional[str] = None, head: Optional[str] = None):
        self.eps = eps
        self._body = ROUNDINGS[body] if body else None
        self._head = ROUNDINGS[head] if head else None

    def body(self, x: torch.Tensor) -> torch.Tensor:
        return self._body(x) if self._body else x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self._head(x) if self._head else x

    def rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * w


def numerics(run: dict, control: bool = False) -> Numerics:
    """The plain reference's numerics for a configuration's `run` block, or
    with `control` its control's."""
    return Numerics(run["rms_norm_eps"], **(run["control"] if control else {}))


def learning_rate(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, 0),
    decay_steps = max(total_steps, warmup + 1)."""
    peak, warmup = opt["learning_rate"], opt["warmup_steps"]
    decay = max(opt["total_steps"], warmup + 1)
    if count < warmup:
        return peak * count / warmup
    c = min(count - warmup, decay - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / (decay - warmup)))


def run_steps(family, dims: dict, opt: dict, seed: int, batches, device, prec: Numerics,
              steps: int = 3, half_batch: bool = False) -> Dict[str, object]:
    """`steps` training steps of the model `family` from the initial weights
    of `seed` on `batches` ((inputs, targets) int64 arrays), computed as
    `prec` says. Returns the readings the
    check compares: `loss` and `grad_norm` (raw, global) of every step,
    `grad_leaf` (step 1's clipped gradient, per leaf), `raw_leaf` (step 1's
    raw gradient, per leaf) and `change_leaf` (|p - p0| after the last
    step, per leaf)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = {n: inputs.initial_leaf(s, family, dims, n, seed, device).requires_grad_()
                  for n, s in family.param_shapes(dims).items()}
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        out = {"loss": [], "grad_norm": []}
        for step in range(steps):
            tokens, targets = (torch.as_tensor(a, device=device) for a in batches[step])
            value = family.loss(params, tokens, targets, dims, prec, half_batch)
            value.backward()
            grads = {n: p.grad for n, p in params.items()}
            raw = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
            g_norm = math.sqrt(sum(v * v for v in raw.values()))
            scale = opt["clip_norm"] / g_norm if g_norm >= opt["clip_norm"] else 1.0
            out["loss"].append(float(value.detach()))
            out["grad_norm"].append(g_norm)
            if step == 0:
                out["raw_leaf"] = raw
                out["grad_leaf"] = {n: v * scale for n, v in raw.items()}
            _adamw(params, grads, mu, nu, scale, step, opt)
            for p in params.values():
                p.grad = None
        out["change_leaf"] = {}
        with torch.no_grad():
            for n, p in params.items():
                p0 = inputs.initial_leaf(p.shape, family, dims, n, seed, device)
                out["change_leaf"][n] = float(torch.linalg.vector_norm(p - p0))
                del p0
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _adamw(params, grads, mu, nu, scale: float, step: int, opt: dict) -> None:
    lr = learning_rate(opt, step)
    count = step + 1
    bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
    wd = opt["weight_decay"]
    for n, p in params.items():
        flat = [t.view(-1) for t in (p, grads[n], mu[n], nu[n])]
        for i in range(0, flat[0].numel(), CHUNK):
            pp, g, m, v = (t[i:i + CHUNK] for t in flat)
            g = g * scale
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            upd = (m / bc1) / ((v / bc2).sqrt() + EPS) + wd * pp
            pp.sub_(lr * upd)

