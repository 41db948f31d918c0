"""Pipeline parallelism: a GPipe schedule over the mesh's `pipeline` axis.

Counterpart of training_operator_tpu/trainer/pipeline.py (`pipeline_apply`,
:44-132). The behaviour kept:

- P stages, each holding L/P consecutive layers; `m =
  pipeline_microbatches or P` microbatches, microbatch j being rows
  j*mb .. (j+1)*mb - 1 of the global batch (on a mesh each batch rank holds
  its block of every microbatch, mesh.batch_rows, so its local microbatch j
  is its j-th run of rows);
- stage 0 embeds, every stage runs its layers on each microbatch in turn,
  the last stage runs the final norm, the head and the loss (on all its
  microbatches at once, as JAX applies the head after the schedule);
- the MoE aux loss summed over the microbatches and every stage's layers,
  then divided by m * n_layers (:127-128), so each microbatch routes with
  its own capacity (T = mb * S), as the JAX stages do;
- the refusals: n_layers not divisible by P (when the model is sharded or
  given to `loopback`), a batch not divisible by m (here and in
  mesh.batch_rows), `sequence` > 1 (mesh.build_mesh);
- the loss is the same on every rank.

Where JAX writes the schedule as one SPMD program (a rolled buffer, the
backward by AD), the port runs it in each process: stage p receives each
microbatch's activations from stage p - 1, runs its layers and sends the
result to stage p + 1; the backward receives each microbatch's output
gradient from stage p + 1 and sends its input gradient to stage p - 1.
Every hand-off is matched by call order (NCCL's point-to-point rule), so
both passes go over the microbatches in one fixed order, and the backward
is driven by the schedule, one microbatch at a time, not by the autograd
engine: `pipeline_loss` is an autograd function whose backward runs it.
The global masked mean's denominator (the all-reduced mask sum) is known
before the backward, so the per-microbatch terms add up exactly.

The stages' layers run through the port's own layer body and attention
dispatcher (the flash kernels on the card), where the JAX stage body pins
its XLA attention (:88).

The hand-off has two transports: the process group (`GroupStages`, one
stage per rank, send/recv over the `pipeline` group) and a loopback
(`LoopbackStages`) that runs the P stages one after another in one process,
what a single card can run of a pipeline. The schedule code is the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.trainer.mesh import axis_size
from training_operator_tpu_torch.trainer.model import (
    Transformer,
    TransformerConfig,
    embed_tokens,
    final_nll,
    layer_body,
    layer_params,
    masked_sums,
    run_layers,
    unbind_layers,
)


class GroupStages:
    """The stages over a process group: this rank runs the stage at its
    `pipeline` coordinate and hands activations and gradients to its
    neighbours with send/recv over the `pipeline` group."""

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("pipeline")
        self.size = axis_size(mesh, "pipeline")
        me = mesh.get_local_rank("pipeline")
        self.stages = (me,)
        self._ranks = {p: dist.get_global_rank(self.group, p)
                       for p in (me - 1, me + 1) if 0 <= p < self.size}

    def send(self, t: torch.Tensor, stage: int, to: int, j: int) -> None:
        dist.send(t.contiguous(), self._ranks[to], group=self.group)

    def recv(self, like: torch.Tensor, stage: int, frm: int, j: int) -> torch.Tensor:
        out = torch.empty_like(like)
        dist.recv(out, self._ranks[frm], group=self.group)
        return out

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the stages of a value each rank holds for its own."""
        dist.all_reduce(t, group=self.group)
        return t


class LoopbackStages:
    """The P stages in one process, run one after another: a hand-off is
    kept until the receiving stage takes it."""

    def __init__(self, n_stages: int):
        self.size = n_stages
        self.stages = tuple(range(n_stages))
        self._box: Dict[tuple, torch.Tensor] = {}

    def send(self, t: torch.Tensor, stage: int, to: int, j: int) -> None:
        self._box[(stage, to, j)] = t

    def recv(self, like: torch.Tensor, stage: int, frm: int, j: int) -> torch.Tensor:
        return self._box.pop((frm, stage, j))

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return t


def loopback(model: Transformer, n_stages: int) -> Transformer:
    """Runs an unsharded model's loss as an `n_stages`-stage pipeline in this
    process (LoopbackStages)."""
    if model.mesh is not None or model.stages is not None:
        raise ValueError("the loopback pipeline takes an unsharded model")
    if model.config.unsharded_only:
        raise ValueError("the dropless MoE layer and qk-norm run unsharded only")
    if model.config.n_layers % n_stages:
        raise ValueError(f"n_layers={model.config.n_layers} not divisible by "
                         f"pipeline={n_stages}")
    model.stages = LoopbackStages(n_stages)
    return model


class _Run:
    """One pass of the schedule over this process's stages: the forward
    keeps what each stage's backward needs, the backward runs the stages in
    reverse, each over the microbatches in the forward's order."""

    def __init__(self, model: Transformer, batch: Dict[str, torch.Tensor],
                 config: TransformerConfig):
        c = config
        self.model, self.config, self.transport = model, c, model.stages
        self.m = c.pipeline_microbatches or self.transport.size
        b = batch["tokens"].shape[0]
        if b % self.m:
            raise ValueError(f"batch {b} not divisible by microbatches {self.m}")
        self.batch = batch

    def _leaves(self, grad: bool) -> None:
        """The parameters as this run's leaves (detached views, requiring
        grad when the backward will run): per local stage its layers' stacks,
        and the embedding, final norm and head."""
        model, local = self.model, len(self.transport.stages)

        def leaf(t):
            t = t.detach()
            return t.requires_grad_() if grad else t

        stacks = {n: getattr(model.layers, n) for n in layer_params(self.config)}
        self.stage_stacks = [{n: leaf(t.chunk(local, 0)[i]) for n, t in stacks.items()}
                             for i in range(local)]
        self.top = {n: leaf(getattr(model, n)) for n in ("embed", "ln_f", "lm_head")}

    def forward(self, grad: bool) -> torch.Tensor:
        c, tr, model = self.config, self.transport, self.model
        mesh, m, P = model.mesh, self.m, tr.size
        tokens, targets = self.batch["tokens"], self.batch["targets"]
        b, s = tokens.shape
        mb = b // m
        self._leaves(grad)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(mb, s)
        body = layer_body(c, positions, mesh)
        like = torch.empty((mb, s, c.d_model), dtype=c.dtype, device=tokens.device)
        self.kept: List[List[tuple]] = []
        aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        loss = aux_total.clone()
        for i, stage in enumerate(tr.stages):
            layers = unbind_layers(self.stage_stacks[i])
            if stage == 0:
                self.embedded = embed_tokens(self.top["embed"], tokens, c, mesh)
                inputs = self.embedded.detach().chunk(m, 0)
            kept = []
            for j in range(m):
                x = inputs[j] if stage == 0 else tr.recv(like, stage, stage - 1, j)
                if grad:
                    x = x.detach().requires_grad_()
                y, aux = run_layers(x, layers, body)
                if stage < P - 1:
                    tr.send(y.detach(), stage, stage + 1, j)
                if aux is not None:
                    aux_total = aux_total + aux.detach()
                kept.append((x, y, aux) if grad else (None, y, None))
            self.kept.append(kept)
            if stage == P - 1:
                ys = [y.detach().requires_grad_() if grad else y for _, y, _ in kept]
                nll = final_nll(torch.cat(ys), self.top["ln_f"], self.top["lm_head"],
                                targets, c, mesh)
                total, count = masked_sums(nll, self.batch.get("mask"), mesh)
                self.ce, self.outputs = total / torch.clamp(count, min=1.0), ys
                loss = loss + self.ce.detach()
        if c.n_experts > 0:
            loss = loss + c.router_aux_coef * aux_total / (m * c.n_layers)
        return tr.total(loss)

    def backward(self, g: torch.Tensor) -> List[torch.Tensor]:
        """The schedule's backward for the loss's gradient `g`; returns the
        gradient of every model parameter, in `named_parameters` order
        (zeros for one no local stage uses)."""
        c, tr, P, m = self.config, self.transport, self.transport.size, self.m
        aux_grad = g * c.router_aux_coef / (m * c.n_layers)
        for i in reversed(range(len(tr.stages))):
            stage, stacks = tr.stages[i], self.stage_stacks[i]
            if stage == P - 1:
                torch.autograd.backward(self.ce, g, inputs=[self.top["ln_f"],
                                                             self.top["lm_head"], *self.outputs])
                douts = [y.grad for y in self.outputs]
            for j, (x, y, aux) in enumerate(self.kept[i]):
                dy = douts[j] if stage == P - 1 else tr.recv(y, stage, stage + 1, j)
                outs, grads = [y], [dy]
                if aux is not None:
                    outs.append(aux)
                    grads.append(aux_grad)
                torch.autograd.backward(outs, grads, inputs=[x, *stacks.values()])
                if stage > 0:
                    tr.send(x.grad, stage, stage - 1, j)
            if stage == 0:
                dx = torch.cat([x.grad for x, _, _ in self.kept[i]])
                torch.autograd.backward(self.embedded, dx, inputs=[self.top["embed"]])
        out = []
        for name, p in self.model.named_parameters():
            if name.startswith("layers."):
                parts = [st[name.split(".")[1]].grad for st in self.stage_stacks]
                g_p = parts[0] if len(parts) == 1 else torch.cat(parts)
            else:
                g_p = self.top[name].grad
            out.append(torch.zeros_like(p) if g_p is None else g_p)
        self.kept = self.outputs = self.embedded = self.ce = None
        return out


class _Schedule(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Run, *params):
        ctx.run = run
        with torch.enable_grad():
            return run.forward(grad=True)

    @staticmethod
    def backward(ctx, g):
        run, ctx.run = ctx.run, None
        return (None, *run.backward(g))


def pipeline_loss(model: Transformer, batch: Dict[str, torch.Tensor],
                  config: Optional[TransformerConfig] = None) -> torch.Tensor:
    """The loss of a pipelined model (`model.stages`) on this rank's batch,
    the same on every rank; its backward runs the schedule's (module
    docstring) and gives each parameter its gradient on this rank."""
    run = _Run(model, batch, config or model.config)
    if not torch.is_grad_enabled():
        return run.forward(grad=False)
    return _Schedule.apply(run, *model.parameters())
