"""Rank bodies for the port's multi-process tests (test_torch_mesh.py,
test_torch_seq.py, test_torch_moe.py, test_torch_pipeline.py,
test_torch_vision.py).

Each function runs in every rank of a gloo CPU world started by
`training_operator_tpu_torch.trainer.distributed.spawn`, which imports this
module by name in fresh processes: so it imports torch and the port only,
never JAX, and takes and returns numpy arrays.
"""

import dataclasses
from typing import Dict, List

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from training_operator_tpu_torch.trainer import attention as pt_attention

from training_operator_tpu_torch.trainer.checkpoint import Checkpointer, restore_into_mesh
from training_operator_tpu_torch.trainer.convert import load_jax_params, vision_params_from_jax
from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
from training_operator_tpu_torch.trainer.mesh import (
    MeshSpec,
    batch_coordinate,
    build_mesh,
    sequence_coordinate,
    shard_batch,
)
from training_operator_tpu_torch.trainer.collectives import all_gather
from training_operator_tpu_torch.trainer.model import (
    Transformer,
    TransformerConfig,
    init_params,
    local_shard,
    loss_fn,
    param_shapes,
    reduce_gradients,
    shard_model,
)
from training_operator_tpu_torch.trainer.moe import moe_mlp, route
from training_operator_tpu_torch.trainer.vision import (
    local_rows,
    make_vision_train_step,
    vision_loss_fn,
)
from training_operator_tpu_torch.trainer.train import (
    SGD,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
    template_train_state,
)


def optimizer():
    # warmup_steps=1: step 1 runs at lr 0, steps 2-3 at the peak, so the
    # parameters really move (as in JAX's re-mesh test).
    return make_optimizer(warmup_steps=1, total_steps=50)


def sharded_state(config: TransformerConfig, params: Dict, mesh) -> TrainState:
    """The JAX parameter tree (numpy leaves), sharded on `mesh` (or not,
    without one), with zero moments."""
    model = load_jax_params(Transformer(config, "cpu"), params)
    if mesh is not None:
        shard_model(model, mesh)
    return TrainState(step=0, model=model,
                      opt_state=optimizer().init(dict(model.named_parameters())))


def gather_shard(name: str, local: torch.Tensor, mesh, specs) -> torch.Tensor:
    """The whole of parameter `name` (or of a moment laid out like it) from
    every rank's shard laid out by `specs`: the inverse of
    model.local_shard, collective."""
    out = local
    for dim, axes in enumerate(specs[name]):
        for axis in reversed(axes):  # the minor axis first
            out = all_gather(out, mesh, axis, dim)
    return out.clone(memory_format=torch.contiguous_format)


def gathered(state: TrainState) -> Dict[str, np.ndarray]:
    """Every parameter and moment, whole (a collective under a mesh), as
    copies."""
    mesh = state.model.mesh
    out = {}
    for name, p in state.model.named_parameters():
        for kind, t in (("params", p.detach()), ("mu", state.opt_state.mu[name]),
                        ("nu", state.opt_state.nu[name])):
            out[f"{kind}.{name}"] = (t.clone() if mesh is None else gather_shard(
                name, t, mesh, state.model.specs)).numpy()
    return out


def train(state: TrainState, config: TransformerConfig, batches: List[Dict]) -> List:
    """(loss, grad_norm) of one step on each numpy batch (the global batch;
    this rank takes its rows)."""
    mesh = state.model.mesh
    step = make_train_step(config, optimizer(), device="cpu", mesh=mesh)
    out = []
    for b in batches:
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        if mesh is not None:
            b = shard_batch(b, mesh, config.pipeline_microbatches)
        state, m = step(state, b)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def world(axes: Dict[str, int], configs: Dict[str, TransformerConfig], params: Dict,
          batches: List[Dict], mask_batch: Dict, rows: np.ndarray, ckpt_dir: str) -> Dict:
    """Everything the tests read from one world on `axes`:

    - `coords` (this rank's mesh coordinate) and `shards` (its local shard
      of every parameter, straight after shard_model);
    - per config: `steps` (loss and grad norm of each batch) and, on rank 0,
      `state` (every parameter and moment after them, gathered);
    - `mask_loss`: the loss of `mask_batch`, whose mask zeroes a different
      number of positions in each rank's rows;
    - `loader`: the tokens of this rank's first two batches of a
      DataLoader(batch_size=len(batches[0]["tokens"]), mesh) on the native
      gather, and
      `refusals`;
    - `ckpt_calls`: checkpoint_calls on the state after the steps of
      configs["plain"], in `ckpt_dir`-calls;
    - that state saved to `ckpt_dir`,
      its `saved` gathered state (rank 0) and `next` loss of one more step
      on batches[0].
    """
    mesh = build_mesh(MeshSpec(axes), "cpu")
    rank0 = torch.distributed.get_rank() == 0
    out: Dict = {"coords": {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}}
    state = sharded_state(configs["plain"], params, mesh)
    out["shards"] = {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    for name, config in configs.items():
        state = sharded_state(config, params, mesh)
        out[name] = {"steps": train(state, config, batches)}
        full = gathered(state)
        if rank0:
            out[name]["state"] = full
        if name == "plain":
            out["ckpt_calls"] = checkpoint_calls(state, ckpt_dir + "-calls")
            Checkpointer(ckpt_dir).save(state)
            out["saved"] = full if rank0 else None
            out["next"] = train(state, config, batches[:1])[0][0]
    model = sharded_state(configs["plain"], params, mesh).model
    with torch.no_grad():
        b = shard_batch({k: torch.from_numpy(v) for k, v in mask_batch.items()}, mesh)
        out["mask_loss"] = loss_fn(model, b).item()
    batch_size = len(batches[0]["tokens"])
    loader = DataLoader(TokenDataset(rows), batch_size, device="cpu", mesh=mesh,
                        use_native=True)
    out["loader"] = [b["tokens"].numpy() for _, b in zip(range(2), loader)]
    out["refusals"] = refusals(configs["plain"], mesh, rows)
    out["init"] = init_footprint(configs["plain"], mesh)
    return out


class PeakBytes(TorchDispatchMode):
    """The most bytes of CPU storage that the ops run under it held alive
    at once (storages made by those ops; each counted once, until freed)."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, tuple] = {}
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.live = {k: v for k, v in self.live.items() if not v[0].expired()}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                st = t.untyped_storage()
                if st.nbytes() and st.data_ptr() not in self.live:
                    self.live[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        self.peak = max(self.peak, sum(n for _, n in self.live.values()))
        return out


def init_footprint(config: TransformerConfig, mesh) -> Dict:
    """The peak bytes of init_train_state and of template_train_state on
    `mesh`, beside the bytes of this rank's parameter shards and of the
    largest whole parameter; and whether the sharded init equals the shards
    of the unsharded init on the same generator."""
    out = {}
    for name, make in (("init", lambda: init_train_state(
                            config, optimizer(), torch.Generator().manual_seed(0), "cpu", mesh)),
                       ("template", lambda: template_train_state(config, optimizer(), "cpu",
                                                                 mesh))):
        with PeakBytes() as counter:
            state = make()
        out[name] = counter.peak
    out["shards"] = sum(p.numel() * 4 for p in state.model.parameters())
    out["largest"] = max(int(np.prod(s)) * 4 for s in param_shapes(config).values())
    state = init_train_state(config, optimizer(), torch.Generator().manual_seed(0), "cpu", mesh)
    full = init_params(config, torch.Generator().manual_seed(0), "cpu")
    out["equal"] = all(torch.equal(p, local_shard(n, full.get_parameter(n), mesh,
                                                  state.model.specs))
                       for n, p in state.model.named_parameters())
    return out


# (step, force) of save calls that take every decision: the first save, an
# off-interval save declined, an interval save, a declined overwrite put
# back, a forced overwrite, retention deleting the oldest steps.
CKPT_CALLS = ((1, False), (2, False), (3, False), (2, True), (4, False), (4, False),
              (4, True), (6, False))


def checkpoint_calls(state: TrainState, directory: str) -> List:
    """What each CKPT_CALLS save returns and the steps known after it, with
    max_to_keep=2 and save_interval_steps=2."""
    ckpt = Checkpointer(directory, max_to_keep=2, save_interval_steps=2)
    return [(ckpt.save(state, step=step, force=force), ckpt.all_steps())
            for step, force in CKPT_CALLS]


def refusals(config: TransformerConfig, mesh, rows: np.ndarray) -> Dict[str, str]:
    """The messages of what the mesh refuses: heads that do not split over
    tensor, a loader that keeps a tail batch or whose batch does not split,
    a batch that does not split."""
    cases = {
        "heads": lambda: shard_model(
            Transformer(dataclasses.replace(config, n_kv_heads=1), "cpu"), mesh),
        "drop_last": lambda: DataLoader(TokenDataset(rows), 4, drop_last=False,
                                        device="cpu", mesh=mesh),
        "loader_batch": lambda: DataLoader(TokenDataset(rows), 3, device="cpu", mesh=mesh),
        "batch": lambda: shard_batch({"tokens": torch.zeros(3, 4)}, mesh),
    }
    out = {}
    for name, make in cases.items():
        try:
            make()
        except ValueError as e:
            out[name] = str(e)
    return out


def restore(axes, config: TransformerConfig, ckpt_dir: str, batch: Dict) -> Dict:
    """The checkpoint restored onto a mesh on `axes` (or unsharded, for
    None): the gathered state (rank 0) and the loss of one step on `batch`."""
    mesh = build_mesh(MeshSpec(axes), "cpu") if axes is not None else None
    state = restore_into_mesh(ckpt_dir, config, optimizer(), mesh, device="cpu")
    full = gathered(state)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    out = {"state": full if rank0 else None, "step": state.step,
           "count": state.opt_state.count}
    out["loss"] = train(state, config, [batch])[0][0]
    return out


def fail_on_rank(rank: int) -> None:
    """Raises on `rank`; every other rank waits in a barrier for it."""
    if torch.distributed.get_rank() == rank:
        raise RuntimeError("this rank fails")
    torch.distributed.barrier()


# ----------------------------------------------------------------------
# Sequence parallelism (test_torch_seq.py)
# ----------------------------------------------------------------------

def attention_inputs(seed: int, shape) -> List[np.ndarray]:
    """q, k, v and an output cotangent of `shape`, fp32."""
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def block_slices(mesh, shape) -> tuple:
    """This rank's block of a global [B, S, H, D] attention input: rows by
    the batch coordinate, positions by `sequence`, heads by `tensor`."""
    out = []
    for dim, (index, count) in enumerate((batch_coordinate(mesh), sequence_coordinate(mesh),
                                          (mesh.get_local_rank("tensor"),
                                           mesh.size(mesh.mesh_dim_names.index("tensor"))))):
        n = shape[dim] // count
        out.append(slice(index * n, (index + 1) * n))
    return tuple(out)


def attention_case(axes, shape, impl: str, causal: bool, seed: int) -> Dict:
    """`attention(..., mesh)` on this rank's blocks of attention_inputs:
    its block slices, output and gradients (numpy)."""
    mesh = build_mesh(MeshSpec(axes), "cpu")
    q, k, v, do = attention_inputs(seed, shape)
    where = block_slices(mesh, shape)
    local = [torch.from_numpy(x[where].copy()).requires_grad_() for x in (q, k, v)]
    out = pt_attention.attention(*local, causal=causal, impl=impl, mesh=mesh)
    grads = torch.autograd.grad(out, local, torch.from_numpy(do[where].copy()))
    return {"where": where, "out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def counted(module, name: str, calls: List) -> None:
    """Replaces module.name by a wrapper that appends to `calls`."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)


def seq_world(cases: Dict, configs: Dict[str, TransformerConfig], params: Dict,
              batches: List[Dict], rows: np.ndarray, ckpt_dir: str) -> Dict:
    """Everything test_torch_seq.py reads from one world of 4 ranks:

    - `attn`: attention_case for each entry of `cases`;
    - `heads`: the message of Ulysses on heads that do not split;
    - per config (on sequence=2,fsdp=2): `steps` and, on rank 0, `state`
      after the batches;
    - `remat`: per backend and remat policy, the attention forwards run in
      one step (the ring's per-rank body, or Ulysses' inner plain op) and
      that step's loss and grad norm;
    - `loader`: this rank's first two batches of a DataLoader on `rows`
      (batch_size=len(batches[0]["tokens"])) on sequence=2,fsdp=2, and
      `odd_sequence`: shard_batch's message for 15 positions;
    - `saved`, `next`: the ring state after the batches, saved to
      `ckpt_dir`, gathered (rank 0), and the loss of one more step; then
      `fsdp4`: `restore` of that checkpoint onto fsdp=4 in the same world.
    """
    rank0 = torch.distributed.get_rank() == 0
    out: Dict = {"attn": {name: attention_case(*case) for name, case in cases.items()}}
    mesh = build_mesh(MeshSpec({"sequence": 2, "tensor": 2}), "cpu")
    q = torch.zeros(1, 16, 1, 16)  # 2 heads over tensor=2 leave 1, which sequence=2 cannot split
    try:
        pt_attention.attention(q, q, q, impl="ulysses", mesh=mesh)
    except ValueError as e:
        out["heads"] = str(e)
    mesh = build_mesh(MeshSpec({"sequence": 2, "fsdp": 2}), "cpu")
    loader = DataLoader(TokenDataset(rows), len(batches[0]["tokens"]), device="cpu", mesh=mesh,
                        use_native=True)
    out["loader"] = [{k: t.numpy() for k, t in b.items()} for _, b in zip(range(2), loader)]
    try:
        shard_batch({"tokens": torch.zeros(4, 15)}, mesh)
    except ValueError as e:
        out["odd_sequence"] = str(e)
    for name, config in configs.items():
        state = sharded_state(config, params, mesh)
        out[name] = {"steps": train(state, config, batches)}
        full = gathered(state)
        if rank0:
            out[name]["state"] = full
        if name == "ring":
            Checkpointer(ckpt_dir).save(state)
            out["saved"] = full if rank0 else None
            out["next"] = train(state, config, batches[:1])[0][0]
    out["remat"] = {}
    for impl, fn in (("ring", "ring_forward"), ("ulysses", "plain_attention_fwd")):
        calls: List = []
        original = getattr(pt_attention, fn)
        counted(pt_attention, fn, calls)
        try:
            for policy in ("none", "full", "save_attn", "save_attn_qkv"):
                config = dataclasses.replace(configs[impl], remat=policy != "none",
                                             remat_policy="full" if policy == "none" else policy)
                state = sharded_state(config, params, mesh)
                calls.clear()
                step = train(state, config, batches[:1])[0]
                out["remat"][(impl, policy)] = (len(calls), step)
        finally:
            setattr(pt_attention, fn, original)
    out["fsdp4"] = restore({"fsdp": 4}, configs["ring"], ckpt_dir, batches[0])
    return out


# ----------------------------------------------------------------------
# Expert parallelism (test_torch_moe.py) and the pipeline
# (test_torch_pipeline.py)
# ----------------------------------------------------------------------

def steps_case(axes, config: TransformerConfig, params: Dict, batches: List[Dict],
               ckpt_dir=None) -> Dict:
    """One step on each batch on a mesh on `axes`, from `params`: `steps`
    (loss, grad norm) and, on rank 0, `state` (every parameter and moment
    after them, gathered). With `ckpt_dir` the state is saved there."""
    mesh = build_mesh(MeshSpec(axes), "cpu")
    state = sharded_state(config, params, mesh)
    out = {"steps": train(state, config, batches)}
    full = gathered(state)
    out["state"] = full if torch.distributed.get_rank() == 0 else None
    if ckpt_dir is not None:
        Checkpointer(ckpt_dir).save(state)
    return out


def loss_and_grads(axes, config: TransformerConfig, params: Dict, batch: Dict) -> Dict:
    """The loss of `batch` and every parameter's gradient (summed over the
    mesh as the train step sums it, then gathered whole; rank 0), from
    `params` on a mesh on `axes` (unsharded for None)."""
    mesh = build_mesh(MeshSpec(axes), "cpu") if axes is not None else None
    model = sharded_state(config, params, mesh).model
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        b = shard_batch(b, mesh, config.pipeline_microbatches)
    loss = loss_fn(model, b)
    loss.backward()
    if mesh is not None:
        reduce_gradients(model)
    grads = {n: (p.grad if mesh is None else gather_shard(n, p.grad, mesh, model.specs)).numpy()
             for n, p in model.named_parameters()}
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    return {"loss": loss.item(), "grads": grads if rank0 else None}


def moe_layer_case(axes, config: TransformerConfig, h: np.ndarray, lp: Dict) -> Dict:
    """moe_mlp on this rank's rows of the global hidden states h [B, S, D]
    (and positions, on `sequence`), with its experts of the layer weights
    `lp` (router [D, E], w1/w3 [E, D, F], w2 [E, F, D]): its `where` (row and
    position slices), `out`, `keep` and `aux`."""
    mesh = build_mesh(MeshSpec(axes), "cpu")
    b_index, b_count = batch_coordinate(mesh)
    s_index, s_count = sequence_coordinate(mesh)
    rows, pos = h.shape[0] // b_count, h.shape[1] // s_count
    where = (slice(b_index * rows, (b_index + 1) * rows),
             slice(s_index * pos, (s_index + 1) * pos))
    x = torch.from_numpy(h[where].copy()).to(config.dtype)
    n, e = mesh.size(mesh.mesh_dim_names.index("expert")), mesh.get_local_rank("expert")
    mine = {k: torch.from_numpy(v).chunk(n, 0)[e] for k, v in lp.items() if k != "router"}
    router = torch.from_numpy(lp["router"])
    out, aux = moe_mlp(x, router, mine, config, mesh)
    keep = route(x, router, config, mesh)[3]
    return {"where": where, "out": out.float().numpy(),
            "keep": keep.view(x.shape[:2]).numpy(), "aux": aux.item()}


def moe_world(cases: Dict, layer_cases: Dict, params: Dict, batches: List[Dict],
              ckpt_dir: str) -> Dict:
    """test_torch_moe.py's world of 4 ranks: `steps_case` for each entry of
    `cases` (name -> (axes, config)), the first saved to `ckpt_dir`; and
    `moe_layer_case` for each entry of `layer_cases` (name -> its args)."""
    out = {}
    for i, (name, (axes, config)) in enumerate(cases.items()):
        out[name] = steps_case(axes, config, params, batches, ckpt_dir if i == 0 else None)
    out["layer"] = {name: moe_layer_case(*args) for name, args in layer_cases.items()}
    return out


def pipeline_world(axes, configs: Dict, params: Dict, batches: List[Dict],
                   moe: tuple, ckpt_dir: str, flat_ckpt: str) -> Dict:
    """test_torch_pipeline.py's world of 4 ranks on `axes` (a pipeline
    mesh): `steps_case` for each config of `configs` (the first saved to
    `ckpt_dir`), the loss of batches[0] under each of them (no grad), the
    refusals, `restored` (`restore` of `flat_ckpt` onto the mesh under the
    first config), `loss_and_grads(*moe)` and `loader`: the tokens of this
    rank's first two batches of 8 with 4 microbatches on the native
    gather."""
    mesh = build_mesh(MeshSpec(axes), "cpu")
    out = {}
    for i, (name, config) in enumerate(configs.items()):
        out[name] = steps_case(axes, config, params, batches, ckpt_dir if i == 0 else None)
        model = sharded_state(config, params, mesh).model
        b = shard_batch({k: torch.from_numpy(v) for k, v in batches[0].items()}, mesh,
                        config.pipeline_microbatches)
        with torch.no_grad():
            out[name]["loss"] = loss_fn(model, b).item()
    config = next(iter(configs.values()))
    refusals = {
        "batch": lambda: shard_batch({"tokens": torch.zeros(6, 4)}, mesh, 4),
        "microbatch": lambda: shard_batch({"tokens": torch.zeros(4, 4)}, mesh, 4),
        "n_layers": lambda: shard_model(
            Transformer(dataclasses.replace(config, n_layers=3), "cpu"), mesh),
    }
    out["refusals"] = {}
    for name, make in refusals.items():
        try:
            make()
        except ValueError as e:
            out["refusals"][name] = str(e)
    out["restored"] = restore(axes, config, flat_ckpt, batches[0])
    out["moe"] = loss_and_grads(*moe)
    rows = np.random.RandomState(3).randint(0, 256, size=(24, 33)).astype(np.int32)
    loader = DataLoader(TokenDataset(rows), 8, device="cpu", mesh=mesh, microbatches=4,
                        use_native=True)
    out["loader"] = [b["tokens"].numpy() for _, b in zip(range(2), loader)]
    return out


def vision_world(meshes: List[Dict[str, int]], config, params: Dict, batch: Dict,
                 steps: int) -> List[Dict]:
    """The vision family data-parallel on each mesh of `meshes` in turn:
    the JAX parameters (numpy leaves) replicated on every rank,
    `vision_loss_fn` of the global `batch` and its gradient (this rank's
    rows' share), then `steps` SGD momentum steps on it. Returns, per mesh,
    this rank's `loss0`, `grads0`, step `metrics` (loss, accuracy), final
    `params` and `trace`, and the `refusal` of a 6-row batch (None when 6
    rows split over the batch axes)."""
    out = []
    b = {"images": torch.from_numpy(batch["images"]),
         "labels": torch.from_numpy(batch["labels"]).long()}
    for axes in meshes:
        mesh = build_mesh(MeshSpec(axes), "cpu")
        p = {k: v.requires_grad_() for k, v in vision_params_from_jax(params).items()}
        loss0 = vision_loss_fn(p, b, config, mesh)
        grads0 = torch.autograd.grad(loss0, list(p.values()))
        opt = SGD(0.1, momentum=0.9)
        state = opt.init(p)
        step = make_vision_train_step(config, opt, mesh=mesh, device="cpu")
        metrics = []
        for _ in range(steps):
            p, state, m = step(p, state, b)
            metrics.append((m["loss"].item(), m["accuracy"].item()))
        try:
            local_rows({"labels": torch.zeros(6)}, mesh)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        out.append({"refusal": refusal, "loss0": loss0.item(),
                    "grads0": {n: g.numpy() for n, g in zip(p, grads0)},
                    "metrics": metrics,
                    "params": {n: t.detach().numpy() for n, t in p.items()},
                    "trace": {n: t.numpy() for n, t in state.trace.items()}})
    return out
