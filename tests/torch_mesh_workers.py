"""Rank bodies for the port's multi-process tests (test_torch_mesh.py).

Each function runs in every rank of a gloo CPU world started by
`training_operator_tpu_torch.trainer.distributed.spawn`, which imports this
module by name in fresh processes: so it imports torch and the port only,
never JAX, and takes and returns numpy arrays.
"""

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from training_operator_tpu_torch.trainer.checkpoint import Checkpointer, restore_into_mesh
from training_operator_tpu_torch.trainer.convert import load_jax_params
from training_operator_tpu_torch.trainer.data import DataLoader, TokenDataset
from training_operator_tpu_torch.trainer.mesh import MeshSpec, build_mesh, shard_batch
from training_operator_tpu_torch.trainer.collectives import all_gather
from training_operator_tpu_torch.trainer.model import (
    PARAM_SPECS,
    Transformer,
    TransformerConfig,
    loss_fn,
    shard_model,
)
from training_operator_tpu_torch.trainer.train import (
    TrainState,
    make_optimizer,
    make_train_step,
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


def gather_shard(name: str, local: torch.Tensor, mesh) -> torch.Tensor:
    """The whole of parameter `name` (or of a moment laid out like it) from
    every rank's shard: the inverse of model.local_shard, collective."""
    out = local
    for dim, axes in enumerate(PARAM_SPECS[name]):
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
            out[f"{kind}.{name}"] = (t.clone() if mesh is None
                                     else gather_shard(name, t, mesh)).numpy()
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
            b = shard_batch(b, mesh)
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
