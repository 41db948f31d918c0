"""Weight bridge: the JAX package's parameter pytree to the port's parameters.

The JAX tree is {"embed", "layers": {"ln1", "wq", ...}, "ln_f", "lm_head"}
with layer weights stacked on [L] and matrices stored [in, out] (a MoE
model's layers add "router" [L, D, E] and lead w1/w3/w2 with E after L);
the port's `Transformer` keeps exactly that layout, so the bridge only
flattens the names ("layers.wq") and copies, after checking the names and
shapes against the config's (model.param_shapes). The trees come in as numpy arrays (convert
a JAX tree with `jax.tree.map(np.asarray, tree)` on the JAX side); nothing
here imports JAX. The vision family's convs go from JAX's HWIO to torch's
OIHW (`vision_params_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from training_operator_tpu_torch.trainer.model import Transformer, param_shapes
from training_operator_tpu_torch.trainer.train import SGDState


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a.b": leaf}, the port's parameter names."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_tree(value, name + "."))
        else:
            flat[name] = value
    return flat


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> state dict of fp32 CPU tensors."""
    return {
        name: torch.from_numpy(np.array(leaf, dtype=np.float32))
        for name, leaf in flatten_tree(tree).items()
    }


@torch.no_grad()
def load_jax_params(model: Transformer, tree: Dict[str, Any]) -> Transformer:
    """Copies a JAX parameter tree into an unsharded `model` (on whatever
    device it lives); the names and shapes must be those of the model's
    config, MoE router and expert stacks included."""
    state = params_from_jax(tree)
    want = param_shapes(model.config)
    if set(state) != set(want):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(want) - set(state))}, "
            f"unexpected {sorted(set(state) - set(want))}"
        )
    own = dict(model.named_parameters())
    for name, value in state.items():
        if tuple(value.shape) != want[name] or tuple(own[name].shape) != want[name]:
            raise ValueError(f"{name}: JAX {tuple(value.shape)} vs port {want[name]} "
                             f"(the model holds {tuple(own[name].shape)})")
        own[name].copy_(value)
    return model


def adam_moments_from_jax(opt_state: Any) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
    """(mu, nu, count) from an optax chain state that holds one Adam state
    (the object with `mu`, `nu` and `count` fields), with leaves as numpy
    arrays; mu and nu come back flattened to the port's parameter names."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if all(hasattr(node, f) for f in ("mu", "nu", "count")):
            return (params_from_jax(node.mu), params_from_jax(node.nu), int(np.asarray(node.count)))
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no Adam state (mu, nu, count) in the optimizer state")


def vision_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The vision family's JAX parameters (numpy leaves) -> the port's, fp32
    CPU tensors: conv kernels from HWIO to OIHW; `w_dense` keeps its rows'
    (h, w, c) order, since vision_forward flattens NHWC as JAX does."""
    out = params_from_jax(tree)
    for name in ("conv1", "conv2"):
        out[name] = out[name].permute(3, 2, 0, 1).contiguous()
    return out


def sgd_state_from_jax(opt_state: Any) -> SGDState:
    """The port's SGDState from an optax.sgd(momentum=...) state holding one
    trace (the object with a `trace` field) over the vision family's
    parameters, numpy leaves."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "trace"):
            return SGDState(trace=vision_params_from_jax(node.trace))
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no trace (momentum) state in the optimizer state")
