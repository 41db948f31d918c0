"""Weight bridge: the JAX package's parameter pytree to the port's parameters.

The JAX tree is {"embed", "layers": {"ln1", "wq", ...}, "ln_f", "lm_head"}
with layer weights stacked on [L] and matrices stored [in, out]; the port's
`Transformer` keeps exactly that layout, so the bridge only flattens the
names ("layers.wq") and copies. The trees come in as numpy arrays (convert
a JAX tree with `jax.tree.map(np.asarray, tree)` on the JAX side); nothing
here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from training_operator_tpu_torch.trainer.model import Transformer


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
    """Copies a JAX parameter tree into `model` (on whatever device it lives)."""
    state = params_from_jax(tree)
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(own) - set(state))}, "
            f"unexpected {sorted(set(state) - set(own))}"
        )
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: JAX {tuple(value.shape)} vs port {tuple(own[name].shape)}")
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
