"""Graft entry point of the port, single-device half.

Counterpart of `entry()` in the repo's `__graft_entry__.py`: the forward and
loss of the tiny decoder, as a function and its example arguments. The
multi-chip dry run (`dryrun_multichip`) waits for the sharding slice
(ROADMAP item A10).
"""

from __future__ import annotations

import torch

from training_operator_tpu_torch.trainer.model import (
    TransformerConfig,
    init_params,
    loss_fn,
    resolve_device,
)
from training_operator_tpu_torch.trainer.train import make_example_batch


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
