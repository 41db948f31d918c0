"""The trainer runtime on NVIDIA cards: the flagship decoder, its flash
attention kernels, the AdamW train step, the token data loader, the
checkpointer, the trainer loop (standalone.py), and the mesh that shards
them over processes (mesh.py, distributed.py, collectives.py).

Counterpart of training_operator_tpu/trainer (its fsdp and tensor axes;
sequence, pipeline and expert parallelism are not ported yet). Entry points
run on the card unless the caller passes `device="cpu"`.
"""

from training_operator_tpu_torch.trainer.model import TransformerConfig, init_params, forward, loss_fn
from training_operator_tpu_torch.trainer.train import TrainState, make_train_step

__all__ = [
    "TransformerConfig",
    "init_params",
    "forward",
    "loss_fn",
    "TrainState",
    "make_train_step",
]
