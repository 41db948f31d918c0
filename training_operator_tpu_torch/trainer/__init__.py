"""The trainer runtime on one NVIDIA card: the flagship decoder, its flash
attention kernels, the AdamW train step and the token data loader.

Counterpart of training_operator_tpu/trainer (without the mesh, which is not
ported yet). Entry points run on the card unless the caller passes
`device="cpu"`.
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
