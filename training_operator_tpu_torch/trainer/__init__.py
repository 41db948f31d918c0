"""The trainer runtime on NVIDIA cards: the flagship decoder, its flash
attention kernels and its fp32 head's 3xTF32 GEMM (head_gemm.py), the AdamW
train step, the token data loader, the
checkpointer, the trainer loop (standalone.py), the mesh that shards them
over processes (mesh.py, distributed.py, collectives.py) and the vision
family (vision.py: the conv classifier with SGD + momentum).

Counterpart of training_operator_tpu/trainer, with every mesh axis ported:
fsdp, tensor and data; sequence (ring attention on the flash kernels, and
Ulysses); pipeline (GPipe stages, pipeline.py); expert (the switch MoE,
moe.py). Entry points run on the card unless the caller passes
`device="cpu"`.
"""

from training_operator_tpu_torch.trainer.model import TransformerConfig, init_params, forward, loss_fn
from training_operator_tpu_torch.trainer.train import SGD, TrainState, make_train_step

# The vision entry points load on first use, so that `python -m
# training_operator_tpu_torch.trainer.vision` does not find its module
# already imported by this package.
_VISION = ("VisionConfig", "init_vision_params", "make_vision_train_step", "synthetic_mnist",
           "vision_forward", "vision_loss_fn")


def __getattr__(name):
    if name in _VISION:
        from training_operator_tpu_torch.trainer import vision

        return getattr(vision, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "TransformerConfig",
    "init_params",
    "forward",
    "loss_fn",
    "TrainState",
    "make_train_step",
    "SGD",
    *_VISION,
]
