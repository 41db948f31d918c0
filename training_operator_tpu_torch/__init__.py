"""PyTorch/CUDA port of the trainer runtime, for NVIDIA Hopper (H100).

Beside `training_operator_tpu` (the JAX/TPU reference, which it never
imports), this package ports the trainer's compute path module by module:
`trainer/` mirrors `training_operator_tpu/trainer/`, and every Pallas kernel
there becomes a hand-written CUDA kernel under `trainer/csrc/`.
"""
