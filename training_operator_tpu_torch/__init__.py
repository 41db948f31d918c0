"""PyTorch/CUDA port of the operator, for NVIDIA Hopper (H100).

Beside `training_operator_tpu` (the JAX/TPU reference, which it never
imports), this package ports the system module by module under the same
paths: `trainer/` is the compute path a scheduled job runs, with every
Pallas kernel there a hand-written CUDA kernel under `trainer/csrc/`;
`scheduler/packer.py` is the placement engine with its solve on the card;
and the control plane around it (`api/`, `cluster/`, `engine/`,
`controllers/`, `scheduler/gang.py` and `elastic.py`, `observe/timeline.py`,
`utils/metrics.py`, `config.py`) is the JAX package's device-free Python,
copied with its imports pointed here.
"""
