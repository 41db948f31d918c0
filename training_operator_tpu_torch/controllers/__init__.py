"""Per-kind controllers implementing the ControllerInterface contract.

Counterpart of training_operator_tpu/controllers for the JAX, PyTorch and
TensorFlow kinds: each supplies its distributed-bootstrap env injection
(SetClusterSpec), master-role semantics, and framework-specific status logic
on top of the shared JobController engine. The MPI, Paddle and XGBoost
controllers are still to be ported.
"""

from training_operator_tpu_torch.controllers.base import BaseController
from training_operator_tpu_torch.controllers.jax import JAXController
from training_operator_tpu_torch.controllers.manager import OperatorManager
from training_operator_tpu_torch.controllers.pytorch import PyTorchController
from training_operator_tpu_torch.controllers.tensorflow import TensorFlowController

ALL_CONTROLLERS = (
    JAXController,
    PyTorchController,
    TensorFlowController,
)


def register_all(manager: OperatorManager) -> None:
    """Register every built-in job kind (the reference's
    SupportedSchemeReconciler map, register_controller.go:36-57)."""
    for ctrl_cls in ALL_CONTROLLERS:
        manager.register(ctrl_cls(manager.api))


__all__ = [
    "ALL_CONTROLLERS",
    "BaseController",
    "JAXController",
    "OperatorManager",
    "PyTorchController",
    "TensorFlowController",
    "register_all",
]
