"""Reconcile engine: the generic controller core every job kind shares.

Parity target: reference pkg/controller.v1/common (JobController:
ReconcileJobs/ReconcilePods/ReconcileServices), pkg/core (pure helpers),
pkg/controller.v1/control (pod/service/podgroup control), and
pkg/controller.v1/expectation (expectations cache). Deterministic and
fake-cluster-testable by construction (SURVEY.md §7 stage 2).
"""

from training_operator_tpu_torch.engine.controller import JobController, ControllerInterface
from training_operator_tpu_torch.engine.expectations import ControllerExpectations
from training_operator_tpu_torch.engine.workqueue import RateLimitingQueue

__all__ = [
    "ControllerExpectations",
    "ControllerInterface",
    "JobController",
    "RateLimitingQueue",
]
