"""Operator configuration (reference pkg/config/config.go:36).

Counterpart of training_operator_tpu/config.py, holding the knobs the
operator's scheduling path reads: the default PriorityClass stamped onto a
PodGroup whose job names none (engine/controller.py) and the image of the
PyTorch workers' master-wait init container (controllers/pytorch.py). The
process entry point's knobs (schemes, gang scheduler, solver cadence, wire,
store, replication, soak) come with the operator process.

A module-level `current()` config replaces the reference's package-global
config.Config; controllers read defaults through it so deployments can
override images without touching controller code.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OperatorConfig:
    # PriorityClass stamped onto PodGroups whose job names none
    # (RunPolicy.scheduling_policy.priority_class); "" = unclassed.
    default_priority_class: str = ""
    # Default images (reference pkg/config/config.go Config struct).
    pytorch_init_container_image: str = "alpine:3.10"


_current = OperatorConfig()


def current() -> OperatorConfig:
    """The process-wide config (reference package-global config.Config)."""
    return _current


def set_current(cfg: OperatorConfig) -> OperatorConfig:
    global _current
    _current = cfg
    return cfg
