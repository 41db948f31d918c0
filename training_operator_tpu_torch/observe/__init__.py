"""Observability: the job-lifecycle span tracer.

Public surface (the rest of the JAX package's observe plane, attribution,
describe, export, fleet, invariants and SLOs, is still to be ported):
  TimelineStore / JobTimeline / Span   the tracer model (observe/timeline.py)
  set_enabled / enabled                process-wide tracing switch

The APIServer owns a `TimelineStore` as `api.timelines`; the admission
path, the manager workqueue, the reconcile engine and the gang scheduler
record spans into it.
"""

from training_operator_tpu_torch.observe.timeline import (  # noqa: F401
    JobTimeline,
    Span,
    TimelineStore,
    enabled,
    set_enabled,
)
