"""TFJob controller: TF_CONFIG generation + success-policy semantics.

Parity target: reference pkg/controller.v1/tensorflow —
- tensorflow.go:112-188: TF_CONFIG JSON {cluster: {rtype: ["<svc>.<ns>.svc[:domain]:port"]},
  task: {type, index}, environment: "cloud"}; sparse variant when
  EnableDynamicWorker (cluster lists only this worker + all PS).
- tfjob_controller.go:466-467: success policy — default: job succeeds when
  chief/master finishes (or worker-0 when chiefless); AllWorkers: every worker
  must finish.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

from training_operator_tpu_torch.api.jobs import Job, TFJob
from training_operator_tpu_torch.api.jobs import SuccessPolicy
from training_operator_tpu_torch.cluster.objects import Pod, PodPhase
from training_operator_tpu_torch.controllers.base import BaseController
from training_operator_tpu_torch.engine import core
from training_operator_tpu_torch.engine.core import gen_general_name

ENV_CUSTOM_CLUSTER_DOMAIN = "CUSTOM_CLUSTER_DOMAIN"  # reference tensorflow.go:32


class TensorFlowController(BaseController):
    kind = "TFJob"
    master_types = ("Chief", "Master")
    leader_priority = ("Chief", "Master", "Worker")


    def _cluster_spec(self, job: TFJob):
        """reference genClusterSpec (tensorflow.go:157-188)."""
        cluster = {}
        domain = os.environ.get(ENV_CUSTOM_CLUSTER_DOMAIN, "")
        for rtype, spec in job.replica_specs.items():
            rt = rtype.lower()
            port = self._port(job, rtype)
            endpoints = []
            for i in range(spec.replicas or 0):
                svc = f"{gen_general_name(job.name, rtype, i)}.{job.namespace}.svc"
                if domain:
                    svc += f".{domain}"
                endpoints.append(f"{svc}:{port}")
            cluster[rt] = endpoints
        return cluster

    def set_cluster_spec(self, job: Job, template, rtype: str, index: int) -> None:
        assert isinstance(job, TFJob)
        cluster = self._cluster_spec(job)
        rt = rtype.lower()
        if job.enable_dynamic_worker:
            # Sparse spec: this worker only, plus every PS
            # (reference convertClusterSpecToSparseClusterSpec, tensorflow.go:74-83).
            sparse = {"ps": cluster.get("ps", []), "worker": {}}
            if rt == "ps":
                sparse = {"ps": [cluster["ps"][index]], "worker": {}}
            elif rt == "worker":
                sparse["worker"] = {str(index): cluster["worker"][index]}
            tf_config = {"cluster": sparse, "task": {"type": rt, "index": index}}
        else:
            tf_config = {
                "cluster": cluster,
                "task": {"type": rt, "index": index},
                "environment": "cloud",
            }
        payload = json.dumps(tf_config, sort_keys=True)
        for c in template.containers:
            c.env.setdefault("TF_CONFIG", payload)

    # -- success-policy status semantics ------------------------------------

    def _has_chief(self, job: TFJob) -> bool:
        return any(
            t in job.replica_specs and (job.replica_specs[t].replicas or 0) > 0
            for t in ("Chief", "Master")
        )

    def job_succeeded(self, job: Job, pods: Sequence[Pod]) -> bool:
        assert isinstance(job, TFJob)
        workers = core.filter_pods_for_replica_type(pods, "Worker")
        if job.success_policy == SuccessPolicy.ALL_WORKERS:
            expected = job.replica_specs.get("Worker")
            n = expected.replicas or 0 if expected else 0
            done = sum(1 for p in workers if p.status.phase == PodPhase.SUCCEEDED)
            return n > 0 and done >= n
        if self._has_chief(job):
            return super().job_succeeded(job, pods)
        # Chiefless: worker-0 completion ends the job
        # (reference tfjob_controller.go:466-467).
        from training_operator_tpu_torch.api.common import REPLICA_INDEX_LABEL

        for p in workers:
            if p.metadata.labels.get(REPLICA_INDEX_LABEL) == "0":
                return p.status.phase == PodPhase.SUCCEEDED
        return False
