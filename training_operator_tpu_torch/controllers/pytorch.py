"""PyTorchJob controller: DDP + elastic (torchrun) bootstrap.

Parity target: reference pkg/controller.v1/pytorch —
- envvar.go:43-127: PYTHONUNBUFFERED; with a Master spec: MASTER_ADDR (master-0
  service), MASTER_PORT, WORLD_SIZE = totalReplicas x nprocPerNode,
  RANK/PET_NODE_RANK (worker rank is index+1 when a master exists);
  PET_NPROC_PER_NODE; PET_NNODES (plain int without elastic).
- elastic.go:27-197: PET_RDZV_ENDPOINT (host default <job>-worker-0:port),
  PET_RDZV_BACKEND (default c10d), PET_NNODES=min:max, PET_RDZV_ID,
  PET_RDZV_CONF (k=v comma-joined), PET_STANDALONE, PET_MAX_RESTARTS.
- initcontainer.go:104-136: workers get an init container that waits for the
  master's DNS name to resolve.
- hpa.go:33-80: elastic jobs own an HPA spanning min/max replicas.
"""

from __future__ import annotations

from typing import Sequence

from training_operator_tpu_torch.api.common import Container
from training_operator_tpu_torch.api.jobs import (
    Job,
    ObjectMeta,
    PyTorchJob,
    REPLICA_MASTER,
    REPLICA_WORKER,
)
from training_operator_tpu_torch.cluster.objects import HorizontalPodAutoscaler
from training_operator_tpu_torch.controllers.base import BaseController
from training_operator_tpu_torch.engine.core import gen_general_name

INIT_CONTAINER_NAME = "pytorch-init"


class PyTorchController(BaseController):
    kind = "PyTorchJob"
    master_types = (REPLICA_MASTER,)
    leader_priority = (REPLICA_MASTER, REPLICA_WORKER)


    def set_cluster_spec(self, job: Job, template, rtype: str, index: int) -> None:
        assert isinstance(job, PyTorchJob)
        total = job.total_replicas()
        nproc = job.nproc_per_node or (
            job.elastic_policy.n_proc_per_node
            if job.elastic_policy and job.elastic_policy.n_proc_per_node
            else 1
        )
        env = {"PYTHONUNBUFFERED": "1"}

        has_master = job.replica_specs.get(REPLICA_MASTER) is not None
        if has_master:
            rank = index + 1 if rtype == REPLICA_WORKER else index
            env["MASTER_ADDR"] = gen_general_name(job.name, REPLICA_MASTER, 0)
            env["MASTER_PORT"] = str(self._port(job, REPLICA_MASTER))
            env["WORLD_SIZE"] = str(total * nproc)
            env["RANK"] = str(rank)
            env["PET_NODE_RANK"] = str(rank)

        if job.nproc_per_node is not None:
            env["PET_NPROC_PER_NODE"] = str(job.nproc_per_node)

        ep = job.elastic_policy
        if ep is not None:
            host = ep.rdzv_host or gen_general_name(job.name, REPLICA_WORKER, 0)
            port = ep.rdzv_port or self._port(job, REPLICA_WORKER)
            env["PET_RDZV_ENDPOINT"] = f"{host}:{port}"
            env["PET_RDZV_BACKEND"] = (ep.rdzv_backend.value if ep.rdzv_backend else "c10d")
            # default_job always fills min/max for elastic jobs (defaults.py),
            # so nnodes is always the min:max range form here.
            env["PET_NNODES"] = f"{ep.min_replicas}:{ep.max_replicas}"
            if ep.n_proc_per_node is not None:
                env["PET_NPROC_PER_NODE"] = str(ep.n_proc_per_node)
            if ep.rdzv_id is not None:
                env["PET_RDZV_ID"] = ep.rdzv_id
            if ep.rdzv_conf:
                env["PET_RDZV_CONF"] = ",".join(f"{c.key}={c.value}" for c in ep.rdzv_conf)
            if ep.standalone:
                env["PET_STANDALONE"] = ""
            if ep.max_restarts is not None:
                env["PET_MAX_RESTARTS"] = str(ep.max_restarts)
        else:
            env["PET_NNODES"] = str(total)

        for c in template.containers:
            for k, v in env.items():
                c.env.setdefault(k, v)

        # Workers wait for the master service before starting (reference
        # initcontainer.go:104-136 injects an nslookup loop).
        if has_master and rtype == REPLICA_WORKER:
            if not any(c.name == INIT_CONTAINER_NAME for c in template.init_containers):
                from training_operator_tpu_torch.config import current

                master_addr = gen_general_name(job.name, REPLICA_MASTER, 0)
                template.init_containers.append(
                    Container(
                        name=INIT_CONTAINER_NAME,
                        # Image comes from the operator config (reference
                        # pkg/config/config.go default), not a constant.
                        image=current().pytorch_init_container_image,
                        command=["sh", "-c", f"until nslookup {master_addr}; do sleep 1; done"],
                    )
                )

    def reconcile_hook(self, job: Job) -> None:
        """Create/refresh the HPA for elastic jobs; delete it otherwise
        (reference pytorch/hpa.go:33-80 ReconcileHPA)."""
        assert isinstance(job, PyTorchJob)
        existing = self.api.try_get("HorizontalPodAutoscaler", job.namespace, job.name)
        if existing is not None and existing.metadata.owner_uid != job.uid:
            # Stale leftover from a dead same-named job: replace, don't adopt.
            self.api.try_delete("HorizontalPodAutoscaler", job.namespace, job.name)
            existing = None
        ep = job.elastic_policy
        if ep is None or ep.max_replicas is None:
            if existing is not None:
                self.api.try_delete("HorizontalPodAutoscaler", job.namespace, job.name)
            return
        if existing is None:
            self.api.create(
                HorizontalPodAutoscaler(
                    metadata=ObjectMeta(
                        name=job.name, namespace=job.namespace, owner_uid=job.uid
                    ),
                    target_kind=job.kind,
                    target_name=job.name,
                    min_replicas=ep.min_replicas or 1,
                    max_replicas=ep.max_replicas,
                    metrics=list(ep.metrics),
                )
            )
        elif (
            existing.min_replicas != (ep.min_replicas or 1)
            or existing.max_replicas != ep.max_replicas
            or existing.metrics != ep.metrics
        ):
            existing.min_replicas = ep.min_replicas or 1
            existing.max_replicas = ep.max_replicas
            existing.metrics = list(ep.metrics)
            self.api.update(existing, check_version=False)
