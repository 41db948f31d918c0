"""JAXJob controller — the primary, TPU-native path.

Parity target: reference pkg/controller.v1/jax (envvar.go:37-77,
jaxjob_controller.go:443 SetClusterSpec). Worker-0 is the coordinator; every
worker gets the bootstrap env that maps 1:1 onto
`jax.distributed.initialize(coordinator_address, num_processes, process_id)`:

    COORDINATOR_ADDRESS  <job>-worker-0 headless service DNS name
    COORDINATOR_PORT     job's coordinator port (default 6666)
    NUM_PROCESSES        total worker replicas
    PROCESS_ID           this replica's index
    PYTHONUNBUFFERED     1

TPU-first extension: when the job carries a TPUPolicy, the mesh geometry is
also exported (TPU_MESH_AXES/TPU_SLICE_TOPOLOGY/TPU_NUM_SLICES) so the trainer
runtime can build its jax.sharding.Mesh without out-of-band config.

Multi-slice (num_slices > 1) jobs additionally get the full per-slice
bootstrap contract. Worker index -> slice mapping is the SAME contiguous
convention the packer places by (packer.py _place_tpu_batch: sorted pods
[sub*pods_per_slice : (sub+1)*pods_per_slice] land on slice `sub`), so the
env is derivable from the index and always consistent with placement:

    TPU_SLICE_ID                  index // workers_per_slice
    TPU_WORKER_ID_IN_SLICE        index %  workers_per_slice
    TPU_WORKERS_PER_SLICE         workers_per_slice
    TPU_SLICE_COORDINATOR_ADDRESS first worker of this slice (ICI-local
                                  rendezvous, e.g. per-slice NCCL-free
                                  barrier/health checks)
    TPU_SLICE_COORDINATOR_PORT    job coordinator port
    MEGASCALE_COORDINATOR_ADDRESS worker-0 service (the inter-slice DCN
    MEGASCALE_PORT                coordinator, libtpu megascale wire names)
    MEGASCALE_NUM_SLICES          num_slices
    MEGASCALE_SLICE_ID            == TPU_SLICE_ID

`jax.distributed` still spans ALL processes via COORDINATOR_ADDRESS —
slice-local vs cross-slice traffic is split by the mesh axes (DCN-riding
axes outermost, see trainer/mesh.py), not by separate process groups.
Admission validates total workers % num_slices == 0 (validation.py).
"""

from __future__ import annotations

from training_operator_tpu_torch.api.jobs import JAXJob, Job, REPLICA_WORKER
from training_operator_tpu_torch.controllers.base import BaseController
from training_operator_tpu_torch.engine.core import gen_general_name


class JAXController(BaseController):
    kind = "JAXJob"
    master_types = ()  # worker-only; worker-0 is the coordinator
    leader_priority = (REPLICA_WORKER,)

    def is_master_role(self, job: Job, rtype: str, index: int) -> bool:
        return rtype == REPLICA_WORKER and index == 0

    def _default_port(self, job: Job) -> int:
        assert isinstance(job, JAXJob)
        return job.coordinator_port  # per-job knob, unlike the other kinds

    def set_cluster_spec(self, job: Job, template, rtype: str, index: int) -> None:
        assert isinstance(job, JAXJob)
        coordinator_addr = gen_general_name(job.name, REPLICA_WORKER, 0)
        port = self._port(job, REPLICA_WORKER)
        total = job.total_replicas()
        env = {
            "PYTHONUNBUFFERED": "1",
            "COORDINATOR_PORT": str(port),
            "COORDINATOR_ADDRESS": coordinator_addr,
            "NUM_PROCESSES": str(total),
            "PROCESS_ID": str(index),
        }
        if job.tpu_policy is not None:
            tp = job.tpu_policy
            env["TPU_ACCELERATOR"] = tp.accelerator
            env["TPU_NUM_SLICES"] = str(tp.num_slices)
            if tp.topology:
                env["TPU_SLICE_TOPOLOGY"] = tp.topology
            if tp.mesh_axes:
                env["TPU_MESH_AXES"] = ",".join(f"{k}={v}" for k, v in tp.mesh_axes.items())
            if tp.num_slices > 1 and total % tp.num_slices == 0:
                # Per-slice identity + coordinators (contract in the module
                # docstring; mapping matches the packer's placement).
                per_slice = total // tp.num_slices
                slice_id = index // per_slice
                env["TPU_SLICE_ID"] = str(slice_id)
                env["TPU_WORKER_ID_IN_SLICE"] = str(index % per_slice)
                env["TPU_WORKERS_PER_SLICE"] = str(per_slice)
                env["TPU_SLICE_COORDINATOR_ADDRESS"] = gen_general_name(
                    job.name, REPLICA_WORKER, slice_id * per_slice
                )
                env["TPU_SLICE_COORDINATOR_PORT"] = str(port)
                env["MEGASCALE_COORDINATOR_ADDRESS"] = coordinator_addr
                env["MEGASCALE_PORT"] = str(port + 1)
                env["MEGASCALE_NUM_SLICES"] = str(tp.num_slices)
                env["MEGASCALE_SLICE_ID"] = str(slice_id)
                # The DCN coordinator listens beside the jax.distributed one;
                # expose it on the headless service too.
                for c in template.containers:
                    c.ports.setdefault("jaxjob-dcn-port", port + 1)
        for c in template.containers:
            for k, v in env.items():
                c.env.setdefault(k, v)
