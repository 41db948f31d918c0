"""The port's placer behind the JAX package's gang scheduler, on the CPU.

A burst of `bench.build_workload(100, 0)` (bench.py's job mix: sub-slice,
single-host, whole-slice and two-slice TPU jobs, GPU and CPU jobs) runs
through JAX's `GangScheduler` on a `VirtualClock`, with
`charge_solve_time=False` so the scheduler's own wall time does not move
the clock, on 8 slices of 4x4, 4 GPU nodes and 2 CPU nodes, to the last
admission. Once the placer is JAX `TPUPacker(kernel="jax")`, once it is
the port's `TPUPacker` on CPU tensors, each with a cluster of its own. The
port's placer reads the scheduler's incremental snapshots and requests by
attribute. Every PodGroup's placement, reserved nodes, score and admission
time must be equal; a ticker records them as each group is admitted,
because groups are cleaned up after their jobs finish.
"""

import bench
from training_operator_tpu.cluster.inventory import make_cpu_pool, make_gpu_pool, make_tpu_pool
from training_operator_tpu.cluster.runtime import (
    Cluster,
    DefaultScheduler,
    SimKubelet,
    VirtualClock,
)
from training_operator_tpu.controllers import OperatorManager, register_all
from training_operator_tpu.scheduler import GangScheduler, TPUPacker
from training_operator_tpu_torch.scheduler import packer

JOBS = 100


def run_burst(placer):
    cluster = Cluster(VirtualClock())
    cluster.add_nodes(make_tpu_pool(8, slice_topology=bench.SLICE_TOPOLOGY))
    cluster.add_nodes(make_gpu_pool(4, gpus_per_node=bench.GPUS_PER_NODE,
                                    nodes_per_nvlink_domain=4))
    cluster.add_nodes(make_cpu_pool(2, cpu_per_node=bench.CPU_PER_NODE))
    DefaultScheduler(cluster)
    SimKubelet(cluster)
    sched = GangScheduler(cluster, placer, charge_solve_time=False)
    mgr = OperatorManager(cluster, gang_enabled=True, reconciles_per_tick=4096)
    register_all(mgr)
    admitted = {}
    watch = cluster.api.watch(kinds={"PodGroup"})

    def record():
        for ev in watch.drain():
            pg = ev.obj
            if ev.type != "Deleted" and pg.placement and pg.name not in admitted:
                admitted[pg.name] = (dict(pg.placement), list(pg.reserved_nodes),
                                     pg.placement_score, cluster.clock.now())

    cluster.add_ticker(record)
    for spec in bench.build_workload(JOBS, 0):
        mgr.submit(bench.make_job(spec))
    assert cluster.run_until(lambda: len(admitted) == JOBS, timeout=5000)
    return admitted, sched


def test_burst_through_the_gang_scheduler_equals_jax():
    want, jax_sched = run_burst(TPUPacker(kernel="jax"))
    got, sched = run_burst(packer.TPUPacker(device="cpu"))
    assert got == want
    # The burst queued: admissions spread over many cycles and times, and
    # the port's solves were traced with JAX's keys and its own.
    times = sorted({t for *_, t in want.values()})
    assert len(times) > 20 and times[-1] > 300.0
    solves = [r["solver"] for r in sched.dump_trace() if "solver" in r]
    assert solves and all(s["kernel"] == "torch" for s in solves)
    assert {"batch_items", "classes", "candidates", "rounds", "solve_ms"} <= set(solves[-1])
    assert sched.cycles == jax_sched.cycles
