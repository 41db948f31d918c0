"""The repo's bench bursts on the port: through its operator, and as a placer replay.

Two configurations of the JAX package's `bench.py`:

- the burst pool (`bench.py:78-86`): 48 slices of 4x4 (4 hosts of 4 chips),
  32 GPU nodes of 8 in NVLink domains of 4, 16 CPU nodes of 64 cores; its
  load `build_workload` (`bench.py:102-127`, the same draws), each job made
  by `make_job` (`bench.py:149-192`) as a `JAXJob`, `PyTorchJob` or `TFJob`;
- the 10k-node block (`bench.py:3084`, `run_solver_scale`): 2500 slices of
  4x4 and 2000 single-slice gangs drawn by `random.Random(7)`.

`run_burst` is `bench.run_burst` (`bench.py:394`) on the port's own stack:
a virtual-clock cluster with `DefaultScheduler` and `SimKubelet`, the
`OperatorManager` with the JAX, PyTorch and TensorFlow controllers, and the
`GangScheduler` admitting every PodGroup through the placer given. It
records each PodGroup's admission and each job's Running and Succeeded
times from watch events, as they happen (PodGroups are deleted once their
jobs finish), and returns them with bench's keys.

`replay` runs placers alone, for a measurement on the card: no controllers,
pods or kubelet. At t=0 every gang is pending; each cycle calls
`place(pending, snapshot, now)` on every placer given, each with its own
requests and its own snapshot of the same usage, and holds every placer's
placements to the first's; the admitted gangs' pods are committed into the
usage, each finishes at `now` plus its duration, the clock moves to the
next finish, those gangs are released, and the next cycle builds a fresh
snapshot with the inventory generation unchanged. Admission times are this
cycle model's, not `run_burst`'s.
"""

from __future__ import annotations

import heapq
import random
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from training_operator_tpu_torch.api import common as capi
from training_operator_tpu_torch.api.common import (
    Container,
    JobConditionType,
    PodTemplateSpec,
    ReplicaSpec,
)
from training_operator_tpu_torch.api.jobs import JAXJob, ObjectMeta, PyTorchJob, TFJob, TPUPolicy
from training_operator_tpu_torch.cluster.inventory import (
    GPU_RESOURCE,
    TPU_RESOURCE,
    accel_family,
    make_cpu_pool,
    make_gpu_pool,
    make_tpu_pool,
    topology_chips,
)
from training_operator_tpu_torch.cluster.objects import Node, PodGroup
from training_operator_tpu_torch.cluster.runtime import (
    ANNOTATION_SIM_DURATION,
    Cluster,
    DefaultScheduler,
    SimKubelet,
    VirtualClock,
)
from training_operator_tpu_torch.controllers import OperatorManager, register_all
from training_operator_tpu_torch.scheduler.gang import GangScheduler
from training_operator_tpu_torch.scheduler.packer import SCALE_SHAPES
from training_operator_tpu_torch.scheduler.snapshot import (
    ANNOTATION_EXPECTED_DURATION,
    ClusterSnapshot,
    GangRequest,
    Placement,
    PodRequest,
)

TPU_SLICES = 48
SLICE_TOPOLOGY = "4x4"
GPU_NODES = 32
GPUS_PER_NODE = 8
CPU_NODES = 16
CPU_PER_NODE = 64.0

SCALE_SLICES = 2500
SCALE_GANGS = 2000


def build_workload(n_jobs: int, seed: int):
    """Deterministic job mix: (kind, name, shape, workers, num_slices,
    sim_duration, declared_duration), the draws of bench.py's."""
    rng = random.Random(seed)
    specs = []
    for i in range(n_jobs):
        r = rng.random()
        dur = str(rng.randint(30, 120))
        if r < 0.35:
            specs.append(("jax", f"jax-sub-{i}", "2x4", 2, 1, dur, dur))
        elif r < 0.55:
            specs.append(("jax", f"jax-host-{i}", "1x4", 1, 1, dur, dur))
        elif r < 0.70:
            specs.append(("jax", f"jax-full-{i}", "4x4", 4, 1, dur, dur))
        elif r < 0.75:
            specs.append(("jax", f"jax-multi-{i}", "4x4", 8, 2, dur, dur))
        elif r < 0.90:
            gpus = rng.choice([4.0, 8.0])
            workers = rng.choice([2, 4])
            specs.append(("gpu", f"ddp-{i}", gpus, workers, 1, dur, dur))
        else:
            specs.append(("cpu", f"tf-{i}", 2.0, rng.choice([1, 2]), 1, dur, dur))
    return specs


def make_job(spec):
    """One job of `build_workload`: a JAXJob of `workers` pods of 1 cpu and
    one host's 4 chips on a v5e slice of the asked topology, a PyTorchJob of
    2 cpus and its GPUs a pod, or a TFJob of its cores a pod; the pods run
    for the sim duration and declare the declared one."""
    kind, name, shape, workers, num_slices, dur, declared = spec
    if kind == "jax":
        container = Container(name="jax", image="trainer",
                              resources={"cpu": 1.0, TPU_RESOURCE: 4.0})
    elif kind == "gpu":
        container = Container(name="pytorch", image="trainer",
                              resources={"cpu": 2.0, GPU_RESOURCE: shape})
    else:
        container = Container(name="tensorflow", image="trainer", resources={"cpu": shape})
    t = PodTemplateSpec(containers=[container])
    t.annotations[ANNOTATION_SIM_DURATION] = dur
    if declared is not None:
        t.annotations[ANNOTATION_EXPECTED_DURATION] = declared
    specs = {"Worker": ReplicaSpec(replicas=workers, template=t)}
    if kind == "jax":
        return JAXJob(metadata=ObjectMeta(name=name), replica_specs=specs,
                      tpu_policy=TPUPolicy(accelerator=f"v5e-{topology_chips(shape)}",
                                           topology=shape, num_slices=num_slices))
    if kind == "gpu":
        return PyTorchJob(metadata=ObjectMeta(name=name), replica_specs=specs)
    return TFJob(metadata=ObjectMeta(name=name), replica_specs=specs)


def job_request(spec, creation_time: float = 0.0) -> GangRequest:
    """One job of `build_workload` as the gang the operator builds from
    `make_job`'s job: `workers` pods named `<job>-worker-<i>` with the
    container's resources, the topology and v5e family of a jax job, and
    the declared duration as the estimate."""
    kind, name, shape, workers, num_slices, _dur, declared = spec
    if kind == "jax":
        resources = {"cpu": 1.0, TPU_RESOURCE: 4.0}
        topology, tpu_type = shape, accel_family(f"v5e-{topology_chips(shape)}")
    else:
        resources = ({"cpu": 2.0, GPU_RESOURCE: shape} if kind == "gpu" else {"cpu": shape})
        topology, tpu_type, num_slices = None, "", 1
    pods = [PodRequest(name=f"{name}-worker-{i}", replica_type="Worker", index=i,
                       resources=dict(resources)) for i in range(workers)]
    group = PodGroup(metadata=ObjectMeta(name=name, creation_time=creation_time))
    return GangRequest(group=group, pods=pods, topology=topology, num_slices=num_slices,
                       tpu_type=tpu_type,
                       expected_duration=float(declared) if declared is not None else None)


def burst_pool(tpu_slices: int = TPU_SLICES, gpu_nodes: int = GPU_NODES,
               cpu_nodes: int = CPU_NODES) -> List[Node]:
    return (make_tpu_pool(tpu_slices, slice_topology=SLICE_TOPOLOGY)
            + make_gpu_pool(gpu_nodes, gpus_per_node=GPUS_PER_NODE, nodes_per_nvlink_domain=4)
            + make_cpu_pool(cpu_nodes, cpu_per_node=CPU_PER_NODE))


def scale_pool(n_slices: int = SCALE_SLICES) -> List[Node]:
    """The 10k-node block's pool: 2500 slices of 4x4, 4 hosts each."""
    return make_tpu_pool(n_slices, slice_topology=SLICE_TOPOLOGY)


def scale_requests(n_gangs: int = SCALE_GANGS, seed: int = 7) -> List[GangRequest]:
    """The 10k-node block's gangs: shapes drawn from SCALE_SHAPES, one pod
    of 4 chips per host, creation time i x 1 ms."""
    rng = random.Random(seed)
    out = []
    for i in range(n_gangs):
        topo, hosts = rng.choice(SCALE_SHAPES)
        pods = [PodRequest(name=f"scale-{i}-w-{j}", replica_type="Worker", index=j,
                           resources={"cpu": 1.0, TPU_RESOURCE: 4.0}) for j in range(hosts)]
        group = PodGroup(metadata=ObjectMeta(name=f"scale-{i}", creation_time=float(i) * 0.001))
        out.append(GangRequest(group=group, pods=pods, topology=topo, num_slices=1,
                               tpu_type="v5e"))
    return out


def gang_usage(req: GangRequest, placement: Placement) -> List[Tuple[Dict[str, float], str]]:
    """What an admitted gang holds, as (resources, node) pairs: each pod's
    resources on its node."""
    return [(pod.resources, placement.assignments[pod.name]) for pod in req.pods
            if pod.name in placement.assignments]


def usage_snapshot(nodes: Iterable[Node], usage: Iterable[Tuple[Dict[str, float], str]] = (),
                   inventory_gen: Optional[object] = None) -> ClusterSnapshot:
    """A snapshot of `nodes` with `usage`, (resources, node) pairs, taken:
    the cold snapshot of no pods and no groups, the usage committed, and
    `inventory_gen` stamped as the gang scheduler's maintainer stamps it
    (None = the placer checks the inventory every cycle)."""
    snap = ClusterSnapshot(None, bound_pods=[], podgroups=[], nodes=nodes)
    for res, node in usage:
        snap.commit(res, node)
    snap.inventory_gen = inventory_gen
    return snap


def placement_diff(a: Dict[str, Optional[Placement]], b: Dict[str, Optional[Placement]]
                   ) -> List[str]:
    """The gangs whose placements differ, field by field (assignments,
    slices_used, reserved_nodes, score); empty when equal."""
    bad = []
    for key in sorted(set(a) | set(b)):
        pa, pb = a.get(key), b.get(key)
        if (pa is None) != (pb is None):
            bad.append(f"{key}: {pa} vs {pb}")
        elif pa is not None and (
                (pa.assignments, pa.slices_used, pa.reserved_nodes, pa.score)
                != (pb.assignments, pb.slices_used, pb.reserved_nodes, pb.score)):
            bad.append(f"{key}: {pa} vs {pb}")
    return bad


def replay(packers: Sequence, nodes: List[Node], specs, max_cycles: int = 400,
           inventory_gen: object = 1) -> dict:
    """Replays `specs` (build_workload's tuples) through every placer in
    `packers` in lock step (see the module docstring); raises
    AssertionError in the first cycle where a placer's placements differ
    from the first placer's. Returns the cycles run, the gangs admitted and
    their admission times, and per placer the host-clock ms of each cycle's
    snapshot build and place() call, and of the solve inside it
    (`last_solve_stats["solve_ms"]`, 0 where a cycle ran no TPU solve), and
    the first placer's rounds per cycle where it reports them."""
    arms = [[job_request(s) for s in specs] for _ in packers]
    durations = {req.key: float(s[5]) for req, s in zip(arms[0], specs)}
    pending = [list(reqs) for reqs in arms]
    usage: Dict[str, list] = {}
    running: List[tuple] = []  # (finish time, key)
    admitted_at: Dict[str, float] = {}
    snap_ms: List[List[float]] = [[] for _ in packers]
    place_ms: List[List[float]] = [[] for _ in packers]
    solve_ms: List[List[float]] = [[] for _ in packers]
    rounds: List[float] = []
    now, cycles = 0.0, 0
    while pending[0] and cycles < max_cycles:
        used = [u for us in usage.values() for u in us]
        outs = []
        for i, (packer, pend) in enumerate(zip(packers, pending)):
            t = time.perf_counter()
            snapshot = usage_snapshot(nodes, used, inventory_gen=inventory_gen)
            t1 = time.perf_counter()
            packer.last_solve_stats = {}
            outs.append(packer.place(pend, snapshot, now))
            t2 = time.perf_counter()
            snap_ms[i].append((t1 - t) * 1e3)
            place_ms[i].append((t2 - t1) * 1e3)
            solve_ms[i].append(packer.last_solve_stats.get("solve_ms", 0.0))
            if i == 0 and "rounds" in packer.last_solve_stats:
                rounds.append(packer.last_solve_stats["rounds"])
        for i, out in enumerate(outs[1:], 1):
            bad = placement_diff(outs[0], out)
            if bad:
                raise AssertionError(f"cycle {cycles} at t={now}: placer {i} differs from "
                                     f"placer 0 on {len(bad)} gangs, first {bad[:3]}")
        for req in pending[0]:
            placement = outs[0].get(req.key)
            if placement is not None:
                usage[req.key] = gang_usage(req, placement)
                heapq.heappush(running, (now + durations[req.key], req.key))
                admitted_at[req.key] = now
        pending = [[r for r in pend if outs[0].get(r.key) is None] for pend in pending]
        cycles += 1
        if not pending[0] or not running:
            break  # all admitted, or nothing left to free capacity
        now = running[0][0]
        while running and running[0][0] <= now:
            del usage[heapq.heappop(running)[1]]
    return {"cycles": cycles, "gangs": len(specs), "admitted": len(admitted_at),
            "admitted_at": admitted_at, "snapshot_ms": snap_ms, "place_ms": place_ms,
            "solve_ms": solve_ms, "rounds": rounds, "end_t": now}


def trace_records(trace) -> List[tuple]:
    """The gang scheduler's cycle records without wall times or the
    placer's own stats: time, mode, pending (all and TPU), admitted, free
    TPU hosts and whole free slices. Two runs whose placements agree have
    equal records."""
    return [(r["t"], r["mode"], r["pending"], r["pending_tpu"], r["admitted"],
             r["free_tpu_hosts"], r["whole_free_slices"]) for r in trace]


def _pct(sorted_vals, p):
    return sorted_vals[min(len(sorted_vals) - 1, int(p * len(sorted_vals)))] if sorted_vals else 0.0


def run_burst(specs, placer, tpu_slices: int = TPU_SLICES, gpu_nodes: int = GPU_NODES,
              cpu_nodes: int = CPU_NODES, charge_solve_time: bool = True) -> dict:
    """`bench.run_burst` on the port's stack (see the module docstring),
    until every job has finished; raises RuntimeError if one has not by
    virtual time 50,000 s. With `charge_solve_time` each solve's wall time
    moves the virtual clock, as in bench; without it the run is a pure
    function of the specs and the placements.

    Returns `admitted` (PodGroup name -> placement, reserved nodes, score
    and virtual admission time), `running` and `succeeded` (job name ->
    the virtual time of that condition; a job that failed has no entry in
    `succeeded`), the scheduler's `cycles` and `trace`, and bench's keys,
    unrounded: p50/p90/p99 of schedule-to-running and the makespan in
    virtual seconds, the solver's wall seconds, its cycles and incremental
    cycles, and the burst's wall seconds."""
    cluster = Cluster(VirtualClock())
    cluster.add_nodes(burst_pool(tpu_slices, gpu_nodes, cpu_nodes))
    DefaultScheduler(cluster)
    SimKubelet(cluster)
    sched = GangScheduler(cluster, placer, charge_solve_time=charge_solve_time, prewarm=True,
                          min_solve_interval=0.25, incremental=True)
    mgr = OperatorManager(cluster, gang_enabled=True, reconciles_per_tick=4096)
    register_all(mgr)
    jobs = [make_job(s) for s in specs]
    admitted: Dict[str, tuple] = {}
    running: Dict[str, float] = {}
    succeeded: Dict[str, float] = {}
    finished = set()
    groups = cluster.api.watch(kinds=("PodGroup",))
    job_events = cluster.api.watch(kinds={j.kind for j in jobs})

    def track():
        for ev in groups.drain():
            pg = ev.obj
            if ev.type != "Deleted" and pg.placement and pg.name not in admitted:
                admitted[pg.name] = (dict(pg.placement), list(pg.reserved_nodes),
                                     pg.placement_score, cluster.clock.now())
        for ev in job_events.drain():
            if ev.type != "Modified":
                continue
            j = ev.obj
            if j.name not in running:
                cond = capi.get_condition(j.status, JobConditionType.RUNNING)
                if cond is not None and cond.status:
                    running[j.name] = cond.last_transition_time
            if capi.is_finished(j.status):
                finished.add(j.name)
                cond = capi.get_condition(j.status, JobConditionType.SUCCEEDED)
                if cond is not None and cond.status:
                    succeeded.setdefault(j.name, cond.last_transition_time)

    cluster.add_ticker(track)
    t_wall = time.perf_counter()
    for j in jobs:
        mgr.submit(j)
    ok = cluster.run_until(lambda: len(finished) >= len(jobs), timeout=50_000,
                           max_steps=5_000_000)
    wall = time.perf_counter() - t_wall
    if not ok:
        raise RuntimeError(f"burst did not finish: {len(jobs) - len(finished)} jobs pending")
    latencies = sorted(running[j.name] - (j.metadata.creation_time or 0.0)
                       for j in jobs if j.name in running)
    return {
        "admitted": admitted, "running": running, "succeeded": succeeded,
        "cycles": sched.cycles, "trace": sched.dump_trace(),
        "p50_s": _pct(latencies, 0.50), "p90_s": _pct(latencies, 0.90),
        "p99_s": _pct(latencies, 0.99), "makespan_s": cluster.clock.now(),
        "solver_wall_s": sched.solve_walltime_total, "solver_cycles": sched.cycles,
        "solver_incremental_cycles": sum(1 for r in sched.trace
                                         if r.get("mode") == "incremental"),
        "bench_wall_s": wall, "jobs_measured": len(latencies),
    }
