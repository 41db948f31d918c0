"""Placer workloads at the repo's bench sizes, and a cycle replay to drive them.

Two configurations of the JAX package's `bench.py`, as node records and gang
requests for `packer.TPUPacker`:

- the burst pool (`bench.py:78-86`): 48 slices of 4x4 (4 hosts of 4 chips),
  32 GPU nodes of 8 in NVLink domains of 4, 16 CPU nodes of 64 cores; its
  load `build_workload` (`bench.py:102-127`, the same draws) with each job
  kind's pods as `bench.make_job` builds them (`bench.py:149-192`);
- the 10k-node block (`bench.py:3084`, `run_solver_scale`): 2500 slices of
  4x4 and 2000 single-slice gangs drawn by `random.Random(7)`.

`replay` runs placers for a measurement on the card; it is not `bench.py`'s burst: no
controllers, pods or kubelet. At t=0 every gang is pending; each cycle
calls `place(pending, snapshot, now)` on every placer given, each with its
own requests and its own snapshot of the same usage, and holds every
placer's placements to the first's; the admitted gangs' pods are committed
into the usage, each finishes at `now` plus its duration, the clock moves
to the next finish, those gangs are released, and the next cycle builds a
fresh snapshot with the inventory generation unchanged. Admission times are
this cycle model's, not `bench.py`'s.
"""

from __future__ import annotations

import heapq
import random
import time
from typing import Dict, List, Optional, Sequence

from training_operator_tpu_torch.scheduler.inventory import (
    GPU_RESOURCE,
    TPU_RESOURCE,
    Node,
    accel_family,
    make_cpu_pool,
    make_gpu_pool,
    make_tpu_pool,
    topology_chips,
)
from training_operator_tpu_torch.scheduler.packer import SCALE_SHAPES
from training_operator_tpu_torch.scheduler.snapshot import (
    ClusterSnapshot,
    GangRequest,
    Group,
    GroupMeta,
    Placement,
    PodRequest,
    gang_usage,
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


def job_request(spec, creation_time: float = 0.0) -> GangRequest:
    """One job of `build_workload` as its gang: `workers` pods named as the
    operator names them (`<job>-worker-<i>`); a jax job's pods take 1 cpu
    and one host's 4 chips on the v5e family, a gpu job's 2 cpus and its
    GPUs, a cpu job's its cores; the declared duration is the estimate."""
    kind, name, shape, workers, num_slices, _dur, declared = spec
    if kind == "jax":
        resources = {"cpu": 1.0, TPU_RESOURCE: 4.0}
        topology, tpu_type = shape, accel_family(f"v5e-{topology_chips(shape)}")
    else:
        resources = ({"cpu": 2.0, GPU_RESOURCE: shape} if kind == "gpu" else {"cpu": shape})
        topology, tpu_type, num_slices = None, "", 1
    pods = [PodRequest(name=f"{name}-worker-{i}", replica_type="Worker", index=i,
                       resources=dict(resources)) for i in range(workers)]
    return GangRequest(group=Group(GroupMeta(name=name, creation_time=creation_time)),
                       pods=pods, topology=topology, num_slices=num_slices, tpu_type=tpu_type,
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
        out.append(GangRequest(group=Group(GroupMeta(name=f"scale-{i}",
                                                     creation_time=float(i) * 0.001)),
                               pods=pods, topology=topo, num_slices=1, tpu_type="v5e"))
    return out


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
            snapshot = ClusterSnapshot(nodes, used, inventory_gen=inventory_gen)
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
