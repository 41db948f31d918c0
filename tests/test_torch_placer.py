"""The port's placer against the JAX package's, on the CPU.

training_operator_tpu_torch/scheduler/packer.py's `TPUPacker` (the "torch"
arm on CPU tensors, and the "numpy" arm) must give exactly the placements
of JAX `TPUPacker(kernel="jax")`, whose own "numpy" arm gives the same:
assignments, slices used, reserved nodes and score, gang by gang, cycle by
cycle. The placer is integer arithmetic and sorting, so equality is exact.

- the copies the placer reads: topology parsing, taints and tolerations,
  the candidate enumeration, the pool functions, the snapshot's free
  capacity and slices, the burst workload and its gang requests;
- tests/test_scheduler.py's packer cases (placement, distinct slices, 8x8
  slices, weighted SJF, drain pre-assignment and sticky reservation across
  cycles, estimate robustness, NVLink locality) through the JAX suite's own
  fixtures, the port given JAX's snapshots and requests and, apart, its own
  snapshots and requests built from the same cluster;
- random pools with partial occupancy, taints and multi-slice gangs over
  several cycles, with arrivals, releases and a taint change;
- the torch arm's resident candidates after a class is added and after a
  host is tainted between two cycles;
- the device rule, and `burst.replay` at a reduced pool.

Each placer gets request objects of its own: both packages' placers stamp
memos on the requests they are given.
"""

import random

import numpy as np
import pytest
import torch

import bench
import test_scheduler as jax_cases
from training_operator_tpu.api.jobs import ObjectMeta
from training_operator_tpu.cluster import inventory as jinv
from training_operator_tpu.cluster import objects as jobj
from training_operator_tpu.cluster.runtime import Cluster, VirtualClock
from training_operator_tpu.controllers import OperatorManager, register_all
from training_operator_tpu.scheduler import candidates as jcand
from training_operator_tpu.scheduler import snapshot as jsnap
from training_operator_tpu.scheduler.packer import TPUPacker as JaxPacker
from training_operator_tpu_torch.api.jobs import ObjectMeta as PortObjectMeta
from training_operator_tpu_torch.cluster import inventory
from training_operator_tpu_torch.cluster import objects as pobj
from training_operator_tpu_torch.scheduler import burst, candidates, packer, snapshot

TPU = jinv.TPU_RESOURCE
GPU = jinv.GPU_RESOURCE


# -- conversions: JAX objects to the port's ---------------------------------

def port_node(n):
    acc = n.accelerator
    return pobj.Node(
        metadata=PortObjectMeta(name=n.name, namespace=n.metadata.namespace,
                                labels=dict(n.metadata.labels)),
        capacity=dict(n.capacity),
        accelerator=pobj.AcceleratorInfo(
            kind=acc.kind, chips=acc.chips, tpu_type=acc.tpu_type, tpu_slice=acc.tpu_slice,
            slice_topology=acc.slice_topology,
            ici_coords=None if acc.ici_coords is None else list(acc.ici_coords),
            nvlink_domain=acc.nvlink_domain),
        unschedulable=n.unschedulable, taints=[dict(t) for t in n.taints],
        conditions=[dict(c) for c in n.conditions])


def port_group(name, namespace="default", creation_time=None):
    return pobj.PodGroup(metadata=PortObjectMeta(name=name, namespace=namespace,
                                                 creation_time=creation_time))


def port_request(r):
    meta = r.group.metadata
    return snapshot.GangRequest(
        group=port_group(r.group.name, r.group.namespace, meta.creation_time),
        pods=[snapshot.PodRequest(p.name, p.replica_type, p.index, dict(p.resources),
                                  [dict(t) for t in p.tolerations]) for p in r.pods],
        topology=r.topology, num_slices=r.num_slices, tpu_type=r.tpu_type,
        tolerations=[dict(t) for t in r.tolerations], expected_duration=r.expected_duration)


def port_snapshot(api):
    """The port's snapshot of what JAX's ClusterSnapshot(api) sees: the
    nodes, and the bound pods' resources as usage."""
    usage = [(p.resources(), p.node_name) for p in api.list("Pod")
             if p.node_name and not p.is_terminal()]
    return burst.usage_snapshot([port_node(n) for n in api.list("Node")], usage)


def norm(out):
    return {k: None if p is None else (p.assignments, p.slices_used, p.reserved_nodes, p.score)
            for k, p in out.items()}


def jax_arm(**kw):
    return JaxPacker(kernel="jax", **kw)


def jax_numpy_arm(**kw):
    return JaxPacker(kernel="numpy", **kw)


def torch_arm(**kw):
    return packer.TPUPacker(device="cpu", **kw)


def numpy_arm(**kw):
    return packer.TPUPacker(kernel="numpy", **kw)


# -- the copies ----------------------------------------------------------------

TOPOLOGIES = ["4x4", "2x4", "1x4", "4x2", "8x8", "4x8", "2x2", "8", "2x2x4", "2x2x2", "1x2",
              "4x4x4", "16x16"]
GEOMETRIES = [("4x4", 4), ("8x8", 4), ("2x2x4", 4), ("8x2", 4), ("4x4x8", 8), ("16x16", 4),
              ("2x4", 8)]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: f"{g[0]}/{g[1]}")
def test_candidates_equal_jax(geometry):
    topo, cph = geometry
    assert candidates.host_grid_dims(topo, cph) == jcand.host_grid_dims(topo, cph)
    cache, jcache = candidates.CandidateCache(), jcand.CandidateCache()
    for req in TOPOLOGIES:
        got, want = candidates.enumerate_candidates(topo, cph, req), jcand.enumerate_candidates(
            topo, cph, req)
        assert (got is None) == (want is None), req
        if want is not None:
            assert (got.hosts_per_slice, got.masks, got.origin_rank) == (
                want.hosts_per_slice, want.masks, want.origin_rank), req
        hosts = int(np.prod(jcand.host_grid_dims(topo, cph) or [1]))
        for pad in (packer.next_pow2(hosts), 2 * packer.next_pow2(hosts)):
            (m, r), (jm, jr) = cache.get_arrays(topo, cph, req, pad), jcache.get_arrays(
                topo, cph, req, pad)
            if jm is None:
                assert m is None and r is None
            else:
                np.testing.assert_array_equal(m, jm)
                np.testing.assert_array_equal(r, jr)


def test_topology_and_taint_copies_equal_jax():
    rng = random.Random(3)
    for topo in TOPOLOGIES:
        assert inventory.parse_topology(topo) == jinv.parse_topology(topo)
        assert inventory.topology_chips(topo) == jinv.topology_chips(topo)
        for cph in (1, 4, 8):
            assert snapshot.topology_hosts_per_slice(topo, cph) == \
                jsnap.topology_hosts_per_slice(topo, cph)
    for acc in ("v5e-8", "v4", "v5p-128"):
        assert inventory.accel_family(acc) == jinv.accel_family(acc)
    keys, values = ["maint", "gpu", ""], ["a", "b", None]
    effects = ["NoSchedule", "NoExecute", "PreferNoSchedule", None]

    def item(kind):
        t = {"key": rng.choice(keys), "effect": rng.choice(effects)}
        if rng.random() < 0.5:
            t["value"] = rng.choice(values)
        if kind == "tol":
            t["operator"] = rng.choice(["Equal", "Exists"])
        return {k: v for k, v in t.items() if v is not None}

    for _ in range(400):
        taints = [item("taint") for _ in range(rng.randint(0, 3))]
        tols = [item("tol") for _ in range(rng.randint(0, 3))]
        assert pobj.tolerates(taints, tols) == jobj.tolerates(taints, tols)
        for t in tols:
            assert pobj.toleration_key(t) == jobj.toleration_key(t)


def test_pool_functions_equal_jax():
    want = (jinv.make_tpu_pool(bench.TPU_SLICES, slice_topology=bench.SLICE_TOPOLOGY)
            + jinv.make_gpu_pool(bench.GPU_NODES, gpus_per_node=bench.GPUS_PER_NODE,
                                 nodes_per_nvlink_domain=4)
            + jinv.make_cpu_pool(bench.CPU_NODES, cpu_per_node=bench.CPU_PER_NODE))
    assert burst.burst_pool() == [port_node(n) for n in want]
    for args in ((2, "8x8", 4, "v5p", "big"), (3, "2x2x4", 4, "v4", "v4")):
        assert inventory.make_tpu_pool(*args) == [port_node(n) for n in jinv.make_tpu_pool(*args)]
    with pytest.raises(ValueError):
        inventory.make_tpu_slice("s", "4x3", 4)


def test_snapshot_equals_jax():
    """Free capacity and slices: bound pods, a cordoned node, a node that is
    not ready, a tainted host; and the queries on every node."""
    cluster = Cluster(VirtualClock())
    cluster.add_nodes(jinv.make_tpu_pool(3) + jinv.make_gpu_pool(3) + jinv.make_cpu_pool(2))
    api = cluster.api
    for name, patch in (("slice-1-host-2", lambda n: setattr(n, "unschedulable", True)),
                        ("gpu-1", lambda n: n.conditions.append(
                            {"type": "Ready", "status": "False"})),
                        ("slice-2-host-0", lambda n: n.taints.append(
                            {"key": "maint", "effect": "NoSchedule"}))):
        node = api.get("Node", "", name)
        patch(node)
        api.update(node)
    for i, (node, res) in enumerate((("slice-0-host-1", {TPU: 4.0, "cpu": 1.0}),
                                     ("slice-2-host-3", {TPU: 2.0}),
                                     ("gpu-0", {GPU: 3.0, "cpu": 7.5}),
                                     ("gpu-1", {GPU: 8.0}),
                                     ("cpu-1", {"cpu": 63.0}))):
        p = jobj.Pod(metadata=ObjectMeta(name=f"busy-{i}", namespace="default"))
        p.spec.containers = [jax_cases.Container(name="c", resources=res)]
        p.node_name = node
        p.status.phase = jobj.PodPhase.RUNNING
        api.create(p)
    want, got = jsnap.ClusterSnapshot(api), port_snapshot(api)
    assert got.free == dict(want.free)
    assert {k: (s.slice_id, s.tpu_type, s.topology, s.chips_per_host, s.host_nodes)
            for k, s in got.slices.items()} == {
        k: (s.slice_id, s.tpu_type, s.topology, s.chips_per_host, s.host_nodes)
        for k, s in want.slices.items()}
    tol = [{"key": "maint", "operator": "Exists"}]
    for n in want.nodes:
        assert got.host_free(n, 4) == want.host_free(n, 4)
        assert got.fits(n, {"cpu": 8.0}) == want.fits(n, {"cpu": 8.0})
        assert got.tolerated(n, []) == want.tolerated(n, [])
        assert got.tolerated(n, tol) == want.tolerated(n, tol)
    # An admitted gang holds its pods' resources on their nodes.
    held = burst.usage_snapshot(
        got.nodes.values(), burst.gang_usage(
            burst.job_request(("jax", "j", "1x4", 1, 1, "30", "30")),
            snapshot.Placement({"j-worker-0": "slice-0-host-0"})))
    assert held.free["slice-0-host-0"] == {"cpu": 111.0, "memory": 192.0, TPU: 0.0}
    assert held.free["slice-0-host-3"] == {"cpu": 112.0, "memory": 192.0, TPU: 4.0}


def test_burst_requests_equal_jax_build_gang_request():
    """`burst.build_workload` draws bench.py's specs, and `job_request`
    gives the gang the JAX operator builds from bench.make_job's job."""
    specs = bench.build_workload(100, 0)
    assert burst.build_workload(100, 0) == specs
    cluster = Cluster(VirtualClock())
    mgr = OperatorManager(cluster, gang_enabled=True, reconciles_per_tick=4096)
    register_all(mgr)
    picked = [s for kind in ("jax", "gpu", "cpu") for s in [t for t in specs if t[0] == kind][:12]]
    picked += [s for s in specs if s[4] > 1 and s not in picked][:2]
    for s in picked:
        mgr.submit(bench.make_job(s))
    for _ in range(5):
        cluster.step()
    for s in picked:
        want = jsnap.build_gang_request(cluster.api, cluster.api.get("PodGroup", "default", s[1]))
        got = burst.job_request(s)
        assert got.key == want.key
        assert [(p.name, p.replica_type, p.index, p.resources, p.tolerations) for p in got.pods] \
            == [(p.name, p.replica_type, p.index, p.resources, p.tolerations) for p in want.pods]
        assert (got.topology, got.num_slices, got.tpu_type, got.tolerations,
                got.expected_duration, got.total_chips()) == (
            want.topology, want.num_slices, want.tpu_type, want.tolerations,
            want.expected_duration, want.total_chips())


# -- tests/test_scheduler.py's cases -------------------------------------------

def _busy(cluster, nodes, res=None):
    for i, node in enumerate(nodes):
        p = jobj.Pod(metadata=ObjectMeta(name=f"busy-{i}", namespace="default"))
        p.spec.containers = [jax_cases.Container(name="c", resources=res or {TPU: 4.0})]
        p.node_name = node
        p.status.phase = jobj.PodPhase.RUNNING
        cluster.api.create(p)


def _env(slices=2, topology="4x4", gpu_nodes=0):
    cluster = Cluster(VirtualClock())
    if slices:
        cluster.add_nodes(jinv.make_tpu_pool(slices, slice_topology=topology))
    if gpu_nodes:
        cluster.add_nodes(jinv.make_gpu_pool(gpu_nodes, gpus_per_node=8,
                                             nodes_per_nvlink_domain=4))
    mgr = OperatorManager(cluster, gang_enabled=True)
    register_all(mgr)
    return cluster, mgr


def _request(cluster, mgr, job, created=0.0):
    mgr.submit(job)
    for _ in range(3):
        cluster.step()
    pg = cluster.api.get("PodGroup", "default", job.name)
    pg.metadata.creation_time = created
    return pg


def _declared(job, seconds):
    for spec in job.replica_specs.values():
        spec.template.annotations[jsnap.ANNOTATION_EXPECTED_DURATION] = str(seconds)
    return job


def _gpu_job(name, workers, gpus):
    t = jax_cases.PodTemplateSpec(containers=[jax_cases.Container(
        name="pytorch", image="trainer", resources={"cpu": 1.0, GPU: gpus})])
    return jax_cases.PyTorchJob(metadata=ObjectMeta(name=name), replica_specs={
        "Worker": jax_cases.ReplicaSpec(replicas=workers, template=t)})


class World:
    """One cluster and its pending groups; each placer takes its own
    requests and snapshots of it, as JAX objects or as the port's."""

    def __init__(self, cluster, groups):
        self.cluster, self.groups = cluster, groups

    def requests(self, view):
        # build_gang_request keeps the group given, with the creation time
        # the case set on it.
        reqs = [jsnap.build_gang_request(self.cluster.api, pg) for pg in self.groups]
        return reqs if view == "jax" else [port_request(r) for r in reqs]

    def snapshot(self, view):
        api = self.cluster.api
        return jsnap.ClusterSnapshot(api) if view == "jax" else port_snapshot(api)


def case_contiguity():
    cluster, mgr = _env(slices=1)
    _busy(cluster, ["slice-0-host-1", "slice-0-host-3"])
    return World(cluster, [_request(cluster, mgr, jax_cases.make_jax_job("frag", 2, "2x4"))]), \
        [None], {}


def case_best_fit():
    cluster, mgr = _env(slices=2)
    _busy(cluster, ["slice-0-host-0"])
    return World(cluster, [_request(cluster, mgr, jax_cases.make_jax_job("small", 1, "1x4"))]), \
        [None], {}


def case_distinct_slices():
    cluster, mgr = _env(slices=2)
    job = jax_cases.make_jax_job("ring", 4, "2x4", num_slices=2)
    return World(cluster, [_request(cluster, mgr, job)]), [None], {}


def case_generic_not_on_tpu_hosts():
    cluster, mgr = _env(slices=1)
    t = jax_cases.PodTemplateSpec(containers=[jax_cases.Container(
        name="pytorch", image="img", resources={"cpu": 1.0})])
    job = jax_cases.PyTorchJob(metadata=ObjectMeta(name="cpu-gang"), replica_specs={
        "Worker": jax_cases.ReplicaSpec(replicas=2, template=t)})
    return World(cluster, [_request(cluster, mgr, job)]), [None], {}


def case_8x8_slices():
    cluster, mgr = _env(slices=2, topology="8x8")
    groups = [_request(cluster, mgr, jax_cases.make_jax_job(f"big-{i}", 4, "4x4"))
              for i in range(4)]
    groups += [_request(cluster, mgr, jax_cases.make_jax_job(f"small-{i}", 2, "2x4"))
               for i in range(4)]
    return World(cluster, groups), [None, 0.0], {}


def case_wsjf():
    cluster, mgr = _env(slices=1)
    _busy(cluster, ["slice-0-host-0", "slice-0-host-3"])
    groups = [
        _request(cluster, mgr, _declared(jax_cases.make_jax_job("small-long", 1, "1x4"), 120)),
        _request(cluster, mgr, _declared(jax_cases.make_jax_job("big-short", 2, "2x4"), 30)),
    ]
    return World(cluster, groups), [0.0], {}


def case_aging():
    cluster, mgr = _env(slices=1)
    _busy(cluster, ["slice-0-host-0"])
    groups = [_request(cluster, mgr, jax_cases.make_jax_job("fresh-small", 1, "1x4"), 290.0),
              _request(cluster, mgr, jax_cases.make_jax_job("old-sub", 2, "2x4"), 0.0)]
    return World(cluster, groups), [301.0], {"aging_seconds": 300.0}


def case_drain_preassign():
    cluster, mgr = _env(slices=1)
    groups = [_request(cluster, mgr, jax_cases.make_jax_job("big", 4, "4x4"), 0.0)]
    groups += [_request(cluster, mgr, jax_cases.make_jax_job(f"small-{i}", 1, "1x4"), 500.0)
               for i in range(4)]
    return World(cluster, groups), [500.0], {"drain_reserve_seconds": 150.0}


def case_drain_sticky():
    cluster, mgr = _env(slices=1)
    _busy(cluster, ["slice-0-host-0"])
    groups = [_request(cluster, mgr, jax_cases.make_jax_job("big", 4, "4x4"), 0.0),
              _request(cluster, mgr, jax_cases.make_jax_job("small", 1, "1x4"), 500.0)]
    return World(cluster, groups), [500.0, 510.0], {"drain_reserve_seconds": 150.0}


def case_drain_disabled():
    cluster, mgr = _env(slices=1)
    return World(cluster, [_request(cluster, mgr, jax_cases.make_jax_job("big", 4, "4x4"))]), \
        [500.0], {"drain_reserve_seconds": 0}


def case_drain_multi_slice():
    cluster, mgr = _env(slices=2)
    _busy(cluster, ["slice-1-host-0"])
    groups = [_request(cluster, mgr, jax_cases.make_jax_job("multi", 8, "4x4", num_slices=2)),
              _request(cluster, mgr, jax_cases.make_jax_job("small", 1, "1x4"), 500.0)]
    # The second call: the multi-slice gang is gone, the reservation clears.
    return World(cluster, groups), [500.0, (510.0, {"small"})], \
        {"drain_reserve_seconds": 150.0, "max_drain_fraction": 0.5}


def case_estimates():
    cluster, mgr = _env(slices=1)
    _busy(cluster, ["slice-0-host-0"])
    groups = [
        _request(cluster, mgr, _declared(jax_cases.make_jax_job("long", 1, "1x4"), 1000)),
        _request(cluster, mgr, jax_cases.make_jax_job("nodecl", 1, "1x4")),
        _request(cluster, mgr, _declared(jax_cases.make_jax_job("short", 1, "1x4"), 10)),
        _request(cluster, mgr, _declared(jax_cases.make_jax_job("short2", 1, "1x4"), 20)),
    ]
    return World(cluster, groups), [1.0], {"default_expected_duration": 600.0}


def case_nvlink_locality():
    cluster, mgr = _env(slices=0, gpu_nodes=8)
    _busy(cluster, ["gpu-4", "gpu-5"], {GPU: 4.0, "cpu": 1.0})
    groups = [_request(cluster, mgr, _gpu_job("ddp", 4, 8.0)),
              _request(cluster, mgr, _gpu_job("half", 3, 4.0), 5.0)]
    return World(cluster, groups), [10.0], {}


CASES = [case_contiguity, case_best_fit, case_distinct_slices, case_generic_not_on_tpu_hosts,
         case_8x8_slices, case_wsjf, case_aging, case_drain_preassign, case_drain_sticky,
         case_drain_disabled, case_drain_multi_slice, case_estimates, case_nvlink_locality]


def run_case(world, calls, kw, make, view):
    """One placer, its own requests, one fresh snapshot per call (the drain
    set and caches carry over). A call is a time, or (time, the names of
    the groups still pending). Returns each call's placements, drain set
    and drain stats, and the order `_order` gives all the requests."""
    placer = make(**kw)
    reqs = world.requests(view)
    out = []
    for call in calls:
        now, names = call if isinstance(call, tuple) else (call, None)
        pend = [r for r in reqs if names is None or r.group.name in names]
        placements = norm(placer.place(pend, world.snapshot(view), now=now))
        out.append((placements, sorted(placer._drain_set), placer.last_drain_stats))
    order = [r.group.name for r in placer._order(reqs, now, lambda r: r.total_chips())]
    return out, order


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_scheduler_cases_equal_jax(case):
    world, nows, kw = case()
    want = run_case(world, nows, kw, jax_arm, "jax")
    assert run_case(world, nows, kw, jax_numpy_arm, "jax") == want
    assert any(p is not None for call in want[0] for p in call[0].values()) or case in (
        case_contiguity, case_generic_not_on_tpu_hosts, case_drain_sticky)
    for make in (torch_arm, numpy_arm):
        for view in ("jax", "port"):
            assert run_case(world, nows, kw, make, view) == want, (make.__name__, view)


def test_scheduler_case_outcomes():
    """The port shows the JAX suite's outcomes in its own terms."""
    world, nows, kw = case_contiguity()
    (call,), _ = run_case(world, nows, kw, torch_arm, "port")
    assert call[0] == {"default/frag": None}
    world, nows, kw = case_best_fit()
    (call,), _ = run_case(world, nows, kw, torch_arm, "port")
    assert list(call[0]["default/small"][0].values())[0].startswith("slice-0")
    world, nows, kw = case_distinct_slices()
    (call,), _ = run_case(world, nows, kw, torch_arm, "port")
    assert sorted(call[0]["default/ring"][1]) == ["slice-0", "slice-1"]
    world, nows, kw = case_drain_multi_slice()
    calls, _ = run_case(world, nows, kw, torch_arm, "port")
    assert calls[0][0] == {"default/multi": None, "default/small": None}
    assert calls[0][1] == ["slice-0", "slice-1"]
    assert calls[1][0]["default/small"] is not None and calls[1][1] == []
    world, nows, kw = case_estimates()
    _, order = run_case(world, nows, kw, torch_arm, "port")
    assert order[0] == "short" and order.index("nodecl") < order.index("long")
    world, nows, kw = case_nvlink_locality()
    (call,), _ = run_case(world, nows, kw, torch_arm, "port")
    nodes = set(call[0]["default/ddp"][0].values())
    assert len(nodes) == 4 and len({int(n.split("-")[1]) // 4 for n in nodes}) == 1


# -- random pools over several cycles ----------------------------------------

def random_world(seed):
    """Six slices (four 4x4 v5e, two 8x8 v5p), GPU and CPU nodes, a few
    tainted hosts, and 60 gangs: sub-slice, whole-slice and multi-slice TPU
    gangs (some tolerating the taint, some pinned to a family), GPU and CPU
    gangs; random estimates and creation times."""
    rng = random.Random(seed)
    jnodes = (jinv.make_tpu_pool(4) + jinv.make_tpu_pool(2, "8x8", 4, "v5p", "big")
              + jinv.make_gpu_pool(6, nodes_per_nvlink_domain=2) + jinv.make_cpu_pool(2))
    for n in rng.sample([n for n in jnodes if n.accelerator.kind != ""], 4):
        n.taints.append({"key": "maint", "effect": "NoSchedule"})
    tol = [{"key": "maint", "operator": "Exists"}]
    shapes = [("1x4", 1, 1), ("2x4", 2, 1), ("4x4", 4, 1), ("1x4", 3, 3), ("4x4", 8, 2),
              ("2x4", 4, 2), ("8x8", 16, 1), ("4x8", 8, 1)]
    specs = []
    for i in range(60):
        created = float(rng.randint(0, 400))
        expected = rng.choice([None, 30.0, 60.0, 300.0])
        r = rng.random()
        if r < 0.7:
            topo, pods, ns = rng.choice(shapes)
            specs.append(("tpu", f"g{i}", topo, pods, ns, rng.choice(["", "v5e", "v5p"]),
                          tol if rng.random() < 0.3 else [], created, expected))
        else:
            gpu = r < 0.85
            res = ({"cpu": 1.0, GPU: rng.choice([2.0, 4.0, 8.0])} if gpu
                   else {"cpu": float(rng.choice([8, 32, 64]))})
            specs.append(("generic", f"g{i}", res, rng.randint(1, 4), 1, "",
                          tol if rng.random() < 0.3 else [], created, expected))
    return jnodes, specs


def build_requests(specs, port):
    out = []
    for kind, name, what, pods, ns, tpu_type, tols, created, expected in specs:
        res = {"cpu": 1.0, TPU: 4.0} if kind == "tpu" else what
        preqs = [(f"{name}-worker-{j}", "Worker", j, dict(res), [dict(t) for t in tols])
                 for j in range(pods)]
        topology = what if kind == "tpu" else None
        if port:
            group = port_group(name, creation_time=created)
            out.append(snapshot.GangRequest(group, [snapshot.PodRequest(*p) for p in preqs],
                                            topology, ns, tpu_type, [dict(t) for t in tols],
                                            expected))
        else:
            group = jobj.PodGroup(metadata=ObjectMeta(name=name, namespace="default"))
            group.metadata.creation_time = created
            out.append(jsnap.GangRequest(group, [jsnap.PodRequest(*p) for p in preqs],
                                         topology, ns, tpu_type, [dict(t) for t in tols],
                                         expected))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_random_cycles_equal_jax(seed):
    """Seven cycles: 40 gangs pending at first, ten more arriving each
    cycle; admitted gangs run for 1-3 cycles; before cycle 4 one host's
    taint is lifted and another host is tainted (a new inventory
    generation). JAX runs on its own snapshots and requests, the port on
    its own."""
    rng = random.Random(100 + seed)
    jnodes, specs = random_world(seed)
    pnodes = [port_node(n) for n in jnodes]
    placers = [(jax_arm(), False), (jax_numpy_arm(), False), (torch_arm(), True),
               (numpy_arm(), True)]
    reqs = [build_requests(specs, port) for _, port in placers]
    pending = [r[:40] for r in reqs]
    usage, ends, gen, now, admitted = {}, {}, 1, 400.0, 0
    for cycle in range(7):
        if cycle == 3:
            gen += 1
            tainted = [i for i, n in enumerate(jnodes) if n.taints]
            fresh = [i for i, n in enumerate(jnodes) if not n.taints and n.accelerator.kind]
            for i in (rng.choice(tainted),):
                jnodes[i].taints.clear()
                pnodes[i].taints.clear()
            i = rng.choice(fresh)
            jnodes[i].taints.append({"key": "maint", "effect": "NoSchedule"})
            pnodes[i].taints.append({"key": "maint", "effect": "NoSchedule"})
        used = [u for us in usage.values() for u in us]
        outs = []
        for (placer, port), pend in zip(placers, pending):
            if port:
                snap = burst.usage_snapshot(pnodes, used, inventory_gen=gen)
            else:
                snap = jsnap.ClusterSnapshot(None, bound_pods=[], podgroups=[], nodes=jnodes)
                for res, node in used:
                    snap.commit(res, node)
                snap.inventory_gen = gen
            outs.append(norm(placer.place(pend, snap, now=now)))
        for out in outs[1:]:
            assert out == outs[0], cycle
        for r in pending[2]:
            got = outs[0][r.key]
            if got is not None:
                usage[r.key] = [(p.resources, got[0][p.name]) for p in r.pods]
                ends[r.key] = cycle + rng.randint(1, 3)
                admitted += 1
        pending = [[r for r in pend if outs[0][r.key] is None] for pend in pending]
        arrive = slice(40 + 10 * cycle, 50 + 10 * cycle)
        pending = [pend + r[arrive] for pend, r in zip(pending, reqs)]
        for key in [k for k, e in ends.items() if e == cycle + 1]:
            del usage[key], ends[key]
        now += rng.choice([5.0, 60.0, 200.0])
    assert admitted >= 20


# -- the torch arm's resident candidates -------------------------------------

def test_resident_candidates_follow_the_cache():
    """The torch arm keys its candidate tensors by each build of the cache's
    arrays: a class appended with the padded class and candidate axes and
    the inventory generation unchanged, and a host tainted between two
    cycles (a new generation, padded axes unchanged), must each reach the
    solve. Cycle by cycle against the numpy arm and JAX's jit arm."""
    nodes = inventory.make_tpu_pool(4)
    jnodes = jinv.make_tpu_pool(4)
    base = [("tpu", "a", "1x4", 1, 1, "", [], 0.0, 60.0), ("tpu", "b", "2x4", 2, 1, "", [], 1.0,
                                                          60.0),
            ("tpu", "c", "4x4", 4, 1, "", [], 2.0, 60.0)]
    # Same shape as "a", another toleration signature: a fourth class.
    tol_class = ("tpu", "d", "1x4", 1, 1, "", [{"key": "x", "operator": "Exists"}], 3.0, 60.0)
    after_taint = ("tpu", "e", "1x4", 1, 1, "", [], 4.0, 60.0)
    busy = [({TPU: 4.0}, f"slice-0-host-{h}") for h in (1, 2, 3)]
    torch_p, numpy_p, jax_p = torch_arm(), numpy_arm(), jax_arm()
    uploads = []
    for gen, specs in ((1, base), (1, [tol_class]), (2, [after_taint])):
        if gen == 2:
            for ns in (nodes, jnodes):
                ns[0].taints.append({"key": "maint", "effect": "NoSchedule"})  # slice-0-host-0
        outs = []
        for placer, port in ((torch_p, True), (numpy_p, True), (jax_p, False)):
            snap = burst.usage_snapshot(nodes if port else [port_node(n) for n in jnodes],
                                        busy, inventory_gen=gen)
            outs.append(norm(placer.place(build_requests(specs, port), snap, now=10.0)))
        assert outs[0] == outs[1] == outs[2]
        assert all(p is not None for p in outs[0].values()), outs[0]
        assert torch_p.solver.last_stats["padded"][1:] == (4, 16)
        uploads.append(torch_p.solver._cands[0][0])
    assert len(set(uploads)) == 3
    # Best-fit would take the one free host of the fullest slice, were it
    # not tainted: the fourth class went there in cycle 2; now nothing may.
    assert outs[0]["default/e"][0] != {"e-worker-0": "slice-0-host-0"}


# -- the device rule and the replay ------------------------------------------

def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packer.TPUPacker()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packer.TPUPacker(device="cuda")
    assert packer.TPUPacker(device="cpu").device == torch.device("cpu")
    assert packer.TPUPacker(kernel="numpy").device is None
    with pytest.raises(ValueError, match="unknown solver kernel"):
        packer.TPUPacker(kernel="jax")


def test_burst_replay_arms_agree():
    """burst.replay at a reduced pool (8 slices, 4 GPU nodes, 2 CPU nodes,
    100 jobs): the torch arm, the numpy arm and JAX's two arms (on the
    port's objects) agree in every cycle, and every gang is admitted."""
    specs = burst.build_workload(100, 0)
    nodes = burst.burst_pool(8, 4, 2)
    out = burst.replay([torch_arm(), numpy_arm(), jax_arm(), jax_numpy_arm()], nodes, specs)
    assert out["admitted"] == 100 and out["cycles"] > 50
    assert len(out["rounds"]) > 0 and min(out["rounds"]) >= 1 and max(out["rounds"]) >= 2
    assert all(len(ms) == out["cycles"] for ms in out["place_ms"])
    with pytest.raises(AssertionError, match="differs from placer 0"):
        burst.replay([torch_arm(), numpy_arm(discipline="fifo")], nodes, specs)
