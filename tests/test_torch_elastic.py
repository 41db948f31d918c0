"""Elasticity, the incremental snapshot and the job API: port against JAX, on the CPU.

Each scenario runs on the JAX package's stack (its default `TPUPacker`, the
numpy arm) and on the port's, once with the port's torch arm on CPU tensors
and once with its numpy arm, and records the state after each step:

- tests/test_elastic.py's HPA-driven growth of an elastic PyTorchJob
  (members keep their nodes, the new ones join the gang's NVLink domain),
  its shrink back (placement entries released), and a JAXJob grown by one
  whole slice (the gang re-admitted on two slices, every pod restarted).
  These run `repack_grown_gangs` and `_resize_tpu_gang` through the port's
  placer. The pods with their nodes and phases, the PodGroup and the job's
  replica count must be equal at each step;
- tests/test_solver_incremental.py's random churn with one node lost and
  recovered: the port's `SnapshotMaintainer` holds to a cold rebuild
  (`selfcheck` every solve cycle) and to JAX's maintainer, whose free map
  and free-host tallies must be equal after every cluster step. The JAX
  test loses the node through the node lifecycle controller and NodeChaos,
  which the port does not have yet; here the same steps (heartbeat silenced,
  NotReady with the unreachable taint, eviction, recovery) are written at
  the times that controller would take them;
- `default_job` and `validate_job` on a table of valid and invalid jobs.
"""

import random

import pytest

from test_torch_operator import JAX, PORT, norm, stack
from training_operator_tpu.scheduler.packer import TPUPacker as JaxPacker
from training_operator_tpu_torch.scheduler import packer

ARMS = [(JAX, lambda: JaxPacker()), (PORT, lambda: packer.TPUPacker(device="cpu")),
        (PORT, lambda: packer.TPUPacker(kernel="numpy"))]


def state(S, cluster, name, kind):
    """The job's pods (node, phase), its PodGroup and its replica count."""
    api = cluster.api
    pods = {p.name: (p.node_name, p.status.phase.value)
            for p in api.list("Pod", "default", {S.common.JOB_NAME_LABEL: name})}
    pg = api.get("PodGroup", "default", name)
    job = api.get(kind, "default", name)
    return {"t": cluster.clock.now(), "pods": pods,
            "group": (dict(pg.placement), list(pg.reserved_nodes), pg.min_member,
                      pg.num_slices, pg.phase.value),
            "replicas": job.replica_specs["Worker"].replicas}


def running(S, cluster, name):
    return [p for p in cluster.api.list("Pod", "default", {S.common.JOB_NAME_LABEL: name})
            if p.status.phase == S.objects.PodPhase.RUNNING]


def elastic_env(S, placer):
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    cluster.add_nodes(S.inventory.make_gpu_pool(8, gpus_per_node=8, nodes_per_nvlink_domain=4))
    S.runtime.DefaultScheduler(cluster)
    S.runtime.SimKubelet(cluster)
    metrics = S.elastic.StaticMetricsSource()
    S.elastic.HorizontalAutoscaler(cluster, metrics, sync_period=5.0, stabilization_seconds=10.0)
    S.gang.GangScheduler(cluster, placer)
    mgr = S.controllers.OperatorManager(cluster, gang_enabled=True)
    S.controllers.register_all(mgr)
    return cluster, mgr, metrics


def elastic_job(S, min_r, max_r):
    t = S.common.PodTemplateSpec(containers=[S.common.Container(
        name="pytorch", image="img", resources={"cpu": 1.0, S.inventory.GPU_RESOURCE: 8.0})])
    return S.jobs.PyTorchJob(
        metadata=S.jobs.ObjectMeta(name="el"),
        replica_specs={"Worker": S.common.ReplicaSpec(replicas=min_r, template=t)},
        elastic_policy=S.jobs.ElasticPolicy(min_replicas=min_r, max_replicas=max_r,
                                            metrics=[{"name": "gpu_util", "target": 70.0}]))


def scale(S, placer, max_r, utils):
    """An elastic job of 2 GPU workers; after it runs, each utilisation in
    turn until the running count reaches its HPA target."""
    cluster, mgr, metrics = elastic_env(S, placer)
    mgr.submit(elastic_job(S, 2, max_r))
    assert cluster.run_until(lambda: len(running(S, cluster, "el")) == 2, timeout=60)
    out = [state(S, cluster, "el", "PyTorchJob")]
    for util, want in utils:
        metrics.set("default", "el", "gpu_util", util)
        assert cluster.run_until(lambda: len(running(S, cluster, "el")) == want, timeout=200)
        out.append(state(S, cluster, "el", "PyTorchJob"))
    return out


def tpu_resize(S, placer):
    """A JAXJob of 2 workers on one 2x4 slice of four, grown to 4 workers."""
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    cluster.add_nodes(S.inventory.make_tpu_pool(4, slice_topology="2x4"))
    S.runtime.DefaultScheduler(cluster)
    S.runtime.SimKubelet(cluster)
    S.gang.GangScheduler(cluster, placer)
    mgr = S.controllers.OperatorManager(cluster, gang_enabled=True)
    S.controllers.register_all(mgr)
    t = S.common.PodTemplateSpec(containers=[S.common.Container(
        name="jax", image="trainer", resources={S.inventory.TPU_RESOURCE: 4.0})])
    mgr.submit(S.jobs.JAXJob(
        metadata=S.jobs.ObjectMeta(name="mesh"),
        replica_specs={"Worker": S.common.ReplicaSpec(replicas=2, template=t)},
        tpu_policy=S.jobs.TPUPolicy(accelerator="v5e-8", topology="2x4", num_slices=1)))
    assert cluster.run_until(lambda: len(running(S, cluster, "mesh")) == 2, timeout=60)
    out = [state(S, cluster, "mesh", "JAXJob")]
    first_gen = {p.metadata.uid for p in running(S, cluster, "mesh")}
    live = cluster.api.get("JAXJob", "default", "mesh")
    live.replica_specs["Worker"].replicas = 4
    cluster.api.update(live)
    assert cluster.run_until(lambda: len(running(S, cluster, "mesh")) == 4, timeout=120)
    out.append(state(S, cluster, "mesh", "JAXJob"))
    pods = running(S, cluster, "mesh")
    out.append({"restarted": first_gen.isdisjoint({p.metadata.uid for p in pods}),
                "env": sorted(p.spec.containers[0].env["NUM_PROCESSES"] for p in pods),
                "job_slices": cluster.api.get("JAXJob", "default", "mesh").tpu_policy.num_slices})
    return out


SCENARIOS = {
    "incremental_repack_keeps_existing_members":
        lambda S, placer: scale(S, placer, 4, [(140.0, 4)]),
    "scale_in_releases_placement_entries":
        lambda S, placer: scale(S, placer, 6, [(140.0, 4), (20.0, 2)]),
    "tpu_gang_resize_restarts_whole_gang": tpu_resize,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_elastic_equals_jax(name):
    runs = [SCENARIOS[name](stack(pkg), make()) for pkg, make in ARMS]
    assert runs[1] == runs[0]
    assert runs[2] == runs[0]
    got = runs[1]
    if name == "incremental_repack_keeps_existing_members":
        before, after = got[0]["pods"], got[1]["pods"]
        assert all(after[p][0] == node for p, (node, _) in before.items())
        assert got[1]["group"][2] == 4
        assert len({int(node.split("-")[1]) // 4 for node, _ in after.values()}) == 1
    elif name == "scale_in_releases_placement_entries":
        assert set(got[2]["group"][0]) == {"el-worker-0", "el-worker-1"}
    else:
        assert got[2] == {"restarted": True, "env": ["4"] * 4, "job_slices": 2}
        assert got[1]["group"][3:] == (2, "Running")
        assert len({node.rsplit("-host-", 1)[0] for node, _ in got[1]["pods"].values()}) == 2


# -- the incremental snapshot under churn ---------------------------------------

def churn(S, placer, seed):
    """tests/test_solver_incremental.py's random churn on 3 slices: 6-10
    JAX jobs arriving over 30 s, and slice-1-host-0 lost at t=20 and back
    at t=45. Returns the maintainer's view after every step, the self-check
    mismatches and the jobs' outcomes."""
    rng = random.Random(seed)
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    cluster.add_nodes(S.inventory.make_tpu_pool(3, slice_topology="4x4"))
    cluster.add_nodes(S.inventory.make_cpu_pool(1))
    S.runtime.DefaultScheduler(cluster)
    kubelet = S.runtime.SimKubelet(cluster, heartbeat_interval=2.0)
    sched = S.gang.GangScheduler(cluster, placer, incremental=True, snapshot_selfcheck_every=1)
    mgr = S.controllers.OperatorManager(cluster, gang_enabled=True)
    S.controllers.register_all(mgr)
    jobs = []
    for i in range(rng.randint(6, 10)):
        topo, workers = rng.choice([("1x4", 1), ("2x4", 2), ("4x4", 4)])
        name = f"churn-{seed}-{i}"
        jobs.append(name)
        delay, dur = rng.uniform(0.0, 30.0), rng.randint(5, 40)
        chips = 1
        for d in topo.split("x"):
            chips *= int(d)
        t = S.common.PodTemplateSpec(containers=[S.common.Container(
            name="jax", image="trainer", resources={"cpu": 1.0, S.inventory.TPU_RESOURCE: 4.0})])
        t.annotations[S.runtime.ANNOTATION_SIM_DURATION] = str(dur)
        job = S.jobs.JAXJob(metadata=S.jobs.ObjectMeta(name=name),
                            replica_specs={"Worker": S.common.ReplicaSpec(replicas=workers,
                                                                          template=t)},
                            tpu_policy=S.jobs.TPUPolicy(accelerator=f"v5e-{chips}",
                                                        topology=topo, num_slices=1))
        cluster.schedule_at(delay, (lambda j: lambda: mgr.submit(j))(job))
    victim, api, objects = "slice-1-host-0", cluster.api, S.objects

    def set_ready(ready):
        node = api.get("Node", "", victim)
        objects.set_node_condition(node, objects.NODE_CONDITION_READY,
                                   "True" if ready else "False", "NodeStatus", "",
                                   cluster.clock.now())
        if ready:
            objects.remove_taint(node, objects.TAINT_UNREACHABLE)
        else:
            objects.add_taint(node, objects.TAINT_UNREACHABLE)
        api.update(node, check_version=False)

    def evict():
        for pod in api.list("Pod"):
            if pod.node_name == victim and not pod.is_terminal():
                S.nodelifecycle.evict_pod(api, pod, "node unreachable", cluster.clock.now(), node_name=victim)

    def recover():
        kubelet.recover_node(victim)
        set_ready(True)

    # The heartbeat stops at 20; NotReady one grace period (6 s) later,
    # eviction one toleration (3 s) after that; the node is back at 45.
    cluster.schedule_at(20.0, lambda: kubelet.kill_node(victim))
    cluster.schedule_at(26.0, lambda: set_ready(False))
    cluster.schedule_at(29.0, evict)
    cluster.schedule_at(45.0, recover)
    views = []

    def record():
        m = sched._maintainer
        view = (cluster.clock.now(), {n: dict(f) for n, f in m.free.items()},
                m.free_tpu_hosts, m.whole_free_slices)
        if not views or views[-1][1:] != view[1:]:
            views.append(view)

    cluster.add_ticker(record)

    def all_done():
        return cluster.clock.now() > 50.0 and all(
            S.common.is_finished(api.get("JAXJob", "default", n).status) for n in jobs
            if api.try_get("JAXJob", "default", n) is not None)

    assert cluster.run_until(all_done, timeout=3000)
    outcomes = {n: S.common.is_succeeded(api.get("JAXJob", "default", n).status) for n in jobs}
    return views, sched._maintainer.selfcheck_mismatches, sched.cycles, outcomes


@pytest.mark.parametrize("seed", range(3))
def test_churn_snapshot_equals_rebuild_and_jax(seed):
    want = churn(stack(JAX), JaxPacker(), seed)
    got = churn(stack(PORT), packer.TPUPacker(device="cpu"), seed)
    views, mismatches, cycles, outcomes = got
    assert mismatches == 0, "the incremental snapshot diverged from the cold rebuild"
    assert cycles > 0 and len(views) > 10
    assert all(outcomes.values()), outcomes
    # The node's loss reached the view: its capacity left the free map.
    assert any("slice-1-host-0" not in free for _, free, *_ in views)
    assert got == want


# -- the job API ------------------------------------------------------------------

def api_jobs(S):
    """(case, job) pairs: valid jobs of each kind and one invalid job per
    rule tests/test_api.py covers."""
    c, j = S.common, S.jobs

    def tmpl(name="pytorch", image="img"):
        return c.PodTemplateSpec(containers=[c.Container(name=name, image=image)])

    def pt(name="pt", **kw):
        kw.setdefault("replica_specs", {"Worker": c.ReplicaSpec(replicas=2, template=tmpl())})
        return j.PyTorchJob(metadata=j.ObjectMeta(name=name), **kw)

    return [
        ("pytorch", pt()),
        ("pytorch_unset_replicas", pt(replica_specs={"Master": c.ReplicaSpec(template=tmpl())})),
        ("pytorch_elastic", pt(elastic_policy=j.ElasticPolicy(max_replicas=4))),
        ("jax_tpu", j.JAXJob(metadata=j.ObjectMeta(name="jx"), replica_specs={
            "Worker": c.ReplicaSpec(replicas=4, template=tmpl("jax"))},
            tpu_policy=j.TPUPolicy(accelerator="v5e-16", topology="4x4", num_slices=2,
                                   mesh_axes={"data": 2, "fsdp": 16}))),
        ("tf", j.TFJob(metadata=j.ObjectMeta(name="tf"), replica_specs={
            "Chief": c.ReplicaSpec(replicas=1, template=tmpl("tensorflow")),
            "Worker": c.ReplicaSpec(replicas=2, template=tmpl("tensorflow"))})),
        ("bad_name", pt(name="Bad_Name")),
        ("missing_image", pt(replica_specs={"Worker": c.ReplicaSpec(
            replicas=1, template=tmpl(image=""))})),
        ("no_replica_specs", pt(replica_specs={})),
        ("wrong_replica_type", pt(replica_specs={"Chief": c.ReplicaSpec(template=tmpl())})),
        ("wrong_container_name", j.JAXJob(metadata=j.ObjectMeta(name="jx"), replica_specs={
            "Worker": c.ReplicaSpec(replicas=1, template=tmpl("trainer"))})),
        ("multi_slice_indivisible", j.JAXJob(metadata=j.ObjectMeta(name="jx"), replica_specs={
            "Worker": c.ReplicaSpec(replicas=3, template=tmpl("jax"))},
            tpu_policy=j.TPUPolicy(accelerator="v5e-8", topology="2x4", num_slices=2))),
        ("tf_chief_and_master", j.TFJob(metadata=j.ObjectMeta(name="tf"), replica_specs={
            "Chief": c.ReplicaSpec(replicas=1, template=tmpl("tensorflow")),
            "Master": c.ReplicaSpec(replicas=1, template=tmpl("tensorflow"))})),
        ("elastic_min_above_max", pt(elastic_policy=j.ElasticPolicy(min_replicas=5,
                                                                   max_replicas=2))),
        ("mesh_axes_mismatch", j.JAXJob(metadata=j.ObjectMeta(name="jx"), replica_specs={
            "Worker": c.ReplicaSpec(replicas=2, template=tmpl("jax"))},
            tpu_policy=j.TPUPolicy(accelerator="v5e-8", topology="2x4",
                                   mesh_axes={"data": 3}))),
        ("many_problems", pt(name="", replica_specs={"Chief": c.ReplicaSpec(
            replicas=1, template=tmpl(image=""))},
            elastic_policy=j.ElasticPolicy(min_replicas=5, max_replicas=2))),
    ]


def api_outcomes(S):
    out = {}
    for case, job in api_jobs(S):
        S.defaults.default_job(job, now=12.5)
        try:
            S.validation.validate_job(job)
            errors = None
        except S.validation.ValidationError as e:
            errors = e.errors
        out[case] = (norm(job), errors)
    return out


def test_api_defaults_and_validation_equal_jax():
    want, got = api_outcomes(stack(JAX)), api_outcomes(stack(PORT))
    assert got == want
    assert [k for k, (_, errs) in got.items() if errs is None] == [
        "pytorch", "pytorch_unset_replicas", "pytorch_elastic", "jax_tpu", "tf"]
    assert len(got["many_problems"][1]) >= 3
