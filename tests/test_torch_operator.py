"""The port's operator against the JAX package's, whole stack, on the CPU.

training_operator_tpu_torch's control plane (the job API, the simulated
cluster, the reconcile engine, the JAX, PyTorch and TensorFlow controllers,
the manager and the gang scheduler) is a copy of the JAX package's, and its
placer (`TPUPacker`) solves with torch. Both stacks run the same scenario in
one process (so `hash()` agrees) and must give the same results exactly:

- bench.py's burst of 100 jobs through `OperatorManager.submit` ->
  `JobController` -> `GangScheduler` -> `TPUPacker` at a reduced pool, with
  `charge_solve_time=False` so that wall time does not move the virtual
  clock: every PodGroup's placement, reserved nodes, score and admission
  time, every job's Running and Succeeded times, the scheduler's cycles and
  the solver trace's cycle records. The JAX stack solves with
  `TPUPacker(kernel="jax")`, the port with its torch arm on CPU tensors and
  with its numpy arm;
- tests/test_controllers.py's cases of the three ported kinds: the pods
  with their env and init containers, the services, and the job's
  conditions after each step;
- the operator config's two knobs set in both packages, tests/test_engine.py's
  operator restart mid-burst, and the API server's events, pod logs and
  timelines.

`stack(pkg)` names one package's modules, so each scenario is written once.
"""

import dataclasses
import enum
import importlib
import json
import types

import pytest

import bench
from training_operator_tpu.scheduler.packer import TPUPacker as JaxPacker
from training_operator_tpu_torch.scheduler import burst, packer

JAX, PORT = "training_operator_tpu", "training_operator_tpu_torch"
MODULES = ("api.common", "api.jobs", "api.defaults", "api.validation", "cluster.apiserver",
           "cluster.inventory", "cluster.objects", "cluster.runtime", "config", "controllers",
           "controllers.nodelifecycle", "scheduler.gang", "scheduler.snapshot",
           "scheduler.elastic")


def stack(pkg):
    """One package's modules by their short names (`S.jobs`, `S.runtime`, ...)."""
    return types.SimpleNamespace(**{m.split(".")[-1]: importlib.import_module(f"{pkg}.{m}")
                                    for m in MODULES})


def norm(obj):
    """A value of either package as plain data: dataclasses as dicts without
    uids (each package numbers its own), enums as their values."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: norm(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in ("uid", "owner_uid")}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    return obj


# -- the burst ------------------------------------------------------------------

JOBS, POOL = 100, (8, 4, 2)


def jax_burst(specs, placer, pool=POOL):
    """burst.run_burst's scenario on the JAX package's stack, with
    bench.make_job's jobs and charge_solve_time off."""
    S = stack(JAX)
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    cluster.add_nodes(S.inventory.make_tpu_pool(pool[0], slice_topology=bench.SLICE_TOPOLOGY))
    cluster.add_nodes(S.inventory.make_gpu_pool(pool[1], gpus_per_node=bench.GPUS_PER_NODE,
                                                nodes_per_nvlink_domain=4))
    cluster.add_nodes(S.inventory.make_cpu_pool(pool[2], cpu_per_node=bench.CPU_PER_NODE))
    S.runtime.DefaultScheduler(cluster)
    S.runtime.SimKubelet(cluster)
    sched = S.gang.GangScheduler(cluster, placer, charge_solve_time=False, prewarm=True,
                                 min_solve_interval=0.25, incremental=True)
    mgr = S.controllers.OperatorManager(cluster, gang_enabled=True, reconciles_per_tick=4096)
    S.controllers.register_all(mgr)
    jobs = [bench.make_job(s) for s in specs]
    admitted, running, succeeded, finished = {}, {}, {}, set()
    groups = cluster.api.watch(kinds=("PodGroup",))
    job_events = cluster.api.watch(kinds={j.kind for j in jobs})
    cond = S.common.JobConditionType

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
            c = S.common.get_condition(j.status, cond.RUNNING)
            if j.name not in running and c is not None and c.status:
                running[j.name] = c.last_transition_time
            if S.common.is_finished(j.status):
                finished.add(j.name)
                c = S.common.get_condition(j.status, cond.SUCCEEDED)
                if c is not None and c.status:
                    succeeded.setdefault(j.name, c.last_transition_time)

    cluster.add_ticker(track)
    for j in jobs:
        mgr.submit(j)
    assert cluster.run_until(lambda: len(finished) >= len(jobs), timeout=50_000,
                             max_steps=5_000_000)
    return {"admitted": admitted, "running": running, "succeeded": succeeded,
            "cycles": sched.cycles, "trace": sched.dump_trace()}


def test_burst_through_the_port_stack_equals_jax():
    specs = bench.build_workload(JOBS, 0)
    want = jax_burst(specs, JaxPacker(kernel="jax"))
    arms = (packer.TPUPacker(device="cpu"), packer.TPUPacker(kernel="numpy"))
    for placer in arms:
        got = burst.run_burst(specs, placer, *POOL, charge_solve_time=False)
        for key in ("admitted", "running", "succeeded", "cycles"):
            assert got[key] == want[key], (placer.kernel, key)
        assert burst.trace_records(got["trace"]) == burst.trace_records(want["trace"]), \
            placer.kernel
        assert len(got["succeeded"]) == JOBS and got["jobs_measured"] == JOBS
    # The burst queued: admissions spread over many cycles and times, and
    # the placer's solves were traced.
    times = sorted({t for *_, t in want["admitted"].values()})
    assert len(times) > 20 and times[-1] > 300.0
    solves = [r["solver"] for r in got["trace"] if "solver" in r]
    assert solves and all(s["kernel"] == "numpy" for s in solves)
    assert got["p50_s"] <= got["p90_s"] <= got["p99_s"] <= got["makespan_s"]


def test_burst_jobs_equal_bench_make_job():
    """burst.make_job builds bench.make_job's jobs in the port's types, and
    build_workload draws bench's specs."""
    specs = bench.build_workload(60, 3)
    assert burst.build_workload(60, 3) == specs
    for s in specs + [("jax", "undeclared", "2x4", 2, 1, "40", None)]:
        want, got = bench.make_job(s), burst.make_job(s)
        assert type(got).__name__ == type(want).__name__
        assert norm(got) == norm(want), s


# -- the controllers' bootstrap env and status ----------------------------------

def tmpl(S, cname):
    return S.common.PodTemplateSpec(containers=[S.common.Container(
        name=cname, image="img", resources={"cpu": 0.5})])


def pytorch_master_worker(S):
    return S.jobs.PyTorchJob(metadata=S.jobs.ObjectMeta(name="pt"), replica_specs={
        "Master": S.common.ReplicaSpec(replicas=1, template=tmpl(S, "pytorch")),
        "Worker": S.common.ReplicaSpec(replicas=2, template=tmpl(S, "pytorch"))})


def pytorch_elastic(S):
    return S.jobs.PyTorchJob(
        metadata=S.jobs.ObjectMeta(name="el"),
        replica_specs={"Worker": S.common.ReplicaSpec(replicas=2, template=tmpl(S, "pytorch"))},
        elastic_policy=S.jobs.ElasticPolicy(min_replicas=1, max_replicas=4,
                                            rdzv_backend=S.jobs.RDZVBackend.C10D,
                                            max_restarts=3))


def pytorch_nproc(S):
    return S.jobs.PyTorchJob(metadata=S.jobs.ObjectMeta(name="np"), nproc_per_node=4,
                             replica_specs={
        "Master": S.common.ReplicaSpec(replicas=1, template=tmpl(S, "pytorch")),
        "Worker": S.common.ReplicaSpec(replicas=1, template=tmpl(S, "pytorch"))})


def tf_job(S, name, dynamic=False, all_workers=False, chief=True):
    specs = {"Worker": S.common.ReplicaSpec(replicas=2, template=tmpl(S, "tensorflow")),
             "PS": S.common.ReplicaSpec(replicas=1, template=tmpl(S, "tensorflow"))}
    if chief:
        specs["Chief"] = S.common.ReplicaSpec(replicas=1, template=tmpl(S, "tensorflow"))
    policy = S.jobs.SuccessPolicy.ALL_WORKERS if all_workers else S.jobs.SuccessPolicy.DEFAULT
    return S.jobs.TFJob(metadata=S.jobs.ObjectMeta(name=name), replica_specs=specs,
                        success_policy=policy, enable_dynamic_worker=dynamic)


def jax_workers(S):
    t = S.common.PodTemplateSpec(containers=[S.common.Container(
        name="jax", image="trainer", resources={"cpu": 0.5})])
    return S.jobs.JAXJob(metadata=S.jobs.ObjectMeta(name="jx"), replica_specs={
        "Worker": S.common.ReplicaSpec(replicas=3, template=t)})


# (case id, the job's constructor, pods to wait for, kubelet, pods to finish in turn as
# (replica type, index), the job's condition to wait for at the end); the
# cases of tests/test_controllers.py, and one JAXJob.
CASES = [
    ("master_worker_env", pytorch_master_worker, 3, True, [], None),
    ("elastic_env_and_hpa", pytorch_elastic, 2, True, [], None),
    ("nproc_per_node_world_size", pytorch_nproc, 2, True, [], None),
    ("tf_config", lambda S: tf_job(S, "tf"), 4, True, [], None),
    ("sparse_tf_config_dynamic_worker", lambda S: tf_job(S, "tfd", dynamic=True, chief=False),
     3, True, [], None),
    ("chief_success_ends_job", lambda S: tf_job(S, "tfc"), 4, False, [("Chief", 0)],
     "Succeeded"),
    ("all_workers_success_policy", lambda S: tf_job(S, "tfa", all_workers=True, chief=False),
     3, False, [("Worker", 0), ("Worker", 1)], "Succeeded"),
    ("chiefless_worker0_success", lambda S: tf_job(S, "tfw", chief=False), 3, False,
     [("Worker", 0)], "Succeeded"),
    ("jax_coordinator_env", jax_workers, 3, True, [], None),
]


def run_case(S, build, n_pods, kubelet, finish, until):
    """Runs one case on a stack; returns the job's pods, services, HPAs and
    conditions after the pods exist and after each finished pod, as data."""
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    cluster.add_nodes(S.inventory.make_cpu_pool(8))
    S.runtime.DefaultScheduler(cluster)
    if kubelet:
        S.runtime.SimKubelet(cluster)
    mgr = S.controllers.OperatorManager(cluster)
    S.controllers.register_all(mgr)
    job = build(S)
    mgr.submit(job)
    api, sel = cluster.api, {S.common.JOB_NAME_LABEL: job.name}

    def pods():
        return sorted(api.list("Pod", "default", sel), key=lambda p: p.name)

    def state():
        live = api.get(job.kind, "default", job.name)
        return {"t": cluster.clock.now(), "pods": norm(pods()),
                "services": norm(sorted(api.list("Service", "default", sel),
                                        key=lambda s: s.name)),
                "hpa": norm(api.try_get("HorizontalPodAutoscaler", "default", job.name)),
                "conditions": norm(live.status.conditions)}

    assert cluster.run_until(lambda: len(pods()) == n_pods, timeout=30)
    out = [state()]
    for rtype, index in finish:
        pod = next(p for p in pods() if p.metadata.labels[S.common.REPLICA_TYPE_LABEL] == rtype
                   and p.metadata.labels[S.common.REPLICA_INDEX_LABEL] == str(index))
        S.runtime.mark_pod_finished(api, pod, 0, cluster.clock.now())
        cluster.run_for(1.0)
        out.append(state())
    if until is not None:
        assert cluster.run_until(lambda: any(
            c.type.value == until and c.status
            for c in api.get(job.kind, "default", job.name).status.conditions), timeout=30)
        out.append(state())
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_controller_cases_equal_jax(case):
    _, *args = case
    want = run_case(stack(JAX), *args)
    got = run_case(stack(PORT), *args)
    assert got == want
    env = {p["metadata"]["name"]: p["spec"]["containers"][0]["env"] for p in got[0]["pods"]}
    if case[0] == "master_worker_env":
        assert env["pt-master-0"]["MASTER_ADDR"] == "pt-master-0"
        assert env["pt-worker-1"]["RANK"] == "2"
        assert [c["name"] for c in got[0]["pods"][1]["spec"]["init_containers"]] == [
            "pytorch-init"]
    elif case[0] == "elastic_env_and_hpa":
        assert env["el-worker-0"]["PET_NNODES"] == "1:4"
        assert got[0]["hpa"]["max_replicas"] == 4
    elif case[0] == "nproc_per_node_world_size":
        assert env["np-master-0"]["WORLD_SIZE"] == "8"
    elif case[0] == "tf_config":
        cfg = json.loads(env["tf-worker-1"]["TF_CONFIG"])
        assert cfg["task"] == {"type": "worker", "index": 1}
        assert cfg["cluster"]["chief"] == ["tf-chief-0.default.svc:2222"]
    elif case[0] == "sparse_tf_config_dynamic_worker":
        cfg = json.loads(env["tfd-worker-1"]["TF_CONFIG"])
        assert cfg["cluster"]["worker"] == {"1": "tfd-worker-1.default.svc:2222"}
    elif case[0] == "all_workers_success_policy":
        # One worker done is not enough; both are.
        assert not any(c["type"] == "Succeeded" for c in got[1]["conditions"])
        assert any(c["type"] == "Succeeded" and c["status"] for c in got[-1]["conditions"])
    elif case[0] == "jax_coordinator_env":
        assert {e["NUM_PROCESSES"] for e in env.values()} == {"3"}
        assert sorted(e["PROCESS_ID"] for e in env.values()) == ["0", "1", "2"]
    if case[-1] is not None:
        assert any(c["type"] == "Succeeded" and c["status"] for c in got[-1]["conditions"])
    assert got[0]["services"], "a service per replica"


# -- the config, a restart, the API server's side stores ----------------------------

def run_configured(S):
    """A PyTorchJob under a config that sets both knobs the path reads: the
    PodGroup's default priority class (gang enabled) and the image of the
    workers' master-wait init container."""
    old = S.config.current()
    S.config.set_current(dataclasses.replace(old, default_priority_class="batch-low",
                                             pytorch_init_container_image="busybox:1.36"))
    try:
        out = {}
        for gang in (True, False):  # gang: the PodGroup; without: the pods at once
            cluster = S.runtime.Cluster(S.runtime.VirtualClock())
            cluster.add_nodes(S.inventory.make_cpu_pool(8))
            S.runtime.DefaultScheduler(cluster)
            mgr = S.controllers.OperatorManager(cluster, gang_enabled=gang)
            S.controllers.register_all(mgr)
            mgr.submit(pytorch_master_worker(S))
            cluster.run_for(2.0)
            out["podgroup" if gang else "pods"] = norm(
                cluster.api.get("PodGroup", "default", "pt") if gang else
                sorted(cluster.api.list("Pod", "default"), key=lambda p: p.name))
        return out
    finally:
        S.config.set_current(old)


def test_config_knobs_equal_jax():
    want, got = run_configured(stack(JAX)), run_configured(stack(PORT))
    assert got == want
    assert got["podgroup"]["priority_class"] == "batch-low"
    images = [c["image"] for p in got["pods"] for c in p["spec"]["init_containers"]]
    assert images == ["busybox:1.36"] * 2
    assert stack(PORT).config.current().pytorch_init_container_image == "alpine:3.10"


def restart_mid_burst(S):
    """tests/test_engine.py's operator restart: the manager stops mid-burst
    and a fresh one on the same API server adopts the live pods. Returns
    every pod name ever added, the job states and the clock."""
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    cluster.add_nodes(S.inventory.make_cpu_pool(8))
    S.runtime.DefaultScheduler(cluster)
    S.runtime.SimKubelet(cluster)
    mgr = S.controllers.OperatorManager(cluster)
    S.controllers.register_all(mgr)
    watch = cluster.api.watch(kinds=("Pod",))
    added = []
    cluster.add_ticker(lambda: added.extend(
        ev.obj.name for ev in watch.drain() if ev.type == "Added"))

    def job(i):
        t = S.common.PodTemplateSpec(containers=[S.common.Container(
            name="jax", image="jax:latest", resources={"cpu": 1.0})])
        t.annotations[S.runtime.ANNOTATION_SIM_DURATION] = "5"
        return S.jobs.JAXJob(metadata=S.jobs.ObjectMeta(name=f"burst-{i}"), replica_specs={
            "Worker": S.common.ReplicaSpec(replicas=2, template=t)})

    def succeeded(name):
        return S.common.has_condition(cluster.api.get("JAXJob", "default", name).status,
                                      S.common.JobConditionType.SUCCEEDED)

    names = [mgr.submit(job(i)).name for i in range(4)]
    assert cluster.run_until(lambda: sum(
        p.status.phase == S.objects.PodPhase.RUNNING for p in cluster.api.list("Pod")) >= 4,
        timeout=30)
    assert not any(succeeded(n) for n in names)
    mgr.stop()
    cluster.run_for(2)
    mgr2 = S.controllers.OperatorManager(cluster)
    S.controllers.register_all(mgr2)
    for n in names:
        assert cluster.run_until(lambda n=n: succeeded(n), timeout=120), n
    return {"added": added, "t": cluster.clock.now(),
            "jobs": norm([cluster.api.get("JAXJob", "default", n).status for n in names])}


def test_restart_mid_burst_equals_jax():
    want, got = restart_mid_burst(stack(JAX)), restart_mid_burst(stack(PORT))
    assert got == want
    # No pod was created twice: the second manager adopted the first's.
    assert len(got["added"]) == len(set(got["added"])) == 4 * 2


def side_stores(S):
    """The API server's events (aggregation and the retention cap), pod logs
    (cursors, tail, the per-pod bound) and timelines (bulk span ingest)."""
    api = S.apiserver.APIServer()
    api.set_event_cap(8)
    for i in range(14):
        api.record_event(S.objects.Event(
            "Pod", f"p{i % 5}", "default", "Warning" if i % 3 else "Normal",
            "Evicted" if i % 2 else "Created", f"m{i % 4}", timestamp=float(i)))
    for i in range(3):
        api.record_event(S.objects.Event("Pod", "p9", "default", "Warning", "Evicted", "same",
                                         timestamp=20.0 + i))
    lines, cursor = api.read_pod_log("default", "p0")
    api.append_pod_log("default", "p0", "started\nready", 1.0)
    first, cursor = api.read_pod_log("default", "p0", since=cursor)
    for i in range(4100):
        api.append_pod_log("default", "p0", f"line {i}", 2.0 + i)
    after, end = api.read_pod_log("default", "p0", since=cursor, tail=3)
    api.record_spans("default", "j", [
        {"name": "queue_wait", "start": 1.0, "end": 1.0, "wall": 0.25,
         "attrs": {"uid": "u-1", "start": "shadowed"}},
        {"name": "reconcile", "start": 1.0, "end": 3.0, "wall": 0.5}],
        marks=[{"name": "running", "t": 3.0}])
    api.record_spans("default", "k", [{"name": "reconcile", "start": 4.0, "end": 4.5}])
    return {"events": norm(api.events()), "p9": norm(api.events(object_name="p9")),
            "evicted": norm(api.events(reason="Evicted")), "cap": api.event_cap(),
            "logs": (lines, first, after, end), "missing": api.read_pod_log("x", "y", since=7),
            "timeline": api.get_timeline("default", "j"),
            "none": api.get_timeline("default", "absent"),
            "timelines": api.get_timelines(limit=1)}


def test_apiserver_side_stores_equal_jax():
    want, got = side_stores(stack(JAX)), side_stores(stack(PORT))
    assert got == want
    assert len(got["events"]) <= 8 and got["p9"][0]["count"] == 3
    assert got["logs"][1] == ["1.000 started", "1.000 ready"] and len(got["logs"][2]) == 3
    assert got["timeline"] is not None and got["none"] is None


def test_cut_features_fail_at_the_signature():
    """The features left for later slices are left out, not stubbed: naming
    one is a TypeError (or there is no such attribute)."""
    S = stack(PORT)
    cluster = S.runtime.Cluster(S.runtime.VirtualClock())
    with pytest.raises(TypeError):
        S.controllers.OperatorManager(cluster, parallel_reconciles=4)
    with pytest.raises(TypeError):
        S.controllers.OperatorManager(cluster, leader_elect=True)
    with pytest.raises(TypeError):
        S.gang.GangScheduler(cluster, packer.TPUPacker(kernel="numpy"), arbiter=object())
    mgr = S.controllers.OperatorManager(cluster)
    assert not any(hasattr(mgr, n) for n in ("kill", "unfulfilled_expectations", "elector"))
    api = cluster.api
    pod = api.create(S.objects.Pod(metadata=S.jobs.ObjectMeta(name="p")))
    with pytest.raises(TypeError):
        api.update(pod, coalesce=False)
    cut = ("event_seq", "set_event_seq", "wait_and_drain", "object_counts", "get_ref",
           "event_count", "attach_journal", "snapshot_state", "restore", "apply_replicated",
           "advance_uid_floor", "locked")
    assert not any(hasattr(api, n) for n in cut)
