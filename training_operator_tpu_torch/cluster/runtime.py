"""Cluster runtime: clock, timer heap, tick loop, default scheduler, kubelet.

Single-threaded and event-driven by design. Controllers, schedulers, and the
virtual kubelet register as *tickers*; each `Cluster.step()` drains due timers
then runs every ticker once. Watch events queue between ticks, which faithfully
reproduces the informer-echo asynchrony the reference's expectations cache
exists to absorb (expectation/expectation.go:29-40) while keeping every test
deterministic — the "envtest with no kubelet" strategy from SURVEY.md §4, with
the option of a real kubelet (`SimKubelet`) that actually runs pod lifecycles.

Counterpart of training_operator_tpu/cluster/runtime.py without the exec
channel into pods (`ExecChannel`, `resolve_pod_files`), which belongs to the
MPI launcher and is still to be ported.
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

from training_operator_tpu_torch.cluster.apiserver import APIServer, SharedInformer
from training_operator_tpu_torch.cluster.objects import (
    NODE_LEASE_NAMESPACE,
    ContainerStatus,
    Lease,
    Node,
    Pod,
    PodPhase,
    node_ready,
    tolerates,
)

ANNOTATION_SIM_DURATION = "sim.tpu.dev/run-seconds"
ANNOTATION_SIM_EXIT_CODE = "sim.tpu.dev/exit-code"
# JSON array of stdout lines the simulated container "prints" on start —
# the per-pod log model's stand-in for trainer output (real workloads
# attach theirs via SimKubelet.complete_pod(log=...)).
ANNOTATION_SIM_LOG_LINES = "sim.tpu.dev/log-lines"


class Clock:
    """Real wall clock."""

    def now(self) -> float:
        return _time.monotonic()

    def is_virtual(self) -> bool:
        return False


class WallClock(Clock):
    """Wall-clock time (`time.time()`), for the serving-host role: every
    timestamp the host persists into durable state (pod start times, lease
    renew times) must stay meaningful across a host process restart, and
    monotonic epochs die with the process. Remote operators slave to this
    clock via GET /time (httpapi.SyncedClock), so NTP steps affect all
    participants together."""

    def now(self) -> float:
        return _time.time()


class VirtualClock(Clock):
    """Manually-advanced clock for deterministic TTL/backoff/deadline tests."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt

    def set(self, t: float) -> None:
        self._now = max(self._now, t)

    def is_virtual(self) -> bool:
        return True


class Cluster:
    """The substrate runtime tying APIServer + nodes + scheduler + kubelet."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self.api = APIServer()
        # Timeline spans must be stamped in CLUSTER time (virtual-clock sims
        # trace in sim time; the host role's WallClock keeps them durable).
        self.api.timelines.set_clock(self.clock.now)
        # Shared read cache (controller-runtime's shared informer): synced at
        # the top of every step, read by schedulers/kubelet/benchmarks so
        # full-state scans don't clone the store each tick.
        self.informer = SharedInformer(self.api)
        self._tickers: List[Callable[[], None]] = []
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = itertools.count()

    # -- topology ----------------------------------------------------------

    def add_nodes(self, nodes: List[Node]) -> None:
        for n in nodes:
            self.api.create(n)

    def nodes(self) -> List[Node]:
        return self.api.list("Node")

    def live(self, obj: Any) -> Any:
        """Latest stored state of `obj` (or None if deleted). With copy-on-
        read semantics a submitted object never mutates in the caller's hand
        — k8s clients re-GET, and so must tests/benchmarks."""
        ns = getattr(obj.metadata, "namespace", "") or ""
        return self.api.try_get(obj.KIND, ns, obj.metadata.name)

    # -- scheduling of work ------------------------------------------------

    def add_ticker(self, fn: Callable[[], None]) -> None:
        self._tickers.append(fn)

    def remove_ticker(self, fn: Callable[[], None]) -> None:
        """Detach a component (operator shutdown / restart simulation)."""
        try:
            self._tickers.remove(fn)
        except ValueError:
            pass

    def schedule_at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._timers, (t, next(self._timer_seq), fn))

    def schedule_after(self, dt: float, fn: Callable[[], None]) -> None:
        self.schedule_at(self.clock.now() + dt, fn)

    def next_timer_at(self) -> Optional[float]:
        return self._timers[0][0] if self._timers else None

    def step(self) -> None:
        """One tick: sync the shared informer, run due timers, then every
        ticker once."""
        self.informer.sync()
        now = self.clock.now()
        while self._timers and self._timers[0][0] <= now:
            _, _, fn = heapq.heappop(self._timers)
            fn()
        for fn in list(self._tickers):
            fn()

    def run_until(
        self,
        predicate: Callable[[], bool],
        timeout: float = 30.0,
        max_steps: int = 1_000_000,
    ) -> bool:
        """Step until predicate holds. With a VirtualClock, idle time jumps to
        the next timer; with a real clock, idle ticks sleep briefly.

        The deadline check happens *after* stepping so a timer due exactly at
        the deadline still fires before we give up. With a VirtualClock, time
        only jumps forward when the system is quiescent (no API writes during
        the last step and no timers already due) — otherwise cascading work
        (scheduler binding -> kubelet start -> controller reconcile) would be
        skipped over by an early timer jump.
        """
        deadline = self.clock.now() + timeout
        for _ in range(max_steps):
            if predicate():
                return True
            version_before = self.api.version()
            self.step()
            if predicate():
                return True
            if self.clock.now() >= deadline:
                return False
            if isinstance(self.clock, VirtualClock):
                if self.api.version() != version_before:
                    continue  # activity this step; let cascades settle first
                nxt = self.next_timer_at()
                if nxt is None:
                    self.clock.advance(0.01)
                elif nxt > self.clock.now():
                    self.clock.set(min(nxt, deadline))
                # due timers fire on the next step at the current instant
            else:
                _time.sleep(0.0005)
        return False

    def run_for(self, seconds: float) -> None:
        end = self.clock.now() + seconds
        self.run_until(lambda: False, timeout=seconds)
        if isinstance(self.clock, VirtualClock):
            self.clock.set(end)


def request_fits(request: Dict[str, float], avail: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in request.items())


class DefaultScheduler:
    """First-fit bind of pending pods — the reference's "default-scheduler"
    baseline (BASELINE.md config 1). Skips pods that opt into gang scheduling
    (scheduler_name set to a gang scheduler) — those are bound by the gang
    scheduler component."""

    def __init__(self, cluster: Cluster, handles_scheduler_names: Tuple[str, ...] = ("", "default-scheduler")):
        self.cluster = cluster
        self.handles = set(handles_scheduler_names)
        # Informer pattern: unbound pods, active (bound, non-terminal) pods,
        # and nodes are all maintained from THIS component's watch events, so
        # the retry gate and the capacity view can never disagree (a shared
        # cache synced elsewhere lags the events drained here, which would
        # deadlock an attempt-once gate). Initial LIST, then WATCH.
        self._watch = cluster.api.watch(kinds=("Pod", "Node"))
        self._pending: dict = {}
        self._active: dict = {}  # (ns, name) -> bound non-terminal pod
        self._nodes: dict = {}
        for pod in cluster.api.list("Pod"):
            self._observe_pod("Added", pod)
        for node in cluster.api.list("Node"):
            self._nodes[node.name] = node
        # Retry only when something changed: a new pending pod, freed
        # capacity (bound pod terminal/deleted), or a node event.
        self._dirty = True
        cluster.add_ticker(self.tick)

    def _observe_pod(self, ev_type: str, pod: Pod) -> None:
        key = (pod.namespace, pod.name)
        if (
            ev_type != "Deleted"
            and pod.status.phase == PodPhase.PENDING
            and not pod.node_name
            and pod.spec.scheduler_name in self.handles
        ):
            self._pending[key] = pod
            self._dirty = True
        else:
            self._pending.pop(key, None)
        if ev_type != "Deleted" and pod.node_name and not pod.is_terminal():
            self._active[key] = pod
        elif self._active.pop(key, None) is not None:
            self._dirty = True  # capacity freed

    def _free(self) -> Dict[str, Dict[str, float]]:
        used: Dict[str, Dict[str, float]] = {}
        for pod in self._active.values():
            bucket = used.setdefault(pod.node_name, {})
            for k, v in pod.resources().items():
                bucket[k] = bucket.get(k, 0.0) + v
        free: Dict[str, Dict[str, float]] = {}
        for node in self._nodes.values():
            if node.unschedulable or not node_ready(node):
                continue
            u = used.get(node.name, {})
            free[node.name] = {
                k: cap - u.get(k, 0.0) for k, cap in node.capacity.items()
            }
        return free

    def tick(self) -> None:
        for ev in self._watch.drain():
            if ev.kind == "Node":
                if ev.type == "Deleted":
                    self._nodes.pop(ev.obj.metadata.name, None)
                else:
                    self._nodes[ev.obj.metadata.name] = ev.obj
                self._dirty = True
            else:
                self._observe_pod(ev.type, ev.obj)
        if not self._pending or not self._dirty:
            return
        self._dirty = False
        free = self._free()
        bound = []
        for key, pod in self._pending.items():
            req = pod.resources()
            for name, node in self._nodes.items():
                if node.unschedulable or name not in free:
                    continue
                if pod.spec.node_selector and not node.matches_selector(pod.spec.node_selector):
                    continue
                if node.taints and not tolerates(node.taints, pod.spec.tolerations):
                    continue
                if request_fits(req, free[name]):
                    bind_pod(self.cluster.api, pod, name, now=self.cluster.clock.now())
                    self._active[key] = pod
                    for k, v in req.items():
                        free[name][k] = free[name].get(k, 0.0) - v
                    bound.append(key)
                    break
        for key in bound:
            self._pending.pop(key, None)


def bind_pod(api: APIServer, pod: Pod, node_name: str, now: Optional[float] = None) -> None:
    pod.node_name = node_name
    if pod.status.scheduled_time is None and now is not None:
        pod.status.scheduled_time = now
    api.update(pod, check_version=False)


class SimKubelet:
    """Virtual kubelet: starts bound pods after a latency, optionally completes
    them after an annotated duration with an annotated exit code.

    Node lifecycle duties (the kube-node-lease analogue): every
    `heartbeat_interval` the kubelet renews one Lease per live node in the
    `node-leases` namespace. `kill_node` silences a node — its heartbeat
    stops, its pods neither start nor complete (the processes died with the
    host), and detection is the node lifecycle controller's job, exactly
    like a real dead host. `recover_node` resumes the heartbeat.

    Tests that want envtest-style manual phase control simply don't attach a
    kubelet (or never annotate durations) and mutate pod phases directly.
    """

    def __init__(
        self,
        cluster: Cluster,
        start_latency: float = 0.0,
        heartbeat_interval: float = 10.0,
        heartbeats: bool = True,
    ):
        self.cluster = cluster
        self.start_latency = start_latency
        self.heartbeat_interval = heartbeat_interval
        self._dead_nodes: set = set()
        self._starting: set = set()
        # Informer pattern: newly-bound pods arrive as watch events instead
        # of a full pod scan per tick (O(events), not O(cluster x steps)).
        # Like a real informer: initial LIST, then WATCH.
        self._watch = cluster.api.watch(kinds=("Pod",))
        self._backlog = list(cluster.api.list("Pod"))
        cluster.add_ticker(self.tick)
        if heartbeats:
            # First beat immediately-ish via timer (not inline: nodes may be
            # added right after construction), then every interval.
            self.cluster.schedule_after(0.0, self._heartbeat)

    # -- node liveness -----------------------------------------------------

    def dead_nodes(self) -> set:
        """Nodes this kubelet currently holds dead (heartbeats silenced) —
        worker-host death is EXTERNAL state: a control-plane host failover
        builds a fresh kubelet, and the promotion path must re-silence
        these nodes on it or the new incarnation's first heartbeat would
        resurrect every dead host's lease."""
        return set(self._dead_nodes)

    def node_alive(self, name: str) -> bool:
        return (
            bool(name)
            and name not in self._dead_nodes
            and self.cluster.api.resource_version("Node", "", name) is not None
        )

    def kill_node(self, name: str) -> None:
        """The host died: heartbeat stops, nothing on it starts or finishes.
        Pod objects keep their last written phase — a dead kubelet writes
        nothing — until the lifecycle controller evicts them."""
        self._dead_nodes.add(name)

    def recover_node(self, name: str) -> None:
        self._dead_nodes.discard(name)
        self._beat_one(name, self.cluster.clock.now())
        # Pods bound to this node that waited out the outage: re-arm starts
        # (their bind event was consumed while it was dead) and completion
        # timers (the finisher that fired during the outage no-op'd).
        for pod in self.cluster.api.list("Pod"):
            if pod.node_name != name:
                continue
            if pod.status.phase == PodPhase.PENDING:
                self._maybe_start(pod)
            elif pod.status.phase == PodPhase.RUNNING:
                self._maybe_recover(pod)

    def _beat_one(self, name: str, now: float) -> None:
        api = self.cluster.api
        lease = api.try_get("Lease", NODE_LEASE_NAMESPACE, name)
        if lease is None:
            from training_operator_tpu_torch.api.jobs import ObjectMeta

            lease = Lease(
                metadata=ObjectMeta(name=name, namespace=NODE_LEASE_NAMESPACE),
                holder=name,
                lease_duration=self.heartbeat_interval,
                acquire_time=now,
                renew_time=now,
            )
            api.create(lease)
        else:
            lease.renew_time = now
            api.update(lease, check_version=False)

    def _heartbeat(self) -> None:
        now = self.cluster.clock.now()
        for node in self.cluster.api.list_refs("Node"):
            if node.name not in self._dead_nodes:
                self._beat_one(node.name, now)
        self.cluster.schedule_after(self.heartbeat_interval, self._heartbeat)

    # -- pod lifecycle -----------------------------------------------------

    def tick(self) -> None:
        backlog, self._backlog = self._backlog, []
        for pod in backlog:
            self._maybe_start(pod)
            self._maybe_recover(pod)
        for ev in self._watch.drain():
            if ev.type != "Deleted":
                self._maybe_start(ev.obj)

    def _maybe_recover(self, pod: Pod) -> None:
        """Re-arm the completion timer of a pod that was already RUNNING when
        this kubelet came up — the host-restart recovery path: finish timers
        are process state and die with the crashed host, but the pod objects
        (with wall-clock start times) come back from the durable store. A
        pod whose deadline passed during the outage finishes immediately."""
        if pod.status.phase != PodPhase.RUNNING:
            return
        dur = pod.spec.annotations.get(ANNOTATION_SIM_DURATION)
        if dur is None:
            return
        code = int(pod.spec.annotations.get(ANNOTATION_SIM_EXIT_CODE, "0"))
        now = self.cluster.clock.now()
        started = pod.status.start_time if pod.status.start_time is not None else now
        self.cluster.schedule_at(
            max(now, started + float(dur)),
            self._make_finisher(pod.metadata.uid, pod.namespace, pod.name, code),
        )

    def _maybe_start(self, pod: Pod) -> None:
        if (
            pod.node_name
            and pod.status.phase == PodPhase.PENDING
            and self.node_alive(pod.node_name)  # dead/vanished host: stay PENDING
            and pod.metadata.uid not in self._starting
        ):
            self._starting.add(pod.metadata.uid)
            if pod.status.scheduled_time is None:
                pod.status.scheduled_time = self.cluster.clock.now()
            self.cluster.schedule_after(
                self.start_latency,
                self._make_starter(pod.metadata.uid, pod.namespace, pod.name),
            )

    def _make_starter(self, uid: str, namespace: str, name: str):
        def start():
            pod = self.cluster.api.try_get("Pod", namespace, name)
            if pod is None or pod.metadata.uid != uid or pod.status.phase != PodPhase.PENDING:
                self._starting.discard(uid)
                return
            if not self.node_alive(pod.node_name):
                # Node died between bind and start: the pod stays PENDING
                # (recover_node re-arms it; eviction handles the rest).
                self._starting.discard(uid)
                return
            pod.status.phase = PodPhase.RUNNING
            pod.status.start_time = self.cluster.clock.now()
            pod.status.container_statuses = [
                ContainerStatus(name=c.name, running=True) for c in pod.spec.containers
            ]
            self.cluster.api.update(pod, check_version=False)
            now = self.cluster.clock.now()
            for c in pod.spec.containers:
                self.cluster.api.append_pod_log(
                    namespace, name,
                    f"Started container {c.name} on {pod.node_name}", now,
                )
            raw = pod.spec.annotations.get(ANNOTATION_SIM_LOG_LINES)
            if raw is not None:
                import json

                try:
                    for ln in json.loads(raw):
                        self.cluster.api.append_pod_log(namespace, name, str(ln), now)
                except (ValueError, TypeError):
                    pass  # a malformed sim annotation must not kill the kubelet
            self._starting.discard(uid)
            self._schedule_finish(pod, uid)

        return start

    def complete_pod(
        self, namespace: str, name: str, exit_code: int = 0,
        log: Optional[str] = None,
    ) -> bool:
        """External completion: a real workload process attached to this pod
        exited — propagate its exit code exactly as an annotated sim finish
        would (restart policy honored). This is the seam the real-process
        e2e tier uses: OS processes run the container's work, their captured
        stdout lands in the pod's log (`log`), and their exit codes flow
        back through the kubelet into pod/job status."""
        pod = self.cluster.api.try_get("Pod", namespace, name)
        if pod is None or pod.status.phase != PodPhase.RUNNING:
            return False
        if not self.node_alive(pod.node_name):
            return False  # nothing on a dead host exits with a code
        if log:
            self.cluster.api.append_pod_log(
                namespace, name, log, self.cluster.clock.now()
            )
        self._make_finisher(pod.metadata.uid, namespace, name, exit_code)()
        return True

    def _schedule_finish(self, pod: Pod, uid: str) -> None:
        """Arm the completion timer from the pod's sim annotations (if any)."""
        dur = pod.spec.annotations.get(ANNOTATION_SIM_DURATION)
        if dur is None:
            return
        code = int(pod.spec.annotations.get(ANNOTATION_SIM_EXIT_CODE, "0"))
        self.cluster.schedule_after(
            float(dur), self._make_finisher(uid, pod.namespace, pod.name, code)
        )

    def _make_finisher(self, uid: str, namespace: str, name: str, exit_code: int):
        def finish():
            pod = self.cluster.api.try_get("Pod", namespace, name)
            if pod is None or pod.metadata.uid != uid or pod.status.phase != PodPhase.RUNNING:
                return
            if not self.node_alive(pod.node_name):
                # The host (and the container's process) is gone: no exit
                # code will ever surface. Leave the stale RUNNING phase for
                # the node lifecycle controller to evict.
                return
            # Honor pod-level restart policy the way the kubelet does:
            # Always restarts in place on any exit; OnFailure on exit != 0;
            # Never (and OnFailure with exit 0) surfaces the terminal phase.
            # In-place restarts bump restart_count — the signal
            # past_backoff_limit sums (reference core/job.go:95).
            from training_operator_tpu_torch.api.common import RestartPolicy

            policy = pod.effective_restart_policy()
            should_restart = policy == RestartPolicy.ALWAYS or (
                policy == RestartPolicy.ON_FAILURE and exit_code != 0
            )
            self.cluster.api.append_pod_log(
                namespace, name,
                f"Container exited with code {exit_code}"
                + ("; restarting" if should_restart else ""),
                self.cluster.clock.now(),
            )
            if should_restart:
                for cs in pod.status.container_statuses:
                    cs.restart_count += 1
                    cs.exit_code = exit_code
                    cs.running = True
                self.cluster.api.update(pod, check_version=False)
                self._schedule_finish(pod, uid)
                return
            mark_pod_finished(self.cluster.api, pod, exit_code, now=self.cluster.clock.now())

        return finish


def mark_pod_finished(api: APIServer, pod: Pod, exit_code: int, now: float = 0.0) -> None:
    pod.status.phase = PodPhase.SUCCEEDED if exit_code == 0 else PodPhase.FAILED
    pod.status.finish_time = now
    for cs in pod.status.container_statuses:
        cs.running = False
        cs.exit_code = exit_code
    if not pod.status.container_statuses:
        pod.status.container_statuses = [
            ContainerStatus(name=c.name, exit_code=exit_code) for c in pod.spec.containers
        ]
    api.update(pod, check_version=False)
