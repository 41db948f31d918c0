"""Expectations cache: the informer-race correctness mechanism.

Parity target: reference pkg/controller.v1/expectation/expectation.go:71-220.

Between a successful `CreatePod` API write and the watch event echoing that pod
back into the informer cache, a reconcile listing pods sees fewer than it
created and would create duplicates. The expectations cache records "I expect
to observe N adds / M deletes for job-key/replica-type/kind"; reconciles are
only allowed to mutate once expectations are satisfied (all echoes observed),
or after a TTL expiry (5 min, reference expectation.go:40) in case events were
dropped.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

EXPECTATION_TIMEOUT_SECONDS = 300.0  # reference ExpectationsTimeout = 5 * time.Minute


def gen_expectation_key(job_key: str, replica_type: str, kind: str) -> str:
    """kind is "pods" or "services" (reference GenExpectationPodsKey/...ServicesKey)."""
    return f"{job_key}/{replica_type.lower()}/{kind}"


@dataclass
class _Expectation:
    adds: int = 0
    deletes: int = 0
    timestamp: float = field(default=0.0)

    def fulfilled(self) -> bool:
        return self.adds <= 0 and self.deletes <= 0


class ControllerExpectations:
    """Per-key add/delete expectation counters with TTL.

    `now_fn` is injectable so TTL expiry is testable with a virtual clock.
    """

    def __init__(self, now_fn: Optional[Callable[[], float]] = None):
        self._store: Dict[str, _Expectation] = {}
        self._now = now_fn or _time.monotonic

    def expect_creations(self, key: str, count: int) -> None:
        self._store[key] = _Expectation(adds=count, deletes=0, timestamp=self._now())

    def expect_deletions(self, key: str, count: int) -> None:
        self._store[key] = _Expectation(adds=0, deletes=count, timestamp=self._now())

    def raise_expectations(self, key: str, adds: int, deletes: int) -> None:
        exp = self._store.setdefault(key, _Expectation(timestamp=self._now()))
        exp.adds += adds
        exp.deletes += deletes

    def creation_observed(self, key: str) -> None:
        exp = self._store.get(key)
        if exp is not None and exp.adds > 0:
            exp.adds -= 1

    def deletion_observed(self, key: str) -> None:
        exp = self._store.get(key)
        if exp is not None and exp.deletes > 0:
            exp.deletes -= 1

    def satisfied_expectations(self, key: str) -> bool:
        """True if fulfilled, expired, or never set (reference
        SatisfiedExpectations: a brand-new controller must sync)."""
        exp = self._store.get(key)
        if exp is None:
            return True
        if exp.fulfilled():
            return True
        if self._now() - exp.timestamp > EXPECTATION_TIMEOUT_SECONDS:
            return True
        return False

    def unfulfilled(self) -> Dict[str, float]:
        """key -> age (seconds since set) of every NOT-yet-fulfilled
        expectation — the fleet auditor's INV004 feed: an entry older than
        the TTL is wedged (its watch events will never arrive; the gate
        opens on TTL expiry but the leak says something was lost)."""
        now = self._now()
        return {
            key: now - exp.timestamp
            for key, exp in self._store.items()
            if not exp.fulfilled()
        }

    def forget_expired(self) -> int:
        """Drop unfulfilled entries older than the TTL; returns how many.

        An entry past the TTL no longer gates anything (satisfied_
        expectations opens at expiry) — it is residue of watch events that
        were lost (flaky informer connection, a faulted tick dropping a
        drained batch). The periodic resync re-lists every job, so the
        state those events carried is re-observed anyway; keeping the
        entry would only make the INV004 feed report a leak that the
        resync machinery has in fact already healed. Call from the resync
        path: then anything unfulfilled past TTL + resync period really IS
        wedged, which is exactly what INV004 should mean."""
        now = self._now()
        stale = [
            key for key, exp in self._store.items()
            if not exp.fulfilled()
            and now - exp.timestamp > EXPECTATION_TIMEOUT_SECONDS
        ]
        for key in stale:
            del self._store[key]
        return len(stale)

    def clear(self) -> None:
        """Drop every expectation — for a controller whose watch stream had
        a gap (e.g. a standby period between two leadership terms): stale
        expectations would otherwise gate reconciles on events that were
        discarded and will never arrive."""
        self._store.clear()

    def forget_where(self, pred: Callable[[str], bool]) -> int:
        """Drop every expectation whose key matches `pred`; returns how
        many. The shard-scoped twin of clear(): a replica adopting (or
        losing) one reconcile shard must reset ONLY that shard's entries —
        its other shards' watch streams had no gap, and clearing them would
        open their creation gates mid-flight."""
        stale = [key for key in self._store if pred(key)]
        for key in stale:
            del self._store[key]
        return len(stale)

    def delete_expectations(self, key: str) -> None:
        self._store.pop(key, None)
