"""Rate-limiting work queue with per-key exponential backoff.

Parity target: client-go's workqueue as used by controller-runtime (the
reference's queueing substrate; pkg/common/util/fake_workqueue.go exists
precisely because controller-runtime owns the real one). Keys are
namespace/name strings; a key present in the queue is deduplicated, and
`requeue_after` integrates with the cluster timer heap for delayed retries
(backoff/TTL/deadline requeues, reference common/job.go:176-214).
"""

from __future__ import annotations

import time as _time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from training_operator_tpu_torch.utils import metrics


class RateLimitingQueue:
    """Deduplicating FIFO with per-key failure counts for backoff.

    base_delay/max_delay mirror client-go's DefaultItemBasedRateLimiter
    (5ms .. 1000s exponential). Each first-seen enqueue is timestamped
    (`now_fn`, wall-monotonic by default — queue latency is a real-time
    property even under a virtual cluster clock, matching client-go's
    workqueue_queue_duration_seconds) so consumers can attribute the
    enqueue->pop wait per key via `waited()`.
    """

    def __init__(self, base_delay: float = 0.005, max_delay: float = 300.0,
                 now_fn: Optional[Callable[[], float]] = None):
        self._queue: "OrderedDict[str, None]" = OrderedDict()
        self._failures: Dict[str, int] = {}
        self._enqueued_at: Dict[str, float] = {}
        self._pop_waits: Dict[str, float] = {}
        self._now = now_fn or _time.monotonic
        self.base_delay = base_delay
        self.max_delay = max_delay

    def add(self, key: str) -> None:
        if key not in self._queue:
            # controller-runtime workqueue_adds_total parity: dedup'd
            # re-adds of a queued key are not new work and don't count.
            metrics.workqueue_adds.inc()
            self._queue[key] = None
            self._enqueued_at[key] = self._now()

    def get(self) -> Optional[str]:
        if not self._queue:
            return None
        key, _ = self._queue.popitem(last=False)
        # Settle the wait at pop time (stamps must not outlive queue
        # membership, or consumers that never read waits leak one entry
        # per distinct key forever).
        t = self._enqueued_at.pop(key, None)
        if t is not None:
            self._pop_waits[key] = max(0.0, self._now() - t)
        return key

    def waited(self, key: str) -> float:
        """Enqueue->pop wait of a key popped this drain cycle; consumed on
        read. `_pop_waits` is cleared at the next drain(), so a consumer
        that never reads waits (v2 manager) stays bounded too."""
        return self._pop_waits.pop(key, 0.0)

    def drain(self, limit: int = 0) -> List[str]:
        # A fresh drain supersedes any waits the previous cycle's consumer
        # left unread — the read window is one drain cycle.
        self._pop_waits.clear()
        out = []
        while self._queue and (not limit or len(out) < limit):
            out.append(self.get())
        return out

    def __len__(self) -> int:
        return len(self._queue)

    def __contains__(self, key: str) -> bool:
        return key in self._queue

    # -- rate limiting -----------------------------------------------------

    def num_requeues(self, key: str) -> int:
        return self._failures.get(key, 0)

    def failure_delay(self, key: str) -> float:
        """Record a failure and return the backoff delay before retrying."""
        n = self._failures.get(key, 0)
        self._failures[key] = n + 1
        return min(self.base_delay * (2**n), self.max_delay)

    def forget(self, key: str) -> None:
        self._failures.pop(key, None)
