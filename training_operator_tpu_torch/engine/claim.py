"""ControllerRefManager: adopt/orphan semantics for controller-owned objects.

Parity target: reference pkg/controller.v1/control/controller_ref_manager.go
(ClaimPods at :380 via common/pod.go:242-253, ClaimServices via
common/service.go). The reconcile engine must not merely filter by owner —
it must CLAIM:

  - an orphan (no owner) whose labels match the job's selector is ADOPTED
    (owner ref written), after an uncached re-read confirms the adopter
    still exists with the same uid and is not being deleted (the reference's
    RecheckDeletionTimestamp "canAdopt" quorum check);
  - an object we own whose labels no longer match is RELEASED (owner ref
    cleared), making it a free orphan another controller may claim;
  - an object owned by someone else is ignored.

Without adoption, pods stranded by an operator restart (fresh uid counter,
the reference's motivating case) would be invisible to their job forever.

All claim writes are version-checked: losing a race simply defers the claim
to the next reconcile, exactly like the reference's retryable patch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from training_operator_tpu_torch.cluster.apiserver import APIServer, ConflictError


class ControllerRefManager:
    """Claims objects of one kind for one controller instance.

    `controller` needs .uid, .name, .namespace and metadata.deletion_time;
    claimable objects need metadata.{owner_uid, labels}.
    """

    def __init__(
        self,
        api: APIServer,
        controller: Any,
        selector: Dict[str, str],
        kind: str,
        can_adopt: Optional[Callable[[], bool]] = None,
    ):
        self.api = api
        self.controller = controller
        self.selector = selector
        self.kind = kind
        self._can_adopt = can_adopt
        self._can_adopt_result: Optional[bool] = None

    # ------------------------------------------------------------------

    def _matches(self, obj: Any) -> bool:
        labels = obj.metadata.labels
        return all(labels.get(k) == v for k, v in self.selector.items())

    def can_adopt(self) -> bool:
        """Uncached re-read of the adopter, memoized per claim pass: the
        controller object in hand may be a stale cache copy; adoption must
        check the store's truth (reference RecheckDeletionTimestamp)."""
        if self._can_adopt_result is None:
            if self._can_adopt is not None:
                self._can_adopt_result = self._can_adopt()
            else:
                fresh = self.api.try_get(
                    self.controller.KIND,
                    self.controller.namespace,
                    self.controller.name,
                )
                self._can_adopt_result = (
                    fresh is not None
                    and fresh.uid == self.controller.uid
                    and getattr(fresh.metadata, "deletion_time", None) is None
                )
        return self._can_adopt_result

    def _adopt(self, obj: Any) -> Optional[Any]:
        if not self.can_adopt():
            return None
        fresh = self.api.try_get(self.kind, obj.namespace, obj.name)
        if fresh is None or fresh.metadata.owner_uid is not None or not self._matches(fresh):
            return None  # changed under us; next reconcile re-evaluates
        fresh.metadata.owner_uid = self.controller.uid
        try:
            self.api.update(fresh, check_version=True)
        except ConflictError:
            return None
        return fresh

    def _release(self, obj: Any) -> None:
        fresh = self.api.try_get(self.kind, obj.namespace, obj.name)
        if fresh is None or fresh.metadata.owner_uid != self.controller.uid:
            return  # already gone or re-owned
        fresh.metadata.owner_uid = None
        try:
            self.api.update(fresh, check_version=True)
        except ConflictError:
            pass  # racing writer wins; retried next reconcile

    # ------------------------------------------------------------------

    def claim(self, objects: List[Any]) -> List[Any]:
        """Partition `objects` into ours, adopting matching orphans and
        releasing mismatched dependents. Returns the claimed list."""
        self._can_adopt_result = None
        claimed: List[Any] = []
        for obj in objects:
            owner = obj.metadata.owner_uid
            if owner == self.controller.uid:
                if self._matches(obj):
                    claimed.append(obj)
                else:
                    self._release(obj)
            elif owner is None:
                if self._matches(obj):
                    adopted = self._adopt(obj)
                    if adopted is not None:
                        claimed.append(adopted)
            # else: owned by another controller — never touched.
        return claimed
