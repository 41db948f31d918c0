"""The placement engine on the card: the batched gang solve and its placer.

Counterpart of training_operator_tpu/scheduler/packer.py: `_next_pow2`,
`_solve_batch` (the XLA-jit arm of the placement engine),
`_solve_batch_numpy` and `TPUPacker`. One solve admits a whole batch of gang
items against the host inventory in parallel rounds (see `solve_batch`);
all arms return bit-identical placements.

- `solve_batch` runs JAX's vectorised form op for op on torch tensors, on
  the device they lie on. `jax.lax.while_loop` becomes a Python loop that
  reads `commit.any()` on the host once per round; the rounds are counted.
  `torch.argsort(stable=True)` keeps JAX's stable order among equal scores,
  the rank is clamped to the candidate axis as JAX clamps a gather, and the
  sums and prefix counts are taken in int32 (torch's default is int64).
- `TorchSolver` drives it as TPUPacker drives the jit arm: item, class and
  candidate axes padded to powers of two through sticky high-water marks,
  candidate tensors uploaded once per generation and kept on the card,
  only the free-host matrix and the item vectors sent per solve, and one
  transfer of the result back. Numpy in, numpy out, on the card unless the
  caller passes another device.
- `solve_batch_numpy` is the host arm, numpy only: the plain reference the
  card's placements are held to.
- `TPUPacker` is the placer a scheduling cycle calls (see its docstring).
- `scale_instance` builds the 10k-node block of the repo's solver bench
  (2500 slices of 4 hosts, 2000 single-slice gangs) as tensors.
"""

from __future__ import annotations

import itertools
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from training_operator_tpu_torch.scheduler.candidates import CandidateCache
from training_operator_tpu_torch.scheduler.inventory import (
    GPU_RESOURCE,
    TPU_RESOURCE,
    toleration_sig,
)
from training_operator_tpu_torch.scheduler.snapshot import (
    Placement,
    request_hosts_per_slice,
    topology_hosts_per_slice,
)
from training_operator_tpu_torch.trainer.model import resolve_device

_NEG = -(2**30)

# The packed score reaches about h^3 + h^2, which must stay below |_NEG|.
MAX_HOSTS = 512


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def solve_batch(free, cand_mask, cand_slice, cand_valid, origin_rank, item_class,
                item_active) -> Tuple[torch.Tensor, int]:
    """The batched gang solve: parallel rounds, not a sequential scan.

    free:        (S, H)    bool  - host h of slice s is fully free
    cand_mask:   (K, C, H) bool  - candidate c of class k uses host h
    cand_slice:  (K, C)    int32 - slice index of candidate c
    cand_valid:  (K, C)    bool
    origin_rank: (K, C)    int32 - corner-packing tiebreak (low = preferred)
    item_class:  (G,)      int32 - request class of each batch item
    item_active: (G,)      bool  - padding mask

    Each round scores every class's candidates (K, C): best-fit (fewest
    free hosts on the slice), then the most adjacent free host pairs left,
    then the origin rank; sorts them best-first, and gives the r-th
    uncommitted item of a class (r its exclusive prefix count in batch
    order) the r-th best candidate. Conflicts are found with the exclusive
    prefix sum, along the items, of the (G, S, H) usage tensor: an item
    whose hosts an earlier item of this round asked for (committed or not)
    waits for the next round against the updated free state. Rounds repeat
    until one commits nothing.

    Returns (chosen, rounds): chosen[G] int32 on the inputs' device, the
    committed candidate per item or -1; rounds, the rounds run, the last
    of which committed nothing.
    """
    g = item_class.shape[0]
    s, h = free.shape
    k, c = cand_valid.shape
    dev = free.device
    item_idx = torch.arange(g, device=dev)
    cls = item_class.long()
    slice_of = cand_slice.long()
    chosen = torch.full((g,), -1, dtype=torch.int32, device=dev)
    rounds = 0
    while True:
        rounds += 1
        free_sel = free[slice_of]  # (K, C, H)
        feas = cand_valid & ~(cand_mask & ~free_sel).any(-1)  # (K, C)
        free_cnt = free.sum(-1, dtype=torch.int32)[slice_of]  # (K, C)
        free_after = free_sel & ~cand_mask
        pairs = (free_after[..., :-1] & free_after[..., 1:]).sum(-1, dtype=torch.int32)
        score_val = (free_cnt * h + (h - pairs)) * h + origin_rank
        score = torch.where(feas, -score_val, _NEG)
        order = torch.argsort(-score, dim=-1, stable=True)  # (K, C) best-first
        n_feas = feas.sum(-1, dtype=torch.int32)  # (K,)

        active_now = (chosen < 0) & item_active  # (G,)
        onehot = F.one_hot(cls, k).to(torch.int32) * active_now[:, None]
        rank = (torch.cumsum(onehot, 0, dtype=torch.int32) - onehot)[item_idx, cls]  # (G,)
        best = order[cls, rank.clamp(max=c - 1)]  # (G,)
        ok = active_now & (rank < n_feas[cls])

        bm = cand_mask[cls, best] & ok[:, None]  # (G, H)
        bs = slice_of[cls, best]  # (G,)
        usage = torch.zeros((g, s, h), dtype=torch.int32, device=dev)
        usage[item_idx, bs] = bm.to(torch.int32)
        flat = usage.reshape(g, s * h)
        prefix = torch.cumsum(flat, 0, dtype=torch.int32) - flat  # exclusive
        conflict = ((prefix > 0) & (flat > 0)).any(-1)
        commit = ok & ~conflict
        chosen = torch.where(commit, best.to(torch.int32), chosen)
        taken = (flat * commit[:, None] > 0).any(0).reshape(s, h)
        free = free & ~taken
        if not bool(commit.any()):  # the round's one sync with the host
            return chosen, rounds


def solve_batch_numpy(free, cand_mask, cand_slice, cand_valid, origin_rank,
                      item_class, item_active) -> np.ndarray:
    """The host arm, numpy only: the same rounds as `solve_batch`, op for op
    (stable argsort, exclusive prefix ranks), with the conflict resolution
    walked over the items that picked a candidate instead of the (G, S, H)
    usage tensor. Returns chosen[G] int32."""
    free = free.copy()
    g = item_class.shape[0]
    s, h = free.shape
    k, c = cand_valid.shape
    item_idx = np.arange(g)
    chosen = np.full(g, -1, dtype=np.int32)
    while True:
        free_sel = free[cand_slice]  # (K, C, H)
        feas = cand_valid & ~np.any(cand_mask & ~free_sel, axis=-1)  # (K, C)
        free_cnt = free.sum(axis=-1, dtype=np.int32)[cand_slice]  # (K, C)
        free_after = free_sel & ~cand_mask
        pairs = np.sum(
            free_after[..., :-1] & free_after[..., 1:], axis=-1, dtype=np.int32
        )
        score_val = (free_cnt * h + (h - pairs)) * h + origin_rank
        score = np.where(feas, -score_val, np.int32(_NEG))
        order = np.argsort(-score, axis=-1, kind="stable")  # best-first
        n_feas = feas.sum(axis=-1)

        active_now = (chosen < 0) & item_active
        onehot = np.zeros((g, k), dtype=np.int32)
        onehot[item_idx, item_class] = active_now.astype(np.int32)
        rank = (np.cumsum(onehot, axis=0) - onehot)[item_idx, item_class]
        best = order[item_class, np.minimum(rank, c - 1)]
        ok = active_now & (rank < n_feas[item_class])

        bm = cand_mask[item_class, best]  # (G, H)
        bs = cand_slice[item_class, best]
        seen = np.zeros((s, h), dtype=bool)
        committed = False
        for gi in np.nonzero(ok)[0]:
            row = bm[gi]
            sl = bs[gi]
            if (seen[sl] & row).any():
                seen[sl] |= row  # a loser's cells still block later items
                continue
            seen[sl] |= row
            chosen[gi] = best[gi]
            free[sl] &= ~row
            committed = True
        if not committed:
            return chosen


def _padded(a: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`a` at the top-left corner of zeros of `shape` (False for bool)."""
    out = np.zeros(shape, dtype=a.dtype)
    out[tuple(slice(0, n) for n in a.shape)] = a
    return out


class TorchSolver:
    """`solve_batch` behind the interface TPUPacker gives the jit arm; see
    the module docstring. `last_stats` holds the last solve's rounds, its
    item count and the padded (G, K, C)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # Sticky high-water marks for the padded axes: shapes only grow, so
        # the working set is allocated once at the largest cycle's size.
        self._pad_hwm = {"K": 1, "C": 1, "G": 1}
        self._cands = None  # (key, candidate tensors on self.device)
        self.last_stats = {}

    def _pad(self, axis: str, needed: int) -> int:
        self._pad_hwm[axis] = max(self._pad_hwm[axis], next_pow2(max(1, needed)))
        return self._pad_hwm[axis]

    def prewarm(self, slices: int, hosts: int, items: int = 1024, cands: int = 256,
                classes: int = 8) -> None:
        """Pins the padded axes to production scale and runs one throwaway
        solve on an empty pool, so the first real cycle pays no first-call
        costs (the card's allocations and library set-up)."""
        self._pad_hwm["G"] = max(self._pad_hwm["G"], next_pow2(items))
        self._pad_hwm["C"] = max(self._pad_hwm["C"], next_pow2(cands))
        self._pad_hwm["K"] = max(self._pad_hwm["K"], next_pow2(classes))
        k, c, g = self._pad_hwm["K"], self._pad_hwm["C"], self._pad_hwm["G"]
        h = next_pow2(hosts)
        self.solve(np.zeros((slices, h), dtype=bool),
                   (np.zeros((k, c, h), dtype=bool), np.zeros((k, c), dtype=np.int32),
                    np.zeros((k, c), dtype=bool), np.zeros((k, c), dtype=np.int32)),
                   np.zeros(g, dtype=np.int32), np.zeros(g, dtype=bool))
        self._cands = None

    def solve(self, free: np.ndarray, candidates: Tuple[np.ndarray, ...],
              item_class: np.ndarray, item_active: Optional[np.ndarray] = None,
              generation=None) -> np.ndarray:
        """chosen[G] int32 (numpy) for the batch's items: the committed
        candidate of each, or -1. `candidates` is (cand_mask, cand_slice,
        cand_valid, origin_rank) as `solve_batch` takes them; with a
        `generation` they are uploaded once and reused for every later
        solve of the same generation, without one they are uploaded anew.
        `item_active` defaults to every item."""
        s, h = free.shape
        if next_pow2(h) > MAX_HOSTS:
            raise ValueError(f"slice host count {h} overflows the solver score packing "
                             f"(at most {MAX_HOSTS})")
        k_real, c_real = candidates[2].shape
        k, c = self._pad("K", k_real), self._pad("C", c_real)
        key = (generation, k, c, h)
        if generation is None or self._cands is None or self._cands[0] != key:
            cand_mask, cand_slice, cand_valid, origin_rank = candidates
            self._cands = (key, tuple(
                torch.from_numpy(_padded(np.asarray(a, dtype=dt), shape)).to(self.device)
                for a, dt, shape in ((cand_mask, bool, (k, c, h)),
                                     (cand_slice, np.int32, (k, c)),
                                     (cand_valid, bool, (k, c)),
                                     (origin_rank, np.int32, (k, c)))))
        g_real = len(item_class)
        g = self._pad("G", g_real)
        if item_active is None:
            item_active = np.ones(g_real, dtype=bool)
        per_solve = (np.asarray(free, dtype=bool),
                     _padded(np.asarray(item_class, dtype=np.int32), (g,)),
                     _padded(np.asarray(item_active, dtype=bool), (g,)))
        free_d, class_d, active_d = (torch.from_numpy(a).to(self.device) for a in per_solve)
        chosen, rounds = solve_batch(free_d, *self._cands[1], class_d, active_d)
        self.last_stats = {"rounds": rounds, "items": g_real, "padded": (g, k, c)}
        return chosen[:g_real].cpu().numpy()


PACKER_KERNELS = ("torch", "numpy")

# Process-wide epoch source for candidate-cache generations: one request can
# be handed to more than one of this module's placers (A/B runs), so epochs
# must never collide across instances. JAX's placer stamps the same
# attributes from a counter of its own, which also starts at 1: a request
# object must not be shared between the two packages' placers.
_cand_epoch_source = itertools.count(1)


class TPUPacker:
    """The placer a scheduling cycle calls: `place(requests, snapshot, now)`
    admits a batch of pending gangs and returns each gang's Placement, or
    None for a gang that stays pending. Counterpart of JAX `TPUPacker`
    (training_operator_tpu/scheduler/packer.py), placement for placement.

    - TPU gangs: every legal contiguous sub-mesh of every gang on every
      compatible slice, with the slices' taints applied, is a candidate of
      the gang's class (tpu_type, topology, pods per slice, tolerations);
      one batched solve admits the whole batch in priority order
      (`_order`: wsjf-aging by default), multi-slice gangs are stitched
      from one item per slice, a duplicate slice is repaired against
      untouched free hosts, and starved whole-slice gangs get drain
      reservations (`_drain_and_preassign`).
    - GPU/CPU gangs: vectorised best-fit, NVLink-domain locality as the
      tiebreak (`_place_generic_batch`).

    `kernel` picks the solve. "torch" (the default, JAX's "jax" arm) orders
    the full request list and solves through `TorchSolver` on `device`,
    which resolves as the trainer's entry points do: the card unless the
    caller names another, and a RuntimeError when the card is asked for
    and absent. Its candidate tensors stay on the device while the
    candidate cache holds. "numpy" (JAX's "numpy" arm) is the plain
    reference on the host: a saturation pass drops every gang of a class
    with no feasible candidate, a per-class admission cap bounds the batch,
    and `solve_batch_numpy` solves it. Both return JAX's placements.

    The packer reads snapshots and requests only by attribute, so it also
    takes the JAX package's snapshots and GangRequests. It stamps memos on
    the request objects (`_class_hint`, keyed by this module's epoch
    counter; `_drain_hint` by the snapshot's inventory generation;
    `_generic_demand`; `_generic_hint`): JAX's placer stamps the same
    names, so each placer needs request objects of its own.

    `last_solve_stats` holds the last TPU solve's batch items, classes and
    candidates (padded on the torch arm, as JAX pads its jit arm), the
    kernel, and `solve_ms` (host clock around the solve, the result on the
    host) and, on the torch arm, the rounds.
    """

    def __init__(
        self,
        device=None,
        discipline: str = "wsjf-aging",
        aging_seconds: float = 300.0,
        default_expected_duration: float = 600.0,
        drain_reserve_seconds: float = 300.0,
        max_drain_fraction: float = 0.08,
        kernel: str = "torch",
    ) -> None:
        if kernel not in PACKER_KERNELS:
            raise ValueError(f"unknown solver kernel {kernel!r}; choose from {PACKER_KERNELS}")
        self.kernel = kernel
        self.solver = TorchSolver(device) if kernel == "torch" else None
        self.candidates = CandidateCache()
        self.last_solve_stats: Dict[str, Any] = {}
        # Queue discipline: the batch order is the solve's conflict
        # priority, not a head-of-line gate. "wsjf-aging" orders by work
        # (demand x declared expected duration), "sjf-aging" by demand,
        # "fifo" by arrival; a gang waiting past aging_seconds goes to the
        # front in arrival order.
        self.discipline = discipline
        self.aging_seconds = aging_seconds
        self.default_expected_duration = default_expected_duration
        # Drain reservations for whole-slice gangs waiting past
        # drain_reserve_seconds, at most max_drain_fraction of the slices a
        # cycle (<= 0 disables); the set of slice ids is sticky across
        # cycles, so a half-drained slice is never abandoned.
        self.drain_reserve_seconds = drain_reserve_seconds
        self.max_drain_fraction = max_drain_fraction
        self._drain_set: set = set()
        self.last_drain_stats: Dict[str, float] = {}
        # Candidate cache, keyed per slice and by the snapshot's inventory
        # generation; `_cand_epoch` versions it for the requests' class
        # hints. `_uploads` numbers each build of the candidate arrays: the
        # torch arm's resident tensors are keyed by it, so a class appended
        # or a taint repaired re-uploads them even where neither the
        # inventory generation nor the padded shape moved.
        self._tensor_cache: Optional[Dict[str, Any]] = None
        self._cand_epoch = next(_cand_epoch_source)
        self._uploads = itertools.count(1)
        self._generic_cache: Optional[Dict[str, Any]] = None
        self._drain_geo_cache: Optional[Tuple] = None

    @property
    def device(self) -> Optional[torch.device]:
        return self.solver.device if self.solver is not None else None

    def prewarm(self, snapshot, items: int = 1024, cands: int = 256, classes: int = 8) -> None:
        """Pins the torch arm's padded axes to production scale and runs one
        throwaway solve, so the first cycle pays no first-call costs. The
        numpy arm has nothing to warm."""
        if self.solver is None:
            return
        slices = list(snapshot.slices.values())
        if slices:
            self.solver.prewarm(len(slices), max(sl.num_hosts for sl in slices), items=items,
                                cands=cands, classes=classes)

    # ------------------------------------------------------------------

    def place(self, requests: List[Any], snapshot, now: Optional[float] = None
              ) -> Dict[str, Optional[Placement]]:
        out: Dict[str, Optional[Placement]] = {}
        tpu_reqs = [r for r in requests if r.topology is not None]
        generic = [r for r in requests if r.topology is None]
        if tpu_reqs:
            out.update(self._place_tpu_batch(tpu_reqs, snapshot, now))
        if generic:
            out.update(self._place_generic_batch(generic, snapshot, now))
        return out

    def _order(self, requests: List[Any], now: Optional[float], demand,
               charge_base: Optional[List[Any]] = None) -> List[Any]:
        """Batch priority order (= the solve's conflict priority).

        `charge_base` (defaults to `requests`): the population the WSJF
        missing-estimate median is taken over. The numpy arm orders only
        the feasible subset but charges estimate-less gangs from the full
        batch, so both arms break ties alike."""
        if self.discipline not in ("sjf-aging", "wsjf-aging") or now is None:
            return sorted(requests, key=lambda r: r.group.metadata.creation_time or 0.0)
        weigh = self.discipline == "wsjf-aging"
        # A gang without an estimate is charged the batch's median declared
        # duration, default_expected_duration when nobody declares one.
        missing_charge = self.default_expected_duration
        if weigh:
            declared = sorted(
                r.expected_duration
                for r in (charge_base if charge_base is not None else requests)
                if r.expected_duration
            )
            if declared:
                missing_charge = declared[len(declared) // 2]

        def key(r):
            created = r.group.metadata.creation_time or 0.0
            if now - created > self.aging_seconds:
                return (0, created, 0.0)  # starved: FIFO at the front
            w = demand(r)
            if weigh:
                w *= r.expected_duration or missing_charge
            return (1, w, created)  # smallest work first

        return sorted(requests, key=key)

    # ------------------------------------------------------------------
    # TPU batch solve
    # ------------------------------------------------------------------

    @staticmethod
    def _node_taint_sig(snapshot, node_name: str) -> Tuple:
        node = snapshot.nodes.get(node_name)
        return toleration_sig(node.taints) if node is not None else ()

    def _slice_candidates(self, sl, sidx: int, h_max: int, tpu_type: str, topology: str,
                          pods_per_slice: int, tolerations, snapshot
                          ) -> List[Tuple[int, np.ndarray, int]]:
        """One slice's legal candidates for one request class (the unit the
        cache repair rebuilds when a taint changes on a slice)."""
        if tpu_type and sl.tpu_type != tpu_type:
            return []
        need = topology_hosts_per_slice(topology, sl.chips_per_host)
        if need <= 0 or need != pods_per_slice:
            return []
        masks, ranks = self.candidates.get_arrays(sl.topology, sl.chips_per_host, topology,
                                                  h_max)
        if masks is None or masks.shape[0] == 0:
            return []
        cset = self.candidates.get(sl.topology, sl.chips_per_host, topology)
        if cset is None or cset.hosts_per_slice != sl.num_hosts:
            return []
        host_ok = np.ones(h_max, dtype=bool)
        for h, n in enumerate(sl.host_nodes):
            host_ok[h] = snapshot.tolerated(n, tolerations)
        legal = ~np.any(masks & ~host_ok, axis=-1)
        return [(sidx, masks[c], int(ranks[c])) for c in range(masks.shape[0]) if legal[c]]

    def _cand_tensors(self, slices: List[Any], h_max: int, snapshot) -> Dict[str, Any]:
        """The candidate cache for this inventory, keyed per slice: a taint
        change on an existing slice set re-enumerates only the changed
        slices' rows (in slice-major order, so a repaired cache equals a
        fresh build) and re-opens negatively cached classes; a change of
        slice set or geometry resets it. With the snapshot's inventory
        generation unchanged the signature walk is skipped."""
        cache = self._tensor_cache
        gen = getattr(snapshot, "inventory_gen", None)
        if cache is not None and gen is not None and cache.get("inv_gen") == gen:
            return cache
        ident = tuple(
            (sl.slice_id, sl.tpu_type, sl.topology, sl.chips_per_host, tuple(sl.host_nodes))
            for sl in slices
        )
        taints = tuple(
            tuple(self._node_taint_sig(snapshot, n) for n in sl.host_nodes) for sl in slices
        )
        if cache is None or cache["ident"] != ident or cache["h_max"] != h_max:
            self._cand_epoch = next(_cand_epoch_source)
            cache = self._tensor_cache = {
                "ident": ident,
                "taints": taints,
                "h_max": h_max,
                "inv_gen": gen,
                "epoch": self._cand_epoch,
                "class_ids": {},
                "class_meta": [],  # per class: (tpu_type, topology, pps, tolerations)
                "class_cands": [],
                "arrays": None,
                "shape": None,
                "upload": None,
            }
            return cache
        cache["inv_gen"] = gen
        if cache["taints"] != taints:
            self._cand_epoch = next(_cand_epoch_source)
            cache["epoch"] = self._cand_epoch
            changed = {i for i in range(len(slices)) if cache["taints"][i] != taints[i]}
            cache["taints"] = taints
            # Negative results may have been taint-caused: re-open them.
            cache["class_ids"] = {
                key: idx for key, idx in cache["class_ids"].items() if idx is not None
            }
            for idx, meta in enumerate(cache["class_meta"]):
                tpu_type, topology, pps, tolerations = meta
                by_slice: Dict[int, List[Tuple[int, np.ndarray, int]]] = {}
                for sidx, m, rank in cache["class_cands"][idx]:
                    by_slice.setdefault(sidx, []).append((sidx, m, rank))
                for i in changed:
                    by_slice[i] = self._slice_candidates(slices[i], i, h_max, tpu_type,
                                                         topology, pps, tolerations, snapshot)
                cache["class_cands"][idx] = [
                    c for i in range(len(slices)) for c in by_slice.get(i, [])
                ]
            cache["arrays"] = None
        return cache

    def _class_of(self, cache: Dict[str, Any], slices: List[Any], h_max: int, req,
                  pods_per_slice: int, snapshot) -> Optional[int]:
        """Request class id: (tpu_type, topology, pods_per_slice, toleration
        signature). A class owns its candidates across every compatible
        slice, those on hosts whose taints it does not tolerate dropped."""
        class_ids: Dict[Tuple, Optional[int]] = cache["class_ids"]
        key = (req.tpu_type, req.topology, pods_per_slice, req.toleration_sig())
        if key in class_ids:
            return class_ids[key]
        cands: List[Tuple[int, np.ndarray, int]] = []
        for i, sl in enumerate(slices):
            cands.extend(self._slice_candidates(sl, i, h_max, req.tpu_type, req.topology,
                                                pods_per_slice, req.tolerations, snapshot))
        if not cands:
            class_ids[key] = None  # negative results are cached too
            return None
        class_ids[key] = len(cache["class_cands"])
        cache["class_cands"].append(cands)
        cache["class_meta"].append(
            (req.tpu_type, req.topology, pods_per_slice, [dict(t) for t in req.tolerations])
        )
        cache["arrays"] = None  # the candidate arrays must take the new class
        return class_ids[key]

    def _drain_and_preassign(self, requests: List[Any], slices: List[Any], free: np.ndarray,
                             snapshot, now: Optional[float],
                             out: Dict[str, Optional[Placement]]
                             ) -> Tuple[np.ndarray, frozenset]:
        """Tail-latency control for whole-slice gangs. Returns (masked free
        copy, reserved slice indices) and writes the placements of starved
        gangs it satisfies into `out`.

        1. Pre-assign: starved whole-slice gangs, longest-waiting first,
           take fully free slices before the solve, so the backlog of small
           gangs cannot nibble a slice in the cycle it drains.
        2. Sticky reserve: for the slice demand still unmet, the partially
           free slices closest to empty are withheld from the solve until
           they drain, at most max_drain_fraction of the slices.
        """
        if now is None or self.drain_reserve_seconds <= 0:
            return free, frozenset()
        gen = getattr(snapshot, "inventory_gen", None)
        gc = self._drain_geo_cache
        if gc is None or gen is None or gc[0] != gen:
            geo_members: Dict[Tuple, List[int]] = {}
            for i, sl in enumerate(slices):
                geo_members.setdefault((sl.tpu_type, sl.chips_per_host, sl.num_hosts),
                                       []).append(i)
            gc = (gen, geo_members)
            if gen is not None:
                self._drain_geo_cache = gc
        geo_members = gc[1]
        starved: List[Tuple[float, Any, List[int]]] = []
        threshold = now - self.drain_reserve_seconds
        for req in requests:
            created = req.group.metadata.creation_time or 0.0
            if created > threshold:
                continue
            hint = req.__dict__.get("_drain_hint")
            if hint is not None and gen is not None and hint[0] == gen:
                compat = hint[1]
            else:
                compat = None
                if req.num_slices > 0 and not len(req.pods) % req.num_slices:
                    pps = len(req.pods) // req.num_slices
                    # Slices the gang could occupy whole: tpu_type matches,
                    # the per-slice host need equals the slice's host count
                    # and one pod lands per host.
                    compat = []
                    for (gtype, gchips, ghosts), members in geo_members.items():
                        if req.tpu_type and gtype != req.tpu_type:
                            continue
                        if request_hosts_per_slice(req, gchips) == ghosts == pps:
                            compat.extend(members)
                    compat.sort()
                    if not compat:
                        compat = None
                req.__dict__["_drain_hint"] = (gen, compat)
            if compat:
                starved.append((created, req, compat))
        if not starved:
            self._drain_set.clear()
            self.last_drain_stats = {}
            return free, frozenset()
        starved.sort(key=lambda t: t[0])
        free = free.copy()
        avail = [i for i, sl in enumerate(slices) if bool(free[i, : sl.num_hosts].all())]
        tainted_slice = [
            any((n_obj := snapshot.nodes.get(n)) is not None and n_obj.taints
                for n in sl.host_nodes)
            for sl in slices
        ]
        preassigned = 0
        accum_reserved: List[int] = []
        remaining: List[Tuple[Any, List[int], int]] = []
        for _, req, compat in starved:
            k = req.num_slices
            if avail:
                compat_set = set(compat)
                usable = [
                    i for i in avail
                    if i in compat_set
                    and (not tainted_slice[i]
                         or all(snapshot.tolerated(n, req.tolerations)
                                for n in slices[i].host_nodes))
                ]
            else:
                usable = []
            if len(usable) < k:
                # Accumulate: hold this gang's already-free compatible
                # slices so the backfill cannot fragment them again in the
                # cycle they freed.
                for i in usable:
                    accum_reserved.append(i)
                    avail.remove(i)
                    free[i, :] = False
                    self._drain_set.add(slices[i].slice_id)
                remaining.append((req, compat, k - len(usable)))
                continue
            pods = req.sorted_pods()
            pps = len(pods) // k
            assignments: Dict[str, str] = {}
            slices_used: List[str] = []
            for sub, i in enumerate(usable[:k]):
                sl = slices[i]
                for pod, node in zip(pods[sub * pps : (sub + 1) * pps], sl.host_nodes):
                    assignments[pod.name] = node
                    snapshot.commit(pod.resources, node)
                free[i, :] = False
                avail.remove(i)
                self._drain_set.discard(sl.slice_id)
                slices_used.append(sl.slice_id)
            out[req.key] = Placement(assignments=assignments, slices_used=slices_used)
            preassigned += 1
        demand = sum(short for _, _, short in remaining)
        # The cap admits at least the largest single gang's shortfall, or a
        # multi-slice gang could never gather its slices on a small pool.
        cap = max(1, int(len(slices) * self.max_drain_fraction),
                  max((short for _, _, short in remaining), default=1))
        reserved: List[int] = []
        if demand <= 0:
            self._drain_set.clear()
        else:
            # Reserve only slices some remaining starved gang could occupy.
            compat_union: set = set()
            for _, compat, _short in remaining:
                compat_union.update(compat)
            by_id = {sl.slice_id: i for i, sl in enumerate(slices)}
            self._drain_set = {
                sid for sid in self._drain_set if sid in by_id and by_id[sid] in compat_union
            }
            reserved = [by_id[sid] for sid in self._drain_set]
            target = min(demand, cap) + len(accum_reserved)
            if len(reserved) > target:
                # Demand shrank: release the least drained extras.
                reserved.sort(key=lambda i: int(free[i, : slices[i].num_hosts].sum()),
                              reverse=True)
                for i in reserved[target:]:
                    self._drain_set.discard(slices[i].slice_id)
                reserved = reserved[:target]
            need_more = target - len(reserved)
            if need_more > 0:
                partial = sorted(
                    (
                        (int(free[i, : sl.num_hosts].sum()), i)
                        for i, sl in enumerate(slices)
                        if i in compat_union
                        and i not in {by_id[s] for s in self._drain_set}
                        and 0 < int(free[i, : sl.num_hosts].sum()) < sl.num_hosts
                    ),
                    reverse=True,
                )
                for _, i in partial[:need_more]:
                    reserved.append(i)
                    self._drain_set.add(slices[i].slice_id)
            for i in reserved:
                free[i, :] = False
        self.last_drain_stats = {
            "starved_gangs": float(len(starved)),
            "preassigned_gangs": float(preassigned),
            "reserved_slices": float(len(reserved)),
        }
        return free, frozenset(reserved)

    @staticmethod
    def _free_hosts(slices: List[Any], h_max: int, snapshot) -> np.ndarray:
        """(S, h_max) bool: host h of slice s has its whole chip block free."""
        free = np.zeros((len(slices), h_max), dtype=bool)
        free_map = snapshot.free
        for i, sl in enumerate(slices):
            chips = sl.chips_per_host
            for h, node in enumerate(sl.host_nodes):
                avail = free_map.get(node)
                free[i, h] = avail is not None and avail.get(TPU_RESOURCE, 0.0) >= chips
        return free

    def _place_tpu_batch(self, requests: List[Any], snapshot, now: Optional[float] = None
                         ) -> Dict[str, Optional[Placement]]:
        # Canonical slice order (by id): candidate enumeration, and with it
        # every score tie-break, must not depend on the snapshot's order.
        slices = sorted(snapshot.slices.values(), key=lambda sl: sl.slice_id)
        out: Dict[str, Optional[Placement]] = {r.key: None for r in requests}
        if not slices:
            return out
        h_max = next_pow2(max(sl.num_hosts for sl in slices))
        if h_max > MAX_HOSTS:
            raise ValueError(f"slice host count {h_max} overflows the solver score packing "
                             f"(at most {MAX_HOSTS})")
        cache = self._cand_tensors(slices, h_max, snapshot)
        class_cands: List[List[Tuple[int, np.ndarray, int]]] = cache["class_cands"]
        free = self._free_hosts(slices, h_max, snapshot)
        free, drain_reserved = self._drain_and_preassign(requests, slices, free, snapshot, now,
                                                         out)

        # Class resolution with warm hints: a request carries its (cache
        # epoch, class id) from the last cycle.
        epoch = cache["epoch"]
        classed: List[Any] = []
        for req in requests:
            if out.get(req.key) is not None:
                continue  # pre-assigned by the drain path
            hint = req._class_hint
            if hint is not None and hint[0] == epoch:
                k = hint[1]
            else:
                if req.num_slices <= 0 or len(req.pods) % req.num_slices:
                    req._class_hint = (epoch, None)
                    continue
                pods_per_slice = len(req.pods) // req.num_slices
                k = self._class_of(cache, slices, h_max, req, pods_per_slice, snapshot)
                req._class_hint = (epoch, k)
            if k is not None:
                classed.append(req)
        if not classed:
            return out

        # Exact shapes: on the torch arm TorchSolver pads (once).
        k_count = len(class_cands)
        c_max = max(1, max((len(c) for c in class_cands), default=1))
        if cache["arrays"] is None or cache["shape"] != (k_count, c_max, h_max):
            cand_mask = np.zeros((k_count, c_max, h_max), dtype=bool)
            cand_slice = np.zeros((k_count, c_max), dtype=np.int32)
            cand_valid = np.zeros((k_count, c_max), dtype=bool)
            origin_rank = np.zeros((k_count, c_max), dtype=np.int32)
            for k, cands in enumerate(class_cands):
                for c, (sidx, m, rank) in enumerate(cands):
                    cand_mask[k, c] = m
                    cand_slice[k, c] = sidx
                    cand_valid[k, c] = True
                    origin_rank[k, c] = rank
            cache["arrays"] = (cand_mask, cand_slice, cand_valid, origin_rank)
            cache["shape"] = (k_count, c_max, h_max)
            cache["upload"] = next(self._uploads)

        # Saturation pass (numpy arm): a class with no feasible candidate
        # against this cycle's free state admits nothing this cycle.
        n_feas = None
        if self.solver is None:
            cm, cs, cv, _ = cache["arrays"]
            feas_cls = cv & ~np.any(cm & ~free[cs], axis=-1)
            n_feas = feas_cls.sum(axis=-1).tolist()
            classed = [r for r in classed if n_feas[r._class_hint[1]] > 0]
            if not classed:
                self.last_solve_stats = {
                    "batch_items": 0.0,
                    "classes": float(k_count),
                    "candidates": float(c_max),
                    "kernel": self.kernel,
                }
                return out

        # Per-slice sub-items in priority order. The torch arm orders the
        # full request list (JAX's jit arm); the numpy arm the feasible
        # subset, charging the WSJF median from the full list.
        ordered = self._order(requests if self.solver is not None else classed, now,
                              lambda r: r.total_chips(), charge_base=requests)
        # Per-class admission cap (numpy arm): the solve commits at most
        # n_feas[k] items of class k, so a gang whose place in its class is
        # past that bound cannot commit and is dropped with identical
        # output; a gang straddling it stays whole.
        budget = dict(enumerate(n_feas)) if n_feas is not None else None
        items: List[Tuple[Any, int, int]] = []  # (req, sub_index, class)
        for req in ordered:
            hint = req._class_hint
            if out.get(req.key) is not None or hint is None or hint[0] != epoch or hint[1] is None:
                continue
            k = hint[1]
            if budget is not None:
                left = budget[k]
                if left <= 0:
                    continue
                budget[k] = left - req.num_slices
            for sub in range(req.num_slices):
                items.append((req, sub, k))
        if not items:
            return out

        item_class = np.fromiter((k for _, _, k in items), dtype=np.int32, count=len(items))
        t0 = time.perf_counter()
        if self.solver is not None:
            chosen = self.solver.solve(free, cache["arrays"], item_class,
                                       generation=cache["upload"])
            solve_ms = (time.perf_counter() - t0) * 1e3
            _, k_pad, c_pad = self.solver.last_stats["padded"]
            self.last_solve_stats = {
                "batch_items": float(len(items)),
                "classes": float(k_pad),
                "candidates": float(c_pad),
                "kernel": self.kernel,
                "rounds": float(self.solver.last_stats["rounds"]),
                "solve_ms": solve_ms,
            }
        else:
            chosen = solve_batch_numpy(free, *cache["arrays"], item_class,
                                       np.ones(len(items), dtype=bool))
            self.last_solve_stats = {
                "batch_items": float(len(items)),
                "classes": float(k_count),
                "candidates": float(c_max),
                "kernel": self.kernel,
                "solve_ms": (time.perf_counter() - t0) * 1e3,
            }
        ok = chosen >= 0
        choice = np.maximum(chosen, 0)

        # Stitch sub-item results back into whole-gang placements.
        partial: Dict[str, List[Tuple[int, int]]] = {}
        failed: set = set()
        for g, (req, sub, k) in enumerate(items):
            if not ok[g]:
                failed.add(req.key)
                continue
            partial.setdefault(req.key, []).append((sub, int(choice[g])))

        # Every host the solve granted to a gang that will be stitched: a
        # duplicate-slice repair must never take one. Grants to partially
        # admitted gangs are free for the repair.
        kernel_taken = np.zeros((len(slices), h_max), dtype=bool)
        for g, (req, sub, k) in enumerate(items):
            if ok[g] and req.key not in failed:
                sidx, m, _rank = class_cands[k][int(choice[g])]
                kernel_taken[sidx] |= m

        for req in ordered:
            if req.key in failed or req.key not in partial:
                continue
            subs = sorted(partial[req.key])
            pods = req.sorted_pods()
            pods_per_slice = len(pods) // req.num_slices
            k = req._class_hint[1]
            # Each sub-request owns a distinct slice (inter-slice traffic
            # rides DCN). The solve usually spreads identical items over
            # slices; a duplicate is repaired against untouched free hosts,
            # or the whole gang waits for the next cycle.
            picked: List[Tuple[int, Tuple[int, np.ndarray, int]]] = []
            used_slices: set = set()
            dups: List[int] = []
            for sub, c in subs:
                cand = class_cands[k][c]
                if cand[0] in used_slices:
                    dups.append(sub)
                else:
                    used_slices.add(cand[0])
                    picked.append((sub, cand))
            repaired = True
            for sub in dups:
                alt = self._repair_duplicate_slice(class_cands[k], used_slices | drain_reserved,
                                                   kernel_taken, snapshot, slices)
                if alt is None:
                    repaired = False
                    break
                used_slices.add(alt[0])
                kernel_taken[alt[0]] |= alt[1]
                picked.append((sub, alt))
            if not repaired:
                continue

            assignments: Dict[str, str] = {}
            slices_used: List[str] = []
            for sub, (sidx, m, _rank) in sorted(picked, key=lambda p: p[0]):
                sl = slices[sidx]
                hosts = [sl.host_nodes[h] for h in range(sl.num_hosts) if m[h]]
                for pod, node in zip(pods[sub * pods_per_slice : (sub + 1) * pods_per_slice],
                                     hosts):
                    assignments[pod.name] = node
                    snapshot.commit(pod.resources, node)
                slices_used.append(sl.slice_id)
            out[req.key] = Placement(assignments=assignments, slices_used=slices_used)
        return out

    @staticmethod
    def _repair_duplicate_slice(cands: List[Tuple[int, np.ndarray, int]], used_slices: set,
                                kernel_taken: np.ndarray, snapshot, slices: List[Any]
                                ) -> Optional[Tuple[int, np.ndarray, int]]:
        """An alternative candidate on a slice the gang does not use yet,
        whose hosts are free in the live snapshot and were granted to no
        gang by this cycle's solve."""
        for sidx, m, rank in cands:
            if sidx in used_slices:
                continue
            if np.any(m & kernel_taken[sidx]):
                continue
            sl = slices[sidx]
            if all(snapshot.host_free(sl.host_nodes[h], sl.chips_per_host)
                   for h in range(sl.num_hosts) if m[h]):
                return (sidx, m, rank)
        return None

    # ------------------------------------------------------------------
    # Generic (GPU/CPU) batch solve: vectorised best-fit + NVLink locality
    # ------------------------------------------------------------------

    def _place_generic_batch(self, requests: List[Any], snapshot, now: Optional[float] = None
                             ) -> Dict[str, Optional[Placement]]:
        out: Dict[str, Optional[Placement]] = {}
        # Pool indexes (node list, resource layout, NVLink domains, taint
        # columns), kept by inventory generation.
        gen = getattr(snapshot, "inventory_gen", None)
        gc = self._generic_cache
        if gc is None or gen is None or gc["gen"] != gen:
            node_names = [n for n in snapshot.free if snapshot.nodes[n].accelerator.kind != "tpu"]
            res_keys = sorted({k for n in node_names for k in snapshot.free[n]})
            ridx = {k: i for i, k in enumerate(res_keys)}
            # Domains are compared for equality only, within one process:
            # Python's string hash differs from process to process.
            domains = np.array(
                [hash(snapshot.nodes[n].accelerator.nvlink_domain or n) % (2**31)
                 for n in node_names],
                dtype=np.int64,
            )
            tainted_cols = [i for i, n in enumerate(node_names) if snapshot.nodes[n].taints]
            gc = {"gen": gen, "node_names": node_names, "res_keys": res_keys, "ridx": ridx,
                  "domains": domains, "tainted_cols": tainted_cols}
            if gen is not None:
                self._generic_cache = gc
        node_names = gc["node_names"]
        res_keys, ridx = gc["res_keys"], gc["ridx"]
        domains, tainted_cols = gc["domains"], gc["tainted_cols"]
        if not node_names:
            # No non-TPU node: generic gangs stay pending rather than take
            # TPU-host capacity from the TPU gang solve.
            return {r.key: None for r in requests}
        # Saturation filters (per-resource best node and aggregate free) in
        # one pass, without the node matrix.
        nres = len(res_keys)
        free_max = [0.0] * nres
        free_tot = [0.0] * nres
        free_src = snapshot.free
        for n in node_names:
            avail = free_src.get(n)
            if avail is None:
                continue
            for k, v in avail.items():
                idx = ridx.get(k)
                if idx is not None:
                    free_tot[idx] += v
                    if v > free_max[idx]:
                        free_max[idx] = v

        def demand(r) -> float:
            # GPUs are the contended resource; CPU breaks ties at about a
            # node's granularity. Memoized on the long-lived request.
            d = r.__dict__.get("_generic_demand")
            if d is None:
                d = sum(p.resources.get(GPU_RESOURCE, 0.0) + p.resources.get("cpu", 0.0) / 64.0
                        for p in r.pods)
                r.__dict__["_generic_demand"] = d
            return d

        # Two necessary conditions per gang: its largest single-pod ask fits
        # some node, and its total ask fits the pool's aggregate free.
        layout_key = tuple(res_keys)
        survivors: List[Any] = []
        for req in requests:
            hint = req._generic_hint
            if hint is None or hint[0] != layout_key:
                vec: Optional[List[float]] = [0.0] * nres
                tot: Optional[List[float]] = [0.0] * nres
                for pod in req.pods:
                    for k, v in pod.resources.items():
                        idx = ridx.get(k)
                        if idx is None:
                            if v > 0:
                                vec = tot = None  # unsatisfiable resource
                                break
                        else:
                            tot[idx] += v
                            if v > vec[idx]:
                                vec[idx] = v
                    if vec is None:
                        break
                req._generic_hint = hint = (layout_key, vec, tot)
            maxvec, totvec = hint[1], hint[2]
            if maxvec is None or any(
                m > fm + 1e-9 or t > ft + 1e-9
                for m, fm, t, ft in zip(maxvec, free_max, totvec, free_tot)
            ):
                out[req.key] = None
            else:
                survivors.append(req)
        if not survivors:
            return out

        free = np.zeros((len(node_names), nres))
        for i, n in enumerate(node_names):
            avail = free_src.get(n)
            if avail is None:
                continue
            for k, v in avail.items():
                idx = ridx.get(k)
                if idx is not None:
                    free[i, idx] = v

        ordered = self._order(survivors, now, demand, charge_base=requests)
        for req in ordered:
            # Re-check against the free state earlier admissions of this
            # cycle left.
            maxvec, totvec = req._generic_hint[1], req._generic_hint[2]
            if any(
                m > fm + 1e-9 or tv > ft + 1e-9
                for m, fm, tv, ft in zip(maxvec, free_max, totvec, free_tot)
            ):
                out[req.key] = None
                continue
            # Pods with identical (resources, tolerations) are placed as one
            # group: per-node fit counts, then a greedy take in best-fit
            # order (the same as per-pod sequential best-fit).
            groups: List[Tuple[np.ndarray, Any, List[Any]]] = []
            group_index: Dict[Tuple, int] = {}
            for pod in req.sorted_pods():
                rv = np.zeros(len(res_keys))
                for k, v in pod.resources.items():
                    if k in ridx:
                        rv[ridx[k]] = v
                    elif v > 0:
                        rv[:] = np.inf  # unsatisfiable resource
                gkey = (tuple(rv), toleration_sig(pod.tolerations))
                gi = group_index.get(gkey)
                if gi is None:
                    group_index[gkey] = len(groups)
                    groups.append((rv, pod.tolerations, [pod]))
                else:
                    groups[gi][2].append(pod)

            assignments: Dict[str, str] = {}
            committed: List[Tuple[np.ndarray, int, int]] = []  # (rv, node, count)
            group_domains: set = set()
            placed_all = True
            for rv, tolerations, pods in groups:
                feas_base = np.isfinite(rv).all() and bool((free >= rv).all(axis=1).any())
                requested = rv > 0
                remaining = list(pods)
                tainted_bad = {i for i in tainted_cols
                               if not snapshot.tolerated(node_names[i], tolerations)}
                while remaining:
                    feas = (np.all(free >= rv, axis=1) if feas_base
                            else np.zeros(len(node_names), bool))
                    for i in tainted_bad:
                        feas[i] = False
                    if not feas.any():
                        placed_all = False
                        break
                    # Best-fit on the requested dimensions, the NVLink
                    # domain as the tiebreak only: locality above best-fit
                    # strands half-nodes across domains.
                    leftover = ((free - rv) * requested).sum(axis=1)
                    bonus = (np.isin(domains, list(group_domains)) * 0.5
                             if group_domains else 0.0)
                    score = np.where(feas, -leftover * 1024.0 + bonus, -np.inf)
                    i = int(np.argmax(score))
                    with np.errstate(divide="ignore", invalid="ignore"):
                        fits = np.where(requested, free[i] // np.where(requested, rv, 1.0),
                                        np.inf)
                    cap = (int(min(fits.min(), len(remaining))) if requested.any()
                           else len(remaining))
                    take, remaining = remaining[:cap], remaining[cap:]
                    for pod in take:
                        assignments[pod.name] = node_names[i]
                    free[i] -= rv * len(take)
                    committed.append((rv, i, len(take)))
                    group_domains.add(int(domains[i]))
                if not placed_all:
                    break
            if placed_all and assignments:
                for pod in req.pods:
                    snapshot.commit(pod.resources, assignments[pod.name])
                out[req.key] = Placement(assignments=assignments)
                free_max = free.max(axis=0).tolist()
                free_tot = free.sum(axis=0).tolist()
            else:
                for rv, i, cnt in committed:
                    free[i] += rv * cnt
                out[req.key] = None
        return out


SCALE_SHAPES = (("1x4", 1), ("1x4", 1), ("2x4", 2), ("4x4", 4))


def scale_instance(n_slices: int = 2500, n_gangs: int = 2000, hosts: int = 4,
                   seed: int = 7) -> Tuple[np.ndarray, ...]:
    """The solver bench's 10k-node block (bench.py `run_solver_scale`,
    BENCH_SELF_SOLVER_r13.json `scale_10k`) as solve_batch's inputs, numpy:
    `n_slices` fully free slices of `hosts` hosts (topology 4x4: 4 hosts of
    4 chips); `n_gangs` single-slice gangs whose shapes `random.Random(seed)`
    draws from SCALE_SHAPES, in creation order; one class per host count
    (ascending); a class's candidates every contiguous window of its host
    count on every slice, slice-major, its origin rank the window's start.
    Returns (free, cand_mask, cand_slice, cand_valid, origin_rank,
    item_class, item_active), the candidate axis as long as the largest
    class's."""
    rng = random.Random(seed)
    gang_hosts = [rng.choice(SCALE_SHAPES)[1] for _ in range(n_gangs)]
    widths = sorted({w for _, w in SCALE_SHAPES})
    k = len(widths)
    c = n_slices * hosts  # the 1-host class: every host of every slice
    cand_mask = np.zeros((k, c, hosts), dtype=bool)
    cand_slice = np.zeros((k, c), dtype=np.int32)
    cand_valid = np.zeros((k, c), dtype=bool)
    origin_rank = np.zeros((k, c), dtype=np.int32)
    for ki, w in enumerate(widths):
        starts = hosts - w + 1
        n = n_slices * starts
        origin = np.tile(np.arange(starts), n_slices)
        cand_slice[ki, :n] = np.repeat(np.arange(n_slices), starts)
        origin_rank[ki, :n] = origin
        cand_valid[ki, :n] = True
        cols = np.arange(hosts)
        cand_mask[ki, :n] = (cols >= origin[:, None]) & (cols < origin[:, None] + w)
    item_class = np.array([widths.index(w) for w in gang_hosts], dtype=np.int32)
    return (np.ones((n_slices, hosts), dtype=bool), cand_mask, cand_slice, cand_valid,
            origin_rank, item_class, np.ones(n_gangs, dtype=bool))
