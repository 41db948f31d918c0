"""The batched gang-placement solve on the card.

Counterpart of training_operator_tpu/scheduler/packer.py's `_next_pow2`,
`_solve_batch` (the XLA-jit arm of the placement engine) and
`_solve_batch_numpy`. One solve admits a whole FIFO batch of gang items
against the host inventory in parallel rounds (see `solve_batch`); all arms
return bit-identical placements.

- `solve_batch` runs JAX's vectorised form op for op on torch tensors, on
  the device they lie on. `jax.lax.while_loop` becomes a Python loop that
  reads `commit.any()` on the host once per round; the rounds are counted.
  `torch.argsort(stable=True)` keeps JAX's stable order among equal scores,
  the rank is clamped to the candidate axis as JAX clamps a gather, and the
  sums and prefix counts are taken in int32 (torch's default is int64).
- `TorchSolver` drives it as TPUPacker drives the jit arm: item, class and
  candidate axes padded to powers of two through sticky high-water marks,
  candidate tensors uploaded once per inventory generation and kept on the
  card, only the free-host matrix and the item vectors sent per solve, and
  one transfer of the result back. Numpy in, numpy out, on the card unless
  the caller passes another device.
- `solve_batch_numpy` is the host arm, numpy only: the plain reference the
  card's placements are held to.
- `scale_instance` builds the 10k-node block of the repo's solver bench
  (2500 slices of 4 hosts, 2000 single-slice gangs) as tensors.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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
