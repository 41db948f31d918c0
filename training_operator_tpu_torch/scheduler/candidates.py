"""ICI sub-mesh candidate enumeration.

Counterpart of training_operator_tpu/scheduler/candidates.py. A gang asking
for topology "2x4" on a "4x4" slice can only run on host sets whose chips
form a contiguous axis-aligned 2x4 sub-grid of the slice's ICI mesh. For
each (slice geometry, request topology) pair every valid placement is
enumerated once as a boolean mask over the slice's hosts; slices of equal
geometry share the enumeration, which is what lets the placer score every
(gang x slice x candidate) combination as one tensor op.

Host model (cluster/inventory.make_tpu_slice): each host owns `chips_per_host`
consecutive chips along the slice grid's minor axis, so the hosts form a
grid of shape dims[:-1] + [minor // chips_per_host].
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from training_operator_tpu_torch.cluster.inventory import parse_topology


@dataclass(frozen=True)
class CandidateSet:
    """All valid host masks for one (slice geometry, request) pair.

    masks[c][h]: candidate c uses host h of the slice. `origin_rank[c]`
    orders candidates by grid origin (low corner first).
    """

    hosts_per_slice: int
    masks: Tuple[Tuple[bool, ...], ...]
    origin_rank: Tuple[int, ...]

    @property
    def num_candidates(self) -> int:
        return len(self.masks)


def host_grid_dims(slice_topology: str, chips_per_host: int) -> Optional[List[int]]:
    """Shape of the host grid, or None if hosts don't tile the minor axis."""
    dims = parse_topology(slice_topology)
    minor = dims[-1]
    if chips_per_host <= minor:
        if minor % chips_per_host:
            return None
        return dims[:-1] + [minor // chips_per_host]
    # A host spanning several minor rows (v4 hosts own 2x2x1 blocks) is
    # modelled as spanning whole minor rows.
    if chips_per_host % minor:
        return None
    rows = chips_per_host // minor
    if len(dims) < 2 or dims[-2] % rows:
        return None
    reduced = list(dims[:-1])
    reduced[-1] //= rows
    return reduced + [1]


def _request_host_dims(req_dims: Sequence[int], slice_dims: Sequence[int],
                       chips_per_host: int) -> Optional[List[int]]:
    """A chip-grid request in host-grid units for one orientation: the
    minor axis must cover whole hosts, other axes map 1:1, and a request of
    lower rank than the slice is right-aligned."""
    hdims = host_grid_dims("x".join(str(d) for d in slice_dims), chips_per_host)
    if hdims is None:
        return None
    rd = list(req_dims)
    if len(rd) < len(slice_dims):
        rd = [1] * (len(slice_dims) - len(rd)) + rd
    if len(rd) != len(slice_dims):
        return None
    minor = slice_dims[-1]
    per_host_minor = min(chips_per_host, minor)
    if rd[-1] % per_host_minor:
        return None
    out = rd[:-1] + [rd[-1] // per_host_minor]
    if chips_per_host > minor:  # hosts spanning minor rows fold the next axis too
        rows = chips_per_host // minor
        if out[-2] % rows:
            return None
        out[-2] //= rows
    for r, s in zip(out, hdims):
        if r > s:
            return None
    return out


def enumerate_candidates(slice_topology: str, chips_per_host: int,
                         request_topology: str) -> Optional[CandidateSet]:
    """Every contiguous placement of `request_topology` chips on the slice,
    over every axis permutation of the request; masks that two permutations
    both give are kept once."""
    slice_dims = parse_topology(slice_topology)
    hdims = host_grid_dims(slice_topology, chips_per_host)
    if hdims is None:
        return None
    n_hosts = 1
    for d in hdims:
        n_hosts *= d
    req_dims = parse_topology(request_topology)

    seen: Dict[Tuple[bool, ...], int] = {}
    masks: List[Tuple[bool, ...]] = []
    ranks: List[int] = []
    for perm in sorted(set(itertools.permutations(req_dims))):
        rhost = _request_host_dims(perm, slice_dims, chips_per_host)
        if rhost is None:
            continue
        for origin in itertools.product(*[range(s - r + 1) for r, s in zip(rhost, hdims)]):
            mask = [False] * n_hosts
            for cell in itertools.product(*[range(r) for r in rhost]):
                flat = 0
                for o, c, s in zip(origin, cell, hdims):
                    flat = flat * s + (o + c)
                mask[flat] = True
            key = tuple(mask)
            if key in seen:
                continue
            seen[key] = len(masks)
            masks.append(key)
            rank = 0  # row-major origin rank: low corners first
            for o, s in zip(origin, hdims):
                rank = rank * s + o
            ranks.append(rank)
    if not masks:
        return None
    return CandidateSet(hosts_per_slice=n_hosts, masks=tuple(masks), origin_rank=tuple(ranks))


class CandidateCache:
    """Memoizes enumerations across solves (geometry classes are few)."""

    def __init__(self) -> None:
        self._cache: Dict[Tuple[str, int, str], Optional[CandidateSet]] = {}
        self._arrays: Dict[Tuple[str, int, str, int], Tuple] = {}

    def get(self, slice_topology: str, chips_per_host: int,
            request_topology: str) -> Optional[CandidateSet]:
        key = (slice_topology, chips_per_host, request_topology)
        if key not in self._cache:
            self._cache[key] = enumerate_candidates(*key)
        return self._cache[key]

    def get_arrays(self, slice_topology: str, chips_per_host: int, request_topology: str,
                   h_pad: int):
        """The enumeration as padded arrays: (masks (C, h_pad) bool, origin
        ranks (C,) int32), memoized per geometry and pad width; (None, None)
        when no contiguous placement exists."""
        key = (slice_topology, chips_per_host, request_topology, h_pad)
        hit = self._arrays.get(key)
        if hit is not None:
            return hit
        cset = self.get(slice_topology, chips_per_host, request_topology)
        if cset is None:
            out = (None, None)
        else:
            masks = np.zeros((cset.num_candidates, h_pad), dtype=bool)
            for c, mask in enumerate(cset.masks):
                masks[c, : len(mask)] = mask
            out = (masks, np.asarray(cset.origin_rank, dtype=np.int32))
        self._arrays[key] = out
        return out
