"""Degree-aware static graph partitioning — shard the graph, not the items.

The port's copy of the JAX package's ``core/partition.py`` (numpy, no
framework), following the per-processor subgraph approach of Arifuzzaman
et al. and the 2D work decomposition of Tom & Karypis:

* :func:`lpt_assign` splits the canonical pair space into per-device
  shards by greedy LPT (longest-processing-time) over the exact per-pair
  post-prune item counts (:func:`repro_torch.core.planner
  .postprune_pair_counts`).
* :func:`extract_shard` cuts the minimal local subgraph a shard's pairs
  can touch: the CSR rows of the shard's pair *endpoints* plus an
  **order-preserving vertex relabeling** over endpoints ∪ their
  neighbors (the halo).  The relabeling is monotone, so every id
  comparison the census makes is preserved and the merged census is
  **bit-identical** to the single-device path.
* :func:`partition_graph` composes the two into a :class:`GraphPartition`
  whose :class:`PartitionStats` report per-shard items, balance and
  resident graph bytes vs the replicated baseline;
  :func:`partition_graph_2d` splits each pair shard's witness range over
  vertex slices (:class:`GraphPartition2D`), with the range-restricted
  pair counts (:func:`range_preprune_pair_counts`,
  :func:`range_postprune_pair_counts`) that make the tiles additive.

Device dispatch of the shards lives in
:class:`repro_torch.core.engine.CensusEngine` (``partition=True``); the
public API is re-exported by :mod:`repro_torch.core.distributed`.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.planner import (
    INTER_SIDE_BIT, PairSpace, make_pair_space, pair_space,
    postprune_pair_counts, searchsorted_many)


def graph_bytes(indptr_len: int, entries: int, pairs: int) -> int:
    """Device bytes of the 5 int32 resident graph + pair arrays
    (indptr, packed, pair_u, pair_v, pair_code)."""
    return 4 * (int(indptr_len) + int(entries) + 3 * int(pairs))


def replicated_graph_bytes(space: PairSpace) -> int:
    """Per-device resident graph bytes of the replicated (un-partitioned)
    mesh path — the baseline the partitioner's byte reduction is measured
    against."""
    return graph_bytes(space.indptr.shape[0], space.packed.shape[0],
                      space.num_pairs)


def _entry_keys(space: PairSpace) -> np.ndarray:
    """Globally sorted ``row * n + nbr`` keys of every CSR entry — the
    index behind the range-restricted pair counts whose bound varies per
    pair."""
    rows = np.repeat(np.arange(space.n, dtype=np.int64),
                     space.deg.astype(np.int64))
    return rows * space.n + space.nbr.astype(np.int64)


def _rows_below(space: PairSpace, bound: int) -> np.ndarray:
    """(n,) entries of each CSR row whose neighbor id is below ``bound``
    — ``searchsorted(entry_keys, row * n + bound) - indptr[row]`` for
    every row at once, in one O(m) pass (rows are sorted)."""
    below = np.zeros(space.packed.shape[0] + 1, dtype=np.int64)
    np.cumsum(space.nbr < bound, out=below[1:])
    return below[space.indptr[1:]] - below[space.indptr[:-1]]


def _row_range_counts(space: PairSpace, lo: int, hi: int) -> np.ndarray:
    """(n,) entries of each CSR row whose neighbor id lies in
    ``[lo, hi)``."""
    return _rows_below(space, hi) - _rows_below(space, lo)


def range_preprune_pair_counts(space: PairSpace, lo: int, hi: int
                               ) -> np.ndarray:
    """Pre-prune items per pair whose witness id lies in ``[lo, hi)``.

    The per-slice analogue of ``space.counts``: for each pair (u, v) it
    counts the entries of N(u) and N(v) inside the vertex range — the
    item population a 2D vertex slice owns *before* pruning.  Over a
    partition of ``[0, n)`` into slices these sum to ``space.counts``
    exactly, which is what makes the 2D tile item spaces a partition of
    each pair's global item space.
    """
    if not 0 <= lo <= hi <= space.n:
        raise ValueError(f"vertex range [{lo}, {hi}) outside [0, {space.n}]")
    if space.num_pairs == 0:
        return np.zeros(0, dtype=np.int64)
    rows = _row_range_counts(space, lo, hi)
    return rows[space.pair_u] + rows[space.pair_v]


def range_postprune_pair_counts(space: PairSpace, lo: int, hi: int
                                ) -> np.ndarray:
    """Exact post-prune items per pair restricted to witnesses in
    ``[lo, hi)`` — the per-slice cost closed form of the 2D decomposition.

    Mirrors :func:`postprune_pair_counts` with every row count replaced
    by its range restriction and every co-endpoint ``- 1`` replaced by a
    membership test (in a sliced row the co-endpoint may fall *outside*
    the range, so the unconditional subtraction of the global closed form
    would undercount).  Over a partition of ``[0, n)`` into slices these
    sum to :func:`postprune_pair_counts` exactly — the additivity the 2D
    engine's per-tile partials rely on.
    """
    if not 0 <= lo <= hi <= space.n:
        raise ValueError(f"vertex range [{lo}, {hi}) outside [0, {space.n}]")
    if space.num_pairs == 0:
        return np.zeros(0, dtype=np.int64)
    n = space.n
    pu = space.pair_u
    pv = space.pair_v
    below_hi = _rows_below(space, hi)
    rows = below_hi - _rows_below(space, lo)
    c_u = rows[pu]
    c_v = rows[pv]

    def in_range(x):
        return ((x >= lo) & (x < hi)).astype(np.int64)

    if space.orient != "degree":
        if not space.prune_self:
            return c_u + c_v
        return c_u + c_v - in_range(pv) - in_range(pu)
    key = _entry_keys(space)

    def past(rows_of, other):
        # in-range entries of row ``rows_of`` past the co-endpoint
        # ``other``: those below hi less those below clip(other + 1)
        bound = rows_of * n + np.clip(other + 1, lo, hi)
        return (below_hi[rows_of] + space.indptr[rows_of]
                - searchsorted_many(key, bound))

    inter = (space.pair_code >> INTER_SIDE_BIT) & 1
    # witness side keeps its in-range non-self entries; the other side
    # keeps only in-range entries past the co-endpoint (prune_items'
    # ``can_count`` predicate, range-restricted)
    side0 = np.where(inter == 0, c_u - in_range(pv), past(pu, pv))
    side1 = np.where(inter == 1, c_v - in_range(pu), past(pv, pu))
    return side0 + side1


def lpt_assign_heap(costs, num_shards: int) -> np.ndarray:
    """Exact greedy LPT over per-pair costs: (P,) shard owner per pair.

    Pairs are visited in descending cost (ties by pair id, so the
    assignment is deterministic) and each lands on the currently lightest
    shard — the longest-processing-time heuristic, whose makespan is
    within 4/3 − 1/(3m) of optimal.  One heap operation per pair makes
    this O(P log P) *Python-loop* work — fine up to ~10^5 pairs, far too
    slow for the 10M-pair spaces the streaming engine handles, which is
    why :func:`lpt_assign` (the production entry point) only delegates
    here for small inputs and the tests keep this as the oracle.
    """
    costs = np.asarray(costs, dtype=np.int64).ravel()
    owner = np.zeros(costs.shape[0], dtype=np.int64)
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_shards == 1 or costs.size == 0:
        return owner
    order = np.argsort(-costs, kind="stable")
    loads = np.zeros(num_shards, dtype=np.int64)
    _greedy_assign(costs[order], order, owner, loads)
    return owner


def _greedy_assign(costs_desc: np.ndarray, ids: np.ndarray,
                   owner: np.ndarray, loads: np.ndarray) -> None:
    """Exact greedy LPT of ``ids`` (costs already descending) onto the
    running ``loads``, writing ``owner`` and ``loads`` in place."""
    heap = [(int(l), s) for s, l in enumerate(loads)]
    heapq.heapify(heap)
    for i, c in zip(ids.tolist(), costs_desc.tolist()):
        load, s = heapq.heappop(heap)
        owner[i] = s
        heapq.heappush(heap, (load + c, s))
    for load, s in heap:
        loads[s] = load


def _waterfill(levels: np.ndarray, total: int) -> np.ndarray:
    """Distribute ``total`` units over shards with ascending load
    ``levels`` so the lightest rise toward one common level (the exact
    continuous-LPT fill): returns the per-shard amounts, summing to
    ``total``, zero for shards already above the waterline."""
    ns = int(levels.shape[0])
    want = np.zeros(ns, dtype=np.int64)
    if ns == 1:
        want[0] = total
        return want
    pre = np.cumsum(levels)
    k = np.arange(1, ns, dtype=np.int64)
    # cost of raising the k lightest shards up to level ``levels[k]``
    need = k * levels[1:] - pre[:-1]
    m = int(np.searchsorted(need, total, side="right")) + 1
    q, r = divmod(int(total) + int(pre[m - 1]), m)
    want[:m] = q - levels[:m]
    want[:r] += 1
    return want


#: head size of the bucketed assigner that still runs the exact heap LPT
#: (a constant-bounded Python loop); the heavy hub pairs that dominate
#: makespan are all inside it
_LPT_EXACT_HEAD = 4096


def lpt_assign(costs, num_shards: int) -> np.ndarray:
    """Bucketed numpy LPT over per-pair costs: (P,) shard owner per pair.

    Semantics match :func:`lpt_assign_heap` (descending-cost greedy onto
    the lightest shard; deterministic), but the per-pair Python heap loop
    is replaced by vectorized passes so 10M-pair spaces assign in well
    under a second instead of tens of seconds:

    * pairs are grouped into log2 cost buckets and ordered by an O(P)
      int16 **radix** argsort of the bucket keys (numpy's ``stable`` kind
      radix-sorts small integer dtypes) — descending bucket, ascending
      pair id within a bucket, so the assignment stays deterministic;
    * the top ``_LPT_EXACT_HEAD`` pairs — the hub pairs that actually
      decide the makespan — still run the exact heap LPT (a bounded
      loop);
    * each remaining bucket slab is split by *cumulative cost* into
      contiguous segments sized by an exact waterfill against the
      current shard loads (lightest shards drink first), so the tail
      back-fills the load gaps just like the greedy loop, with per-slab
      boundary error at most one item's cost.

    Inputs small enough for the exact loop (``<= _LPT_EXACT_HEAD``)
    delegate to it outright, so small-graph assignments are *identical*
    to the historical heap results.
    """
    costs = np.asarray(costs, dtype=np.int64).ravel()
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    owner = np.zeros(costs.shape[0], dtype=np.int64)
    if num_shards == 1 or costs.size == 0:
        return owner
    if costs.size and int(costs.max()) == 0:
        # all-zero costs (empty pair space after pruning, fully-pruned
        # shard): every assignment has zero makespan — return the
        # all-zeros owner the heap oracle produces instead of feeding
        # degenerate buckets to the radix path
        return owner
    if costs.shape[0] <= _LPT_EXACT_HEAD:
        return lpt_assign_heap(costs, num_shards)
    ns = int(num_shards)
    # log2 cost buckets via the float32 exponent (exact for bucketing:
    # off-by-one rounding at a power-of-two boundary only moves a pair
    # between adjacent buckets, deterministically)
    expo = np.frexp(costs.astype(np.float32))[1].astype(np.int16)
    order = np.argsort(np.int16(64) - expo, kind="stable")
    loads = np.zeros(ns, dtype=np.int64)
    head = order[:_LPT_EXACT_HEAD]
    _greedy_assign(costs[head], head, owner, loads)
    tail = order[_LPT_EXACT_HEAD:]
    key_tail = expo[tail]
    cut = np.flatnonzero(np.diff(key_tail)) + 1
    bounds = np.concatenate([[0], cut, [tail.shape[0]]])
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        ids = tail[lo:hi]
        c = costs[ids]
        total = int(c.sum())
        if total == 0:
            # zero-cost pairs carry no work — spread them round-robin so
            # no shard concentrates their pair-array bytes
            owner[ids] = np.arange(ids.shape[0], dtype=np.int64) % ns
            continue
        rank = np.argsort(loads, kind="stable")        # light -> heavy
        targets = np.cumsum(_waterfill(loads[rank], total))
        seg = np.minimum(np.searchsorted(targets, np.cumsum(c),
                                         side="left"), ns - 1)
        owner[ids] = rank[seg]
        loads += np.bincount(rank[seg], weights=c,
                             minlength=ns).astype(np.int64)
    return owner


def vertex_slices(space: PairSpace, num_slices: int) -> np.ndarray:
    """Entry-mass-balanced vertex slice bounds, (V+1,) int64.

    Slice ``j`` owns witness ids ``[bounds[j], bounds[j+1])``.  Bounds
    are chosen so each slice receives ~equal CSR *entry mass* (how many
    adjacency entries point into it — exactly the halo bytes the 2D
    decomposition shards), via quantiles of the cumulative in-mass.
    Granularity is one vertex: a single hub id's mass cannot split, so a
    slice holding it may exceed the ideal share by that hub's in-degree.
    """
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    n = space.n
    bounds = np.zeros(num_slices + 1, dtype=np.int64)
    bounds[-1] = n
    if num_slices == 1 or n == 0:
        return bounds
    mass = np.bincount(space.nbr, minlength=n).astype(np.int64)
    cmass = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mass, out=cmass[1:])
    total = int(cmass[-1])
    if total == 0:
        bounds[:] = np.round(
            np.linspace(0, n, num_slices + 1)).astype(np.int64)
        return bounds
    targets = (np.arange(1, num_slices, dtype=np.int64) * total
               ) // num_slices
    cuts = np.searchsorted(cmass, targets, side="left")
    bounds[1:-1] = np.minimum(np.maximum.accumulate(cuts), n)
    return bounds


def slice_pair_terms(space: PairSpace, vertex_bounds: np.ndarray
                     ) -> list[np.ndarray]:
    """Designated-slice split of ``space.pair_term``: V arrays of shape
    (P,) summing elementwise to the global terms.

    Each pair's full closed-form dyadic term is credited to the *first*
    vertex slice holding any of its pre-prune items (every pair has at
    least ``deg_u + deg_v >= 2`` items, so a designated slice always
    exists) and zeroed elsewhere — the tile that keeps the pair in that
    slice carries the term, so :func:`repro_torch.core.planner.base_for_pairs`
    sums exactly across a shard's tiles.
    """
    bounds = np.asarray(vertex_bounds, dtype=np.int64).ravel()
    num_slices = bounds.shape[0] - 1
    if num_slices == 1:
        return [space.pair_term.copy()]
    pre = np.stack([range_preprune_pair_counts(
        space, int(bounds[j]), int(bounds[j + 1])) > 0
        for j in range(num_slices)])
    first = np.argmax(pre, axis=0) if space.num_pairs else np.zeros(
        0, dtype=np.int64)
    return [np.where(first == j, space.pair_term, 0)
            for j in range(num_slices)]


@dataclass(frozen=True)
class LocalShard:
    """One device's private slice of the census: the pairs it owns and the
    minimal relabeled subgraph those pairs can touch.

    ``verts`` is the relabeling table (local id -> global id, sorted
    ascending so the relabeling preserves every id comparison);
    ``graph``'s rows are the *full* global rows of the shard's pair
    endpoints (halo vertices — neighbors that are not endpoints — exist as
    empty rows, present only so ids resolve).  ``space`` is the shard's
    local pair space: the owned pairs in local coordinates, with the
    closed-form ``pair_term`` copied from the global space so per-shard
    bases stay additive to the global ones.
    """

    index: int
    pair_ids: np.ndarray       #: (P_s,) sorted global pair indices
    keys: np.ndarray           #: (P_s,) sorted global pair keys lo*n+hi
    verts: np.ndarray          #: (n_loc,) sorted global vertex ids
    graph: CompactDigraph      #: relabeled local CSR
    space: PairSpace           #: local pair space over ``graph``
    items: int                 #: post-prune work items owned
    vertex_range: tuple | None = None  #: (lo, hi) witness slice, 2D only

    @property
    def num_pairs(self) -> int:
        return int(self.pair_ids.shape[0])

    @property
    def resident_bytes(self) -> int:
        """Device bytes of this shard's resident graph + pair arrays."""
        return graph_bytes(self.graph.indptr.shape[0],
                           self.graph.packed.shape[0], self.num_pairs)


def _members(n: int, *arrays) -> np.ndarray:
    """The sorted unique int64 ids in ``arrays`` (all in ``[0, n)``), by
    marking: ``np.unique`` of their concatenation without the sort."""
    mark = np.zeros(n, dtype=bool)
    for a in arrays:
        mark[a] = True
    return np.flatnonzero(mark).astype(np.int64)


def extract_shard(space: PairSpace, pair_ids, index: int = 0,
                  costs: np.ndarray | None = None, *,
                  vertex_range: tuple | None = None,
                  pair_term: np.ndarray | None = None) -> LocalShard:
    """Extract the minimal local subgraph of a pair subset of ``space``.

    ``pair_ids`` (any order; sorted internally) index the global space's
    canonical pairs.  The local vertex id space is ``endpoints ∪ their
    neighbors`` sorted ascending — an order-preserving relabeling, which
    is the whole correctness argument: the census only ever *compares*
    vertex ids, so a monotone injection changes no per-item decision.
    ``costs`` (the global :func:`postprune_pair_counts`) avoids an
    O(P log m) recount per shard when the caller already has it.

    ``vertex_range=(lo, hi)`` is the **slice-aware variant** behind the
    2D decomposition: endpoint rows are restricted to their neighbor
    entries with ids in ``[lo, hi)`` (rows are sorted, so each restriction
    is one contiguous run), and pairs with *no* pre-prune item in the
    range are dropped, so pair-array bytes shard with the vertex axis
    too.  Restricting a sorted row to an id range keeps it sorted and —
    because every item's witness lies in the range — keeps the kernel's
    binary search of the co-endpoint row exact (``w ∈ sliced row ⟺
    w ∈ global row`` for in-range ``w``), so per-item decisions, and the
    union of the tiles' item spaces over a slicing of ``[0, n)``, are
    bit-identical to the unsliced shard.  When slicing, ``costs`` must be
    the matching :func:`range_postprune_pair_counts` (computed here when
    omitted), and ``pair_term`` may override the global per-pair base
    terms with a designated-slice split (:func:`slice_pair_terms`) so
    per-tile bases stay additive across the vertex axis.
    """
    ids = np.sort(np.asarray(pair_ids, dtype=np.int64).ravel())
    if ids.size and (ids[0] < 0 or ids[-1] >= space.num_pairs):
        raise ValueError(f"pair id outside [0, {space.num_pairs})")
    deg = space.deg.astype(np.int64)
    if vertex_range is None:
        if costs is None:
            costs = postprune_pair_counts(space)
        pu, pv = space.pair_u[ids], space.pair_v[ids]
        ends = _members(space.n, pu, pv)
        row_start = space.indptr[ends].astype(np.int64)
        row_deg = deg[ends]
    else:
        lo_v, hi_v = int(vertex_range[0]), int(vertex_range[1])
        if not 0 <= lo_v <= hi_v <= space.n:
            raise ValueError(
                f"vertex range [{lo_v}, {hi_v}) outside [0, {space.n}]")
        vertex_range = (lo_v, hi_v)
        if costs is None:
            costs = range_postprune_pair_counts(space, lo_v, hi_v)
        below_lo = _rows_below(space, lo_v)
        in_slice = _rows_below(space, hi_v) - below_lo
        pu = space.pair_u[ids].astype(np.int64)
        pv = space.pair_v[ids].astype(np.int64)
        # a pair with zero pre-prune items in the slice contributes
        # nothing here (its items live in other slices) — drop it so the
        # pair arrays shard along the vertex axis as well
        keep = (in_slice[pu] + in_slice[pv]) > 0
        ids = ids[keep]
        pu, pv = pu[keep], pv[keep]
        ends = _members(space.n, pu, pv)
        row_deg = in_slice[ends]
        row_start = (space.indptr[ends] + below_lo[ends]).astype(np.int64)
    keys = pu * space.n + pv
    items = int(costs[ids].sum()) if ids.size else 0

    total = int(row_deg.sum())
    loc_off = np.zeros(ends.shape[0] + 1, dtype=np.int64)
    np.cumsum(row_deg, out=loc_off[1:])
    # slots of the endpoints' (possibly range-restricted) rows, in
    # (endpoint asc, within-row asc) order — exactly local CSR order
    # after relabeling
    slot = (np.repeat(row_start - loc_off[:-1], row_deg)
            + np.arange(total, dtype=np.int64))
    rows_packed = space.packed[slot].astype(np.int64)
    nbrs = rows_packed >> 2

    verts = _members(space.n, ends, nbrs)
    n_loc = int(verts.shape[0])
    # local id of a global id of verts (sorted, unique): its rank there
    local = np.zeros(space.n, dtype=np.int64)
    local[verts] = np.arange(n_loc, dtype=np.int64)
    ends_loc = local[ends]
    deg_loc = np.zeros(n_loc, dtype=np.int64)
    deg_loc[ends_loc] = row_deg
    indptr_loc = np.zeros(n_loc + 1, dtype=np.int64)
    np.cumsum(deg_loc, out=indptr_loc[1:])
    nbr_loc = local[nbrs]
    packed_loc = ((nbr_loc << 2) | (rows_packed & 3)).astype(np.int32)
    g_loc = CompactDigraph(
        n=n_loc, indptr=indptr_loc, packed=packed_loc,
        # row-side outgoing entries; arcs whose both endpoints are shard
        # endpoints appear from each side (informational only)
        num_arcs=int(((rows_packed & 1) != 0).sum()))

    term_src = (space.pair_term if pair_term is None
                else np.asarray(pair_term, dtype=np.int64).ravel())
    space_loc = make_pair_space(
        g_loc, local[pu], local[pv],
        space.pair_code[ids].copy(), orient=space.orient,
        prune_self=space.prune_self,
        pair_term=term_src[ids].copy())
    return LocalShard(index=index, pair_ids=ids, keys=keys, verts=verts,
                      graph=g_loc, space=space_loc, items=items,
                      vertex_range=vertex_range)


@dataclass(frozen=True)
class PartitionStats:
    """Balance + residency record of one :func:`partition_graph` call."""

    num_shards: int
    total_items: int
    shard_items: tuple         #: per-shard post-prune work items
    shard_pairs: tuple         #: per-shard owned pair counts
    shard_bytes: tuple         #: per-shard resident graph bytes
    replicated_bytes: int      #: per-device bytes of the replicated path
    mesh_shape: tuple | None = None  #: (pair_shards, vertex_slices); 2D only
    shard_entries: tuple = ()  #: per-shard resident packed CSR entries
    total_entries: int = 0     #: global packed CSR entries (halo denom)

    @property
    def entry_replication(self) -> float:
        """Halo blow-up: total resident CSR entry copies across shards /
        global entries (1.0 == no replication; the 2D vertex axis exists
        to pull this down)."""
        if not self.shard_entries or not self.total_entries:
            return 1.0
        return sum(self.shard_entries) / self.total_entries

    @property
    def max_over_mean(self) -> float:
        """Shard item imbalance (1.0 == perfect; target ≤ 1.2)."""
        if not self.shard_items or not self.total_items:
            return 1.0
        mean = self.total_items / self.num_shards
        return max(self.shard_items) / mean

    @property
    def max_shard_bytes(self) -> int:
        return max(self.shard_bytes) if self.shard_bytes else 0

    @property
    def byte_reduction(self) -> float:
        """Replicated / max-per-shard resident graph bytes (the ≥ 2x
        acceptance metric)."""
        return self.replicated_bytes / max(self.max_shard_bytes, 1)

    def report(self) -> str:
        """Human-readable shard table + balance/residency summary; tiles
        of a 2D partition are labeled by their (pair shard, vertex slice)
        mesh coordinates."""
        two_d = self.mesh_shape is not None
        head = f"{'tile':>7}" if two_d else f"{'shard':>5}"
        lines = [f"{head} {'pairs':>9} {'items':>11} {'graph_bytes':>12}"]
        for s in range(self.num_shards):
            label = (f"{s // self.mesh_shape[1]:>3},{s % self.mesh_shape[1]}"
                     if two_d else f"{s:>5}")
            lines.append(f"{label:>7} {self.shard_pairs[s]:>9} "
                         f"{self.shard_items[s]:>11} "
                         f"{self.shard_bytes[s]:>12}"
                         if two_d else
                         f"{label} {self.shard_pairs[s]:>9} "
                         f"{self.shard_items[s]:>11} "
                         f"{self.shard_bytes[s]:>12}")
        if two_d:
            lines.append(f"mesh={self.mesh_shape[0]}x{self.mesh_shape[1]} "
                         f"(pair shards x vertex slices)")
        if self.shard_entries and self.total_entries:
            lines.append(
                f"halo: resident entries={sum(self.shard_entries)} "
                f"global={self.total_entries} "
                f"(replication {self.entry_replication:.2f}x)")
        lines.append(
            f"items max/mean={self.max_over_mean:.3f} "
            f"resident_bytes max={self.max_shard_bytes} "
            f"replicated={self.replicated_bytes} "
            f"({self.byte_reduction:.2f}x reduction)")
        return "\n".join(lines)


@dataclass(frozen=True)
class GraphPartition:
    """A graph statically partitioned into per-device local shards."""

    space: PairSpace           #: the global pair space
    shards: list               #: list[LocalShard], one per device
    owner: np.ndarray          #: (P,) shard owning each global pair
    stats: PartitionStats

    @property
    def num_shards(self) -> int:
        return len(self.shards)


def partition_graph(g: CompactDigraph | None = None, num_shards: int = 1,
                    orient: str = "none", prune_self: bool = True, *,
                    space: PairSpace | None = None,
                    owner: np.ndarray | None = None,
                    costs: np.ndarray | None = None) -> GraphPartition:
    """Partition a graph's census work into ``num_shards`` private slices.

    Greedy LPT over the exact per-pair post-prune item counts, then
    per-shard minimal-subgraph extraction (:func:`extract_shard`).  Pass
    ``space`` to reuse an existing pair decomposition (``g`` is then
    ignored); ``orient``/``prune_self`` match
    :func:`repro_torch.core.planner.build_plan`.  ``owner`` overrides the LPT
    with an explicit (P,) pair→shard assignment — the hook the skewed
    -schedule tests and benchmarks use to build deliberately imbalanced
    partitions (the census is exact for ANY assignment; only balance
    changes).  ``costs`` supplies a precomputed (P,)
    :func:`postprune_pair_counts` of ``space`` — the hook a maintained
    :class:`~repro_torch.core.pair_index.PairSpaceIndex` uses to skip the
    O(P log m) recount on warm repartitions.
    """
    if space is None:
        if g is None:
            raise ValueError("need a graph or a prebuilt pair space")
        space = pair_space(g, orient=orient, prune_self=prune_self)
    if costs is None:
        costs = postprune_pair_counts(space)
    else:
        costs = np.asarray(costs, dtype=np.int64).ravel()
        if costs.shape[0] != space.num_pairs:
            raise ValueError(
                f"costs has {costs.shape[0]} entries for "
                f"{space.num_pairs} pairs")
    if owner is None:
        owner = lpt_assign(costs, num_shards)
    else:
        owner = np.asarray(owner, dtype=np.int64).ravel()
        if owner.shape[0] != space.num_pairs:
            raise ValueError(
                f"owner has {owner.shape[0]} entries for "
                f"{space.num_pairs} pairs")
        if owner.size and (owner.min() < 0 or owner.max() >= num_shards):
            raise ValueError(f"owner shard outside [0, {num_shards})")
    shards = [extract_shard(space, np.nonzero(owner == s)[0], index=s,
                            costs=costs)
              for s in range(num_shards)]
    stats = PartitionStats(
        num_shards=num_shards, total_items=int(costs.sum()),
        shard_items=tuple(sh.items for sh in shards),
        shard_pairs=tuple(sh.num_pairs for sh in shards),
        shard_bytes=tuple(sh.resident_bytes for sh in shards),
        replicated_bytes=replicated_graph_bytes(space),
        shard_entries=tuple(sh.graph.packed.shape[0] for sh in shards),
        total_entries=int(space.packed.shape[0]))
    return GraphPartition(space=space, shards=shards, owner=owner,
                          stats=stats)


@dataclass(frozen=True)
class GraphPartition2D:
    """A graph partitioned over a ``(pair_shards, vertex_slices)`` mesh.

    ``shards`` is the **flat** tile list — tile ``(s, j)`` (pair shard
    ``s``, vertex slice ``j``) sits at index ``s * V + j`` — so every
    consumer of the 1D partition's shard list (``ShardSchedule``,
    ``stacked_device_arrays``, the async/lock-step/megastep dispatch
    paths) runs unmodified over the 2D tile set; only ownership
    bookkeeping (one pair shard owns a pair, its V tiles split the
    pair's witness range) knows about the second axis.
    """

    space: PairSpace           #: the global pair space
    mesh_shape: tuple          #: (P, V) = (pair shards, vertex slices)
    vertex_bounds: np.ndarray  #: (V+1,) slice boundaries over [0, n)
    shards: list               #: list[LocalShard], P*V tiles, flat s*V+j
    owner: np.ndarray          #: (P,) pair shard owning each global pair
    stats: PartitionStats

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def pair_shards(self) -> int:
        return int(self.mesh_shape[0])

    @property
    def num_vertex_slices(self) -> int:
        return int(self.mesh_shape[1])

    def tile(self, shard: int, vslice: int) -> LocalShard:
        """The tile of pair shard ``shard`` × vertex slice ``vslice``."""
        return self.shards[shard * self.num_vertex_slices + vslice]


def partition_graph_2d(g: CompactDigraph | None = None,
                       mesh_shape: tuple = (1, 1),
                       orient: str = "none", prune_self: bool = True, *,
                       space: PairSpace | None = None,
                       owner: np.ndarray | None = None,
                       vertex_bounds: np.ndarray | None = None
                       ) -> GraphPartition2D:
    """Partition census work over a ``(pair_shards, vertex_slices)`` mesh.

    The pair axis reuses the 1D machinery verbatim: greedy LPT over the
    exact global post-prune costs assigns each pair one owner shard.  The
    vertex axis then splits every shard's *item space*: tile ``(s, j)``
    extracts shard ``s``'s pairs restricted to witness ids in slice
    ``j``'s range (:func:`extract_shard` with ``vertex_range``), so hub
    halo rows — which the 1D split replicates into every shard owning one
    of their pairs — are themselves sliced ``V`` ways.  Per-pair dyadic
    base terms are credited to one designated tile per pair
    (:func:`slice_pair_terms`) so per-tile bases stay additive.  ``owner``
    overrides the LPT with an explicit (P,) pair→shard assignment and
    ``vertex_bounds`` overrides the entry-mass-balanced slice boundaries
    (:func:`vertex_slices`); the census is exact for any choice of both —
    only balance and residency change.
    """
    num_pair_shards, num_slices = int(mesh_shape[0]), int(mesh_shape[1])
    if num_pair_shards < 1 or num_slices < 1:
        raise ValueError(f"mesh_shape must be >= (1, 1), got {mesh_shape}")
    if space is None:
        if g is None:
            raise ValueError("need a graph or a prebuilt pair space")
        space = pair_space(g, orient=orient, prune_self=prune_self)
    costs = postprune_pair_counts(space)
    if owner is None:
        owner = lpt_assign(costs, num_pair_shards)
    else:
        owner = np.asarray(owner, dtype=np.int64).ravel()
        if owner.shape[0] != space.num_pairs:
            raise ValueError(
                f"owner has {owner.shape[0]} entries for "
                f"{space.num_pairs} pairs")
        if owner.size and (owner.min() < 0
                           or owner.max() >= num_pair_shards):
            raise ValueError(
                f"owner shard outside [0, {num_pair_shards})")
    if vertex_bounds is None:
        vertex_bounds = vertex_slices(space, num_slices)
    else:
        vertex_bounds = np.asarray(vertex_bounds, dtype=np.int64).ravel()
        if (vertex_bounds.shape[0] != num_slices + 1
                or vertex_bounds[0] != 0 or vertex_bounds[-1] != space.n
                or (np.diff(vertex_bounds) < 0).any()):
            raise ValueError(
                f"vertex_bounds must be a monotone ({num_slices + 1},) "
                f"cover of [0, {space.n}]")
    terms = slice_pair_terms(space, vertex_bounds)
    slice_costs = [range_postprune_pair_counts(
        space, int(vertex_bounds[j]), int(vertex_bounds[j + 1]))
        for j in range(num_slices)]
    tiles = []
    for s in range(num_pair_shards):
        sids = np.nonzero(owner == s)[0]
        for j in range(num_slices):
            tiles.append(extract_shard(
                space, sids, index=s * num_slices + j,
                costs=slice_costs[j],
                vertex_range=(int(vertex_bounds[j]),
                              int(vertex_bounds[j + 1])),
                pair_term=terms[j]))
    stats = PartitionStats(
        num_shards=len(tiles), total_items=int(costs.sum()),
        shard_items=tuple(t.items for t in tiles),
        shard_pairs=tuple(t.num_pairs for t in tiles),
        shard_bytes=tuple(t.resident_bytes for t in tiles),
        replicated_bytes=replicated_graph_bytes(space),
        mesh_shape=(num_pair_shards, num_slices),
        shard_entries=tuple(t.graph.packed.shape[0] for t in tiles),
        total_entries=int(space.packed.shape[0]))
    return GraphPartition2D(
        space=space, mesh_shape=(num_pair_shards, num_slices),
        vertex_bounds=vertex_bounds, shards=tiles, owner=owner,
        stats=stats)


def stacked_device_arrays(shards) -> tuple[np.ndarray, ...]:
    """The per-shard graph + pair arrays stacked to (num_shards, ·) int32
    — the *sharded* inputs of the partitioned collective step (each device
    receives exactly its own row).

    Rows are padded to common lengths so they stack: ``indptr`` with its
    own final value (phantom empty rows past ``n_loc``), ``packed`` and
    the pair arrays with zeros (inert — no live row or descriptor ever
    points at them, and invalid lanes clamp to pair/slot 0, which the
    padding keeps in-bounds).
    """
    li = max(max(sh.graph.indptr.shape[0] for sh in shards), 2)
    le = max(max(sh.graph.packed.shape[0] for sh in shards), 1)
    lp = max(max(sh.num_pairs for sh in shards), 1)
    ns = len(shards)
    indptr = np.zeros((ns, li), dtype=np.int32)
    packed = np.zeros((ns, le), dtype=np.int32)
    pu = np.zeros((ns, lp), dtype=np.int32)
    pv = np.zeros((ns, lp), dtype=np.int32)
    pc = np.zeros((ns, lp), dtype=np.int32)
    for s, sh in enumerate(shards):
        ip = sh.graph.indptr
        indptr[s, :ip.shape[0]] = ip
        indptr[s, ip.shape[0]:] = ip[-1]
        packed[s, :sh.graph.packed.shape[0]] = sh.graph.packed
        sp = sh.space
        pu[s, :sh.num_pairs] = sp.pair_u
        pv[s, :sh.num_pairs] = sp.pair_v
        pc[s, :sh.num_pairs] = sp.pair_code
    return indptr, packed, pu, pv, pc
