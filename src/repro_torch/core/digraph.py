"""Compact directed-graph structure (paper Fig 7).

Compressed sparse row over the *symmetrized* adjacency: each unordered
adjacent pair {u, w} contributes one entry to u's row and one to w's row.
An entry packs ``(neighbor_id << 2) | dir_code`` where the 2-bit dir code is
relative to the row owner ``u``::

    bit 0: u -> w  ("01" unidirectional current -> neighbor)
    bit 1: w -> u  ("10" unidirectional neighbor -> current)
    "11": bidirectional

Rows are sorted by neighbor id (packing preserves order: id occupies the
high bits), enabling binary search — exactly the paper's layout.

Host-side numpy, framework-free; the device copies of these arrays are
made by :class:`repro_torch.core.engine.CensusEngine`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.tricode import swap_code


@dataclass(frozen=True)
class CompactDigraph:
    """CSR-with-direction-bits graph container (host-side, numpy)."""

    n: int                     #: number of vertices
    indptr: np.ndarray         #: (n+1,) int64 row offsets
    packed: np.ndarray         #: (2*pairs,) int32 ``(nbr << 2) | code``
    num_arcs: int              #: directed edge count (after dedup)
    #: lazily built sorted ``row * n + nbr`` entry keys
    #: (:func:`entry_keys`); :func:`apply_delta` splices the cache
    #: forward so warm updates skip the O(m) rebuild
    ekey_cache: np.ndarray | None = field(
        default=None, repr=False, compare=False)

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def num_pairs(self) -> int:
        """Number of unordered adjacent pairs (undirected edges)."""
        return self.packed.shape[0] // 2

    def neighbors(self, u: int) -> np.ndarray:
        return self.packed[self.indptr[u]:self.indptr[u + 1]] >> 2

    def codes(self, u: int) -> np.ndarray:
        return self.packed[self.indptr[u]:self.indptr[u + 1]] & 3

    def validate(self) -> None:
        deg = self.degrees
        if not ((deg >= 0).all()
                and self.indptr[-1] == self.packed.shape[0]):
            raise ValueError("indptr does not describe the packed rows")
        nbr = self.packed >> 2
        # rows sorted strictly (no duplicate neighbors within a row):
        # every adjacent CSR entry must increase unless a row boundary
        # falls there
        if nbr.shape[0] > 1:
            rising = np.diff(nbr) > 0
            crossing = np.zeros(nbr.shape[0] - 1, dtype=bool)
            bounds = np.asarray(self.indptr[1:-1], dtype=np.int64)
            bounds = bounds[(bounds > 0) & (bounds < nbr.shape[0])]
            crossing[bounds - 1] = True
            bad = ~(rising | crossing)
            if bad.any():
                at = np.nonzero(bad)[0][0]
                u = int(np.searchsorted(self.indptr, at, side="right") - 1)
                raise ValueError(f"row {u} not strictly sorted")
        if ((self.packed & 3) == 0).any():
            raise ValueError("zero dir code")


def clean_arcs(src, dst, n: int | None = None
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Validate, ravel and dedupe a directed edge list.

    Self-loops are dropped and duplicate directed edges deduplicated,
    matching the paper's preprocessing of the raw edge lists.  Returns
    ``(src, dst, n)`` with arcs sorted by ``src * n + dst``.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.dtype == object or dst.dtype == object:
        raise ValueError(
            "ragged edge arrays: src/dst must be rectangular numeric "
            "arrays (got object dtype — rows of unequal length?)")
    for name, a in (("src", src), ("dst", dst)):
        if np.issubdtype(a.dtype, np.floating) \
                and not np.isfinite(a).all():
            raise ValueError(f"non-finite vertex id (NaN/inf) in {name}")
    src = src.astype(np.int64).ravel()
    dst = dst.astype(np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError(
            f"src/dst length mismatch: {src.shape[0]} != {dst.shape[0]}")
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if src.size and (src.min() < 0 or dst.min() < 0
                     or max(src.max(), dst.max()) >= n):
        bad = int(min(src.min(), dst.min()))
        if bad >= 0:
            bad = int(max(src.max(), dst.max()))
        raise ValueError(
            f"vertex id {bad} out of range [0, {n}) — ids must index "
            f"the fixed n={n} vertex space")
    keep = src != dst
    src, dst = src[keep], dst[keep]
    eid = np.unique(src * n + dst)
    return eid // n, eid % n, int(n)


def arcs_to_pairs(src, dst, n: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate clean arcs into canonical unordered pairs.

    Returns ``(plo, phi, code)`` with ``plo < phi`` ascending by pair key
    and 2-bit codes (1: lo->hi, 2: hi->lo, 3: mutual) — the pair
    decomposition shared by :func:`from_edges` and :func:`apply_delta`.
    """
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    pkey = lo * n + hi
    bit = np.where(src < dst, 1, 2).astype(np.int64)   # 1: lo->hi, 2: hi->lo
    order = np.argsort(pkey, kind="stable")
    pkey, bit = pkey[order], bit[order]
    uniq, start = np.unique(pkey, return_index=True)
    # OR the bits per pair (bits are distinct per directed edge after dedup)
    code = np.bitwise_or.reduceat(bit, start) if uniq.size else bit[:0]
    return uniq // n, uniq % n, code


def from_pairs(n: int, plo: np.ndarray, phi: np.ndarray, code: np.ndarray,
               num_arcs: int | None = None) -> CompactDigraph:
    """Build the CSR structure from canonical pairs (``plo < phi``, codes
    in {1, 2, 3}) — the second half of :func:`from_edges`, reusable by the
    incremental :func:`apply_delta` edit path."""
    plo = np.asarray(plo, dtype=np.int64)
    phi = np.asarray(phi, dtype=np.int64)
    code = np.asarray(code, dtype=np.int64)
    if num_arcs is None:
        num_arcs = int(((code & 1) != 0).sum() + ((code & 2) != 0).sum())

    # each pair emits two CSR entries: (plo: phi, code) and (phi: plo, swap)
    rows = np.concatenate([plo, phi])
    nbrs = np.concatenate([phi, plo])
    codes = np.concatenate([code, swap_code(code)])

    deg = np.bincount(rows, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    if nbrs.size and nbrs.max() >= 2**29:
        raise ValueError("graph too large for int32 packing; need n < 2^29")
    # entries in (row, neighbour) order: one sort of distinct int64 keys
    # row << 31 | packed entry (a lexsort over the two columns costs ~5x)
    key = np.sort((rows << 31) | (nbrs << 2) | codes)
    packed = key & (2**31 - 1)
    return CompactDigraph(n=int(n), indptr=indptr,
                          packed=packed.astype(np.int32),
                          num_arcs=int(num_arcs))


def from_edges(src, dst, n: int | None = None) -> CompactDigraph:
    """Build the compact structure from directed edge arrays.

    Self-loops are dropped and duplicate directed edges deduplicated,
    matching the paper's preprocessing of the raw edge lists.  Composed
    from the exposed stages :func:`clean_arcs` → :func:`arcs_to_pairs` →
    :func:`from_pairs`.
    """
    src, dst, n = clean_arcs(src, dst, n)
    plo, phi, code = arcs_to_pairs(src, dst, n)
    return from_pairs(n, plo, phi, code, num_arcs=src.shape[0])


def canonical_pairs(g: CompactDigraph
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract the canonical pair decomposition ``(pu, pv, code)`` from a
    CSR graph: one entry per unordered adjacent pair with ``pu < pv``,
    ascending by pair key, code relative to (pu, pv)."""
    rows = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
    nbr = (g.packed >> 2).astype(np.int64)
    canon = nbr > rows
    return rows[canon], nbr[canon], (g.packed[canon] & 3).astype(np.int64)


@dataclass(frozen=True)
class GraphDelta:
    """Record of the pairs perturbed by one :func:`apply_delta` edit.

    ``old_code == 0`` marks a pair that appeared, ``new_code == 0`` one
    that disappeared; every listed pair satisfies ``old != new``.
    ``touched`` is the set of vertices whose CSR row changed — exactly the
    endpoints of the changed pairs — which is what the incremental census
    (:mod:`repro_torch.core.incremental`) keys its affected-pair discovery on.
    """

    n: int
    pair_lo: np.ndarray        #: (C,) int64, lo < hi
    pair_hi: np.ndarray        #: (C,) int64
    old_code: np.ndarray       #: (C,) int64 dyad code in g_old (0 absent)
    new_code: np.ndarray       #: (C,) int64 dyad code in g_new (0 absent)
    touched: np.ndarray = field(default=None)  #: vertices with changed rows

    def __post_init__(self):
        if self.touched is None:
            object.__setattr__(self, "touched", np.unique(
                np.concatenate([self.pair_lo, self.pair_hi])))

    @property
    def num_changed(self) -> int:
        return self.pair_lo.shape[0]


def _lookup_pair_codes(g: CompactDigraph, keys: np.ndarray,
                       entry_key: np.ndarray | None = None) -> np.ndarray:
    """Dyad code of each canonical pair key ``lo * n + hi`` in ``g``
    (0 where the pair is not adjacent).  O(|keys| log m) via the globally
    sorted CSR entry keys (pass a precomputed ``entry_key`` to skip the
    O(m) key materialization)."""
    if g.packed.size == 0 or keys.size == 0:
        return np.zeros(keys.shape[0], dtype=np.int64)
    if entry_key is None:
        entry_key = entry_keys(g)
    pos = np.searchsorted(entry_key, keys)
    safe = np.minimum(pos, entry_key.shape[0] - 1)
    hit = (pos < entry_key.shape[0]) & (entry_key[safe] == keys)
    return np.where(hit, (g.packed[safe] & 3).astype(np.int64), 0)


def entry_keys(g: CompactDigraph) -> np.ndarray:
    """Strictly ascending ``row * n + nbr`` key of every CSR entry — the
    binary-searchable global address space of the adjacency structure.
    Cached on the graph; :func:`apply_delta` keeps the cache alive by
    splicing it into the edited graph's."""
    if g.ekey_cache is not None:
        return g.ekey_cache
    rows = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
    ek = rows * g.n + (g.packed >> 2)
    object.__setattr__(g, "ekey_cache", ek)
    return ek


class SplicePlan:
    """Vectorized delete-and-insert plan over a length-``num`` sorted
    array family (``np.delete`` + ``np.insert`` semantics in one pass).

    ``del_pos`` (sorted, distinct) are positions to drop; ``ins_pos``
    (sorted, possibly duplicated) are *pre-deletion* insertion points.
    The plan precomputes one shared source permutation: survivor slots
    shift right by the insertions at or before them, insertion points
    shift left by the deletions preceding them — both monotone step
    functions materialized with O(num) repeats, no per-array masking
    and no O(num log delta) searches.  :meth:`splice` then edits any
    number of parallel arrays with a single fancy gather plus a
    delta-sized store each; :meth:`readdress` maps a surviving
    position to its post-splice slot.
    """

    __slots__ = ("del_pos", "ipos", "src", "dest_ins", "n_surv", "n_new")

    def __init__(self, num: int, del_pos: np.ndarray,
                 ins_pos: np.ndarray):
        self.del_pos = del_pos
        ipos = ins_pos - np.searchsorted(del_pos, ins_pos)
        self.ipos = ipos
        n_ins = ipos.shape[0]
        self.n_surv = num - del_pos.shape[0]
        self.n_new = self.n_surv + n_ins
        seg = np.diff(np.concatenate((
            np.zeros(1, dtype=np.int64), ipos,
            np.full(1, self.n_surv, dtype=np.int64))))
        shift = np.repeat(np.arange(n_ins + 1, dtype=np.int64), seg)
        keep = np.ones(num, dtype=bool)
        keep[del_pos] = False
        src = np.zeros(self.n_new, dtype=np.int64)
        src[np.arange(self.n_surv, dtype=np.int64) + shift] = \
            np.flatnonzero(keep)
        self.src = src
        self.dest_ins = ipos + np.arange(n_ins, dtype=np.int64)

    def splice(self, arr: np.ndarray, vals) -> np.ndarray:
        out = (arr[self.src] if self.n_surv
               else np.empty(self.n_new, dtype=arr.dtype))
        out[self.dest_ins] = vals
        return out

    def readdress(self, p: np.ndarray) -> np.ndarray:
        """Post-splice position of the surviving pre-splice position
        ``p`` (must not be in ``del_pos``)."""
        p = p - np.searchsorted(self.del_pos, p)
        return p + np.searchsorted(self.ipos, p, side="right")


def apply_delta(g: CompactDigraph, add_src=None, add_dst=None,
                del_src=None, del_dst=None
                ) -> tuple[CompactDigraph, GraphDelta]:
    """Insert and expire arcs without a full :func:`from_edges` rebuild.

    Set semantics on directed arcs: removals apply first, then insertions
    (an arc both deleted and added ends up present); inserting an existing
    arc and deleting an absent one are no-ops; self-loops are dropped.
    Works at pair granularity — only the pairs containing a delta arc are
    re-coded, and the CSR is edited by splicing exactly the touched rows
    (rewrite / delete / insert at binary-searched positions in the
    globally sorted entry keys) — no re-sort, no re-deduplication, no
    O(P) pair-decomposition merge.  Host cost is O(delta log m) searches
    plus the O(m) memmoves of the splice itself.

    Returns the edited graph and the :class:`GraphDelta` describing every
    pair whose dyad code changed (the input to incremental censuses).
    """
    empty = np.zeros(0, dtype=np.int64)

    def pair_bits(src, dst):
        if src is None:
            return empty, empty
        src, dst, _ = clean_arcs(src, dst, g.n)
        plo, phi, code = arcs_to_pairs(src, dst, g.n)
        return plo * g.n + phi, code

    dkey, dbits = pair_bits(del_src, del_dst)
    akey, abits = pair_bits(add_src, add_dst)

    keys = np.union1d(dkey, akey)
    if keys.size == 0:
        return g, GraphDelta(n=g.n, pair_lo=empty, pair_hi=empty,
                             old_code=empty, new_code=empty)
    dfull = np.zeros(keys.shape[0], dtype=np.int64)
    afull = np.zeros(keys.shape[0], dtype=np.int64)
    dfull[np.searchsorted(keys, dkey)] = dbits
    afull[np.searchsorted(keys, akey)] = abits

    entry_key = entry_keys(g) if g.packed.size else None
    old = _lookup_pair_codes(g, keys, entry_key)
    new = (old & ~dfull) | afull
    changed = new != old
    keys, old, new = keys[changed], old[changed], new[changed]
    delta = GraphDelta(n=g.n, pair_lo=keys // g.n, pair_hi=keys % g.n,
                       old_code=old, new_code=new)
    if keys.size == 0:
        return g, delta

    # CSR splice: each changed pair perturbs exactly two rows (lo's entry
    # for hi and hi's entry for lo).  Rows stay neighbor-sorted, so every
    # edit is a rewrite / delete / insert at a binary-searched position in
    # the globally sorted entry keys ``row * n + nbr``.
    lo, hi = keys // g.n, keys % g.n
    erow = np.concatenate([lo, hi])
    enbr = np.concatenate([hi, lo])
    eold = np.concatenate([old, swap_code(old)])
    enew = np.concatenate([new, swap_code(new)])
    ekey = erow * g.n + enbr
    order = np.argsort(ekey)               # 2C entries, C = changed pairs
    erow, enbr = erow[order], enbr[order]
    eold, enew, ekey = eold[order], enew[order], ekey[order]

    pos = (np.searchsorted(entry_key, ekey) if entry_key is not None
           else np.zeros(ekey.shape[0], dtype=np.int64))

    rew = (eold > 0) & (enew > 0)              # recoded in place
    rvals = ((enbr[rew] << 2) | enew[rew]).astype(np.int32)
    dele = enew == 0                           # entry vanishes
    insm = eold == 0                           # entry appears
    if dele.any() or insm.any():
        vals = (enbr[insm] << 2) | enew[insm]
        if vals.size and vals.max() >= 2**31:
            raise ValueError(
                "graph too large for int32 packing; need n < 2^29")
        plan = SplicePlan(g.packed.shape[0], pos[dele], pos[insm])
        packed = plan.splice(g.packed, vals.astype(np.int32))
        # rewrites keep their key (same row, same neighbor), so the
        # edited entry-key cache is one more splice of the same plan —
        # the next delta never rebuilds it
        ekey_new = (plan.splice(entry_key, ekey[insm])
                    if entry_key is not None else None)
        if rew.any():
            packed[plan.readdress(pos[rew])] = rvals
    else:
        packed = g.packed.copy()
        packed[pos[rew]] = rvals
        ekey_new = entry_key

    ddeg = np.zeros(g.n, dtype=np.int64)
    np.add.at(ddeg, erow[dele], -1)
    np.add.at(ddeg, erow[insm], 1)
    indptr = g.indptr.copy()
    indptr[1:] += np.cumsum(ddeg)

    def _narcs(c):
        return int(((c & 1) != 0).sum() + ((c & 2) != 0).sum())

    g_new = CompactDigraph(
        n=g.n, indptr=indptr, packed=packed,
        num_arcs=g.num_arcs + _narcs(new) - _narcs(old),
        ekey_cache=ekey_new)
    return g_new, delta



def from_dense(a: np.ndarray) -> CompactDigraph:
    """Build from a dense boolean adjacency matrix (tests / tiny graphs)."""
    a = np.asarray(a, dtype=bool).copy()
    np.fill_diagonal(a, False)
    src, dst = np.nonzero(a)
    return from_edges(src, dst, n=a.shape[0])


def to_dense(g: CompactDigraph) -> np.ndarray:
    a = np.zeros((g.n, g.n), dtype=bool)
    if g.packed.size:
        rows = np.repeat(np.arange(g.n, dtype=np.int64), g.degrees)
        nbr = g.packed >> 2
        code = g.packed & 3
        out = (code & 1) != 0
        a[rows[out], nbr[out]] = True
        inc = (code & 2) != 0
        a[nbr[inc], rows[inc]] = True
    return a
