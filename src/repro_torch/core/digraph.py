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

from dataclasses import dataclass

import numpy as np

from repro_torch.core.tricode import swap_code


@dataclass(frozen=True)
class CompactDigraph:
    """CSR-with-direction-bits graph container (host-side, numpy)."""

    n: int                     #: number of vertices
    indptr: np.ndarray         #: (n+1,) int64 row offsets
    packed: np.ndarray         #: (2*pairs,) int32 ``(nbr << 2) | code``
    num_arcs: int              #: directed edge count (after dedup)

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
    and 2-bit codes (1: lo->hi, 2: hi->lo, 3: mutual).
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
    in {1, 2, 3}) — the second half of :func:`from_edges`."""
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
    order = np.lexsort((nbrs, rows))
    packed = ((nbrs[order] << 2) | codes[order]).astype(np.int64)
    if packed.size and packed.max() >= 2**31:
        raise ValueError("graph too large for int32 packing; need n < 2^29")
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
