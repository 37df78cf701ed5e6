"""Persistent delta-incremental pair-space index.

:func:`~repro_torch.core.planner.pair_space` rebuilds the full O(P)
canonical pair decomposition from scratch — canonical-pair extraction,
per-pair counts, prefix offsets, closed-form terms — which is fine for a
one-shot census but dominates the host side of a *warm* sliding-window update,
where the delta touches a handful of rows and the device work is already
delta-sized (EXPERIMENTS.md "Incremental monitoring").

:class:`PairSpaceIndex` keeps the decomposition alive between updates and
edits it in place of rebuilding:

* the sorted canonical pair keys ``u * n + v`` are cached, so a
  :class:`~repro_torch.core.digraph.GraphDelta` maps onto the pair
  arrays with O(delta · log P) binary searches;
* structural changes (pairs appearing/vanishing) are array splices at
  those searched positions — vectorized memmoves, no re-sort;
* per-pair counts, closed-form terms, orientation bits and post-prune
  costs are recomputed only for the *affected* pairs (those with a
  touched endpoint), found by walking just the touched CSR rows —
  the CSR itself is the vertex→pair reverse index;
* :meth:`affected_pair_ids` answers the incremental census's discovery
  query from the same touched-row walk instead of the O(P) mask scan of
  :func:`repro_torch.core.incremental.affected_pair_ids`.

The produced :class:`~repro_torch.core.planner.PairSpace` is
**bit-identical** (array for array, dtype for dtype) to
``pair_space(g_new, ...)`` — the full rebuild stays available as the
parity oracle (sessions expose it as ``index=False``) and the test suite
asserts the equivalence under randomized delta streams.

Every ``apply`` cross-checks the delta's ``old_code`` against the codes
the index is tracking; a mismatch means the index has drifted from the
graph it claims to mirror (stale handle, external mutation, bit rot) and
raises :class:`IndexCorruptionError` instead of silently producing a
wrong plan.  :meth:`verify` runs the full fingerprint check on demand.

Host-side numpy, framework-free.
"""

from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.digraph import CompactDigraph, GraphDelta, SplicePlan
from repro_torch.core.planner import (
    INTER_SIDE_BIT, PairSpace, pair_space, postprune_pair_counts)


class IndexCorruptionError(ValueError):
    """The persistent pair-space index no longer matches the graph it
    claims to track (fingerprint / pair-code mismatch)."""


def _touched_pair_keys(indptr: np.ndarray, nbr: np.ndarray, n: int,
                       touched: np.ndarray) -> np.ndarray:
    """Canonical pair keys ``lo * n + hi`` of every pair with an endpoint
    in ``touched``, read off the touched CSR rows (sorted, deduplicated).

    O(Σ deg(touched)) — the CSR is its own vertex→pair reverse index:
    vertex u's adjacent pairs are exactly {canonical(u, w) : w ∈ N(u)}.
    """
    if touched.size == 0 or indptr[-1] == 0:
        return np.zeros(0, dtype=np.int64)
    starts = indptr[touched]
    degs = (indptr[touched + 1] - starts).astype(np.int64)
    total = int(degs.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    off = np.zeros(touched.shape[0], dtype=np.int64)
    np.cumsum(degs[:-1], out=off[1:])
    sel = np.repeat(starts - off, degs) + np.arange(total, dtype=np.int64)
    nb = nbr[sel].astype(np.int64)
    rw = np.repeat(touched.astype(np.int64), degs)
    keys = np.where(nb > rw, rw * n + nb, nb * n + rw)
    return np.unique(keys)


class PairSpaceIndex:
    """Live pair-space over one graph, editable by :class:`GraphDelta`.

    Parameters mirror :func:`~repro_torch.core.planner.pair_space`; the
    initial build IS a full ``pair_space`` call (the open of a session is O(P)
    either way) — the index earns its keep on every update after it.
    """

    def __init__(self, g: CompactDigraph, orient: str = "none",
                 prune_self: bool = True, *,
                 space: PairSpace | None = None,
                 track_costs: bool = True):
        if space is None:
            space = pair_space(g, orient=orient, prune_self=prune_self)
        elif space.orient != orient or space.prune_self != prune_self:
            raise ValueError("prebuilt space disagrees with orient/prune")
        self._space = space
        self._keys = space.pair_u * space.n + space.pair_v
        #: maintained post-prune cost vector; only the partitioned
        #: sessions route on it, so plain sessions opt out
        #: (``track_costs=False``) and skip its splice + subset recount
        self._costs = postprune_pair_counts(space) if track_costs else None
        self._crc: int | None = zlib.crc32(space.packed)
        #: (touched, affected ids) of the last ``apply`` — re-served to
        #: the session's post-apply discovery query without re-walking
        self._aff_cache: tuple | None = None

    def _packed_crc(self) -> int:
        """The tracked CSR's crc, computed lazily after an ``apply``
        (which re-anchors the fingerprint on the new graph instead of
        hashing O(E) bytes on the hot path)."""
        if self._crc is None:
            self._crc = zlib.crc32(self._space.packed)
        return self._crc

    # ------------------------------------------------------------ views
    @property
    def space(self) -> PairSpace:
        """The tracked :class:`PairSpace` (bit-identical to a rebuild)."""
        return self._space

    @property
    def keys(self) -> np.ndarray:
        """(P,) sorted canonical pair keys ``pair_u * n + pair_v``."""
        return self._keys

    @property
    def costs(self) -> np.ndarray:
        """(P,) maintained :func:`postprune_pair_counts` of the space —
        the per-pair cost vector partition owner routing balances on.
        With ``track_costs=False`` this falls back to a full recount."""
        if self._costs is None:
            return postprune_pair_counts(self._space)
        return self._costs

    @property
    def fingerprint(self) -> dict:
        """Identity of the tracked graph + plan policy."""
        return {"n": self._space.n, "orient": self._space.orient,
                "prune_self": self._space.prune_self,
                "pairs": self._space.num_pairs,
                "packed_crc": self._packed_crc()}

    # ------------------------------------------------------- validation
    def verify(self, g: CompactDigraph | None = None) -> None:
        """Full consistency check; raises :class:`IndexCorruptionError`.

        Confirms the cached keys still mirror the pair arrays, the packed
        CSR still hashes to the recorded fingerprint, and (when ``g`` is
        given) that the index is tracking *that* graph.
        """
        sp = self._space
        crc = self._packed_crc()
        if zlib.crc32(sp.packed) != crc:
            raise IndexCorruptionError(
                "pair-space index fingerprint mismatch: tracked CSR no "
                f"longer hashes to {crc} — the graph was mutated "
                "behind the index")
        keys = sp.pair_u * sp.n + sp.pair_v
        if not np.array_equal(keys, self._keys):
            raise IndexCorruptionError(
                "pair-space index key cache disagrees with the pair "
                "arrays — index state is corrupted")
        if keys.size > 1 and not (np.diff(keys) > 0).all():
            raise IndexCorruptionError(
                "pair-space index keys are not strictly ascending")
        if g is not None and zlib.crc32(g.packed) != self._packed_crc():
            raise IndexCorruptionError(
                "pair-space index tracks a different graph than the one "
                "passed (packed CSR fingerprints differ)")

    # --------------------------------------------------------- queries
    def affected_pair_ids(self, touched: np.ndarray) -> np.ndarray:
        """Ids (into the tracked space) of every pair with an endpoint in
        ``touched`` — O(Σ deg(touched) · log P) via the touched-row walk,
        equal to :func:`repro_torch.core.incremental.affected_pair_ids`'s
        O(P) scan of the same space.
        """
        if self._aff_cache is not None and self._aff_cache[0] is touched:
            return self._aff_cache[1]
        sp = self._space
        touched = np.asarray(touched, dtype=np.int64)
        keys = _touched_pair_keys(sp.indptr, sp.nbr, sp.n, touched)
        return np.searchsorted(self._keys, keys)

    # ----------------------------------------------------------- apply
    def apply(self, delta: GraphDelta, g_new: CompactDigraph) -> PairSpace:
        """Edit the tracked space into the pair space of ``g_new``.

        ``(g_new, delta)`` must come from
        :func:`~repro_torch.core.digraph.apply_delta` on the tracked graph.
        Host cost: O(delta · log P) searches + O(affected · log m)
        recounts + the vectorized memmoves of the splice; no sorting, no
        full recount.  Returns the new space (also ``self.space``).
        """
        sp = self._space
        n = sp.n
        if delta.n != n or g_new.n != n:
            raise ValueError(f"delta/graph vertex count != index n={n}")
        if delta.num_changed == 0:
            return sp

        dkeys = delta.pair_lo * n + delta.pair_hi
        old_code, new_code = delta.old_code, delta.new_code
        if dkeys.size > 1 and not (np.diff(dkeys) > 0).all():
            order = np.argsort(dkeys, kind="stable")
            dkeys = dkeys[order]
            old_code, new_code = old_code[order], new_code[order]

        # the delta's old codes must be the codes the index is tracking —
        # anything else means the index drifted from its graph
        num = self._keys.shape[0]
        pos = np.searchsorted(self._keys, dkeys)
        if num:
            safe = np.minimum(pos, num - 1)
            found = (pos < num) & (self._keys[safe] == dkeys)
            here = np.where(found,
                            (sp.pair_code[safe] & 3).astype(np.int64), 0)
        else:
            here = np.zeros(dkeys.shape[0], dtype=np.int64)
        if not np.array_equal(here, old_code):
            raise IndexCorruptionError(
                "delta old codes disagree with the tracked pair codes — "
                "the index is stale or corrupted (expected fingerprint "
                f"{self.fingerprint})")
        if g_new.packed.shape[0] >= 2**30:
            raise ValueError("graph exceeds int32 packed-item indexing "
                             "(need slots < 2**30); shard the graph first")

        vanish = new_code == 0
        appear = old_code == 0
        recode = ~vanish & ~appear
        new32 = new_code.astype(np.int32)

        if vanish.any() or appear.any():
            # one shared :class:`~repro_torch.core.digraph.SplicePlan` edits
            # every pair array with a single fancy gather plus a
            # delta-sized store — np.delete + np.insert semantics
            # without their per-array masking passes
            plan = SplicePlan(num, pos[vanish], pos[appear])
            keys = plan.splice(self._keys, dkeys[appear])
            pair_u = plan.splice(sp.pair_u, dkeys[appear] // n)
            pair_v = plan.splice(sp.pair_v, dkeys[appear] % n)
            pair_code = plan.splice(sp.pair_code, new32[appear])
            if recode.any():
                # recoded pairs survive; re-address them post-splice
                pair_code[plan.readdress(pos[recode])] = new32[recode]
            counts = plan.splice(sp.counts, 0)   # recounted below
            pair_term = plan.splice(sp.pair_term, 0)
            costs = (None if self._costs is None
                     else plan.splice(self._costs, 0))
        else:
            keys = self._keys
            pair_u, pair_v = sp.pair_u, sp.pair_v
            pair_code = sp.pair_code.copy()
            if num:
                pair_code[pos[recode]] = new32[recode]
            counts = sp.counts.copy()
            pair_term = sp.pair_term.copy()
            costs = None if self._costs is None else self._costs.copy()

        # recount exactly the pairs with a touched endpoint — degrees,
        # closed-form terms, orientation side and post-prune costs of
        # every other pair are untouched by construction
        deg = g_new.degrees
        nbr = g_new.packed >> 2
        aff_keys = _touched_pair_keys(g_new.indptr, nbr, n, delta.touched)
        aff = np.searchsorted(keys, aff_keys)
        deg_u = deg[pair_u[aff]]
        deg_v = deg[pair_v[aff]]
        counts[aff] = deg_u + deg_v
        pair_term[aff] = n - deg_u - deg_v
        if sp.orient == "degree" and aff.size:
            inter = (deg_v < deg_u).astype(np.int32)
            pair_code[aff] = ((pair_code[aff] & 3)
                              | (inter << INTER_SIDE_BIT))

        offsets = np.zeros(keys.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        max_deg = int(deg.max()) if n else 0
        space_new = PairSpace(
            n=n, orient=sp.orient, prune_self=sp.prune_self,
            max_degree=max_deg,
            search_iters=max(1, int(np.ceil(np.log2(max_deg + 1)))),
            indptr=g_new.indptr, packed=g_new.packed, nbr=nbr, deg=deg,
            pair_u=pair_u, pair_v=pair_v, pair_code=pair_code,
            counts=counts, offsets=offsets, pair_term=pair_term,
            pair_mut=(pair_code & 3) == 3)
        if costs is not None:
            costs[aff] = postprune_pair_counts(
                space_new, aff, entry_key=g_new.ekey_cache)

        self._space = space_new
        self._keys = keys
        self._costs = costs
        self._crc = None                 # re-anchored lazily on g_new
        self._aff_cache = (delta.touched, aff)
        return space_new
