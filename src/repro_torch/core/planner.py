"""Host-side work planner — the paper's "manhattan collapse", reified.

The imperfectly nested loops ``for u in V / for v in N(u), u < v / for w in
N(u) ∪ N(v)`` are flattened into dense arrays of *work items*, one item per
(canonical pair, neighbor slot).  Equal-sized chunks of this flat plan give
exact static load balance, measurable ahead of time.

The planner is factored in two stages so the flat plan never *has* to be
materialized at once:

* :func:`pair_space` builds the O(pairs) canonical-pair decomposition —
  per-pair item counts, prefix offsets into the conceptual pre-prune item
  space, and the per-pair closed-form dyadic terms.
* :func:`emit_items` materializes any contiguous slice ``[lo, hi)`` of
  that item space (with pruning/orientation applied) in O(hi - lo) memory;
  :func:`emit_items_for_pairs` does the same for an arbitrary pair subset
  (the incremental census's affected pairs).
* :func:`descriptor_window` compresses any window of the item space into
  O(pairs) *descriptors* (:class:`DescriptorWindow`) from which the
  device expands items itself
  (:func:`repro_torch.core.census.expand_work_items`) — the
  ``emit="device"`` path that never materializes items on the host.

:func:`build_plan` is the one-slice special case (``[0, W)``);
:mod:`repro_torch.core.plan_stream` iterates bounded slices.

Two refinements live here:

* **Packed item encoding** — each work item is two int32 words:
  ``item_sp = slot << 1 | side`` and ``item_pv = pair << 1 | valid``,
  which is what the fused host-item kernel consumes directly.
* **Degree-oriented planning** (``orient="degree"``) — per pair, the
  *lower-degree* endpoint's row witnesses N(u)∩N(v), and items on the
  other side that can never satisfy the canonical counting predicate
  (``w <= v`` for N(u)-side items, ``w <= u`` for N(v)-side items) are
  dropped, with bit-identical censuses.

Host-side numpy; the one torch call is the profiler range around a
window's anchor table (:data:`repro_torch.core.spans.ANCHORS`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.digraph import CompactDigraph, canonical_pairs
from repro_torch.core.spans import ANCHORS, span

#: bit 2 of ``pair_code`` in a degree-oriented plan: which side of the pair
#: (0 = N(u), 1 = N(v)) witnesses the intersection count for the dyadic
#: closed forms.  Default plans leave it 0.
INTER_SIDE_BIT = 2


class PlanOverflowError(ValueError):
    """A plan (or one window of a streamed plan) would exceed the int32
    packed-item indexing / per-window int32 accumulator lanes.

    Raised at *plan time* wherever an item count could reach ``2**31``,
    so the failure is a clear message instead of a silent int32
    wraparound (undefined behaviour inside a CUDA kernel).
    """


def pack_items(item_slot: np.ndarray, item_side: np.ndarray,
               item_pair: np.ndarray, item_valid: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Fold (slot, side) and (pair, valid) into two int32 words per item.

    Requires ``slot < 2**30`` and ``pair < 2**30`` (enforced by
    :func:`make_pair_space`'s int32 guard).
    """
    item_sp = ((item_slot.astype(np.int64) << 1)
               | item_side.astype(np.int64)).astype(np.int32)
    item_pv = ((item_pair.astype(np.int64) << 1)
               | item_valid.astype(np.int64)).astype(np.int32)
    return item_sp, item_pv


def unpack_items(item_sp: np.ndarray, item_pv: np.ndarray):
    """Inverse of :func:`pack_items`: (slot, side, pair, valid)."""
    item_sp = np.asarray(item_sp)
    item_pv = np.asarray(item_pv)
    return (item_sp >> 1, (item_sp & 1).astype(np.int32),
            item_pv >> 1, (item_pv & 1).astype(bool))


@dataclass(frozen=True)
class PairSpace:
    """Canonical-pair decomposition of the census iteration space.

    Everything needed to (a) emit any contiguous slice of the *pre-prune*
    flat item space on demand and (b) split the closed-form dyadic bases
    additively across such slices — in O(n + edges + pairs) host memory,
    independent of the total work-item count W.
    """

    n: int
    orient: str                #: "none" or "degree"
    prune_self: bool
    max_degree: int
    search_iters: int

    indptr: np.ndarray         #: (n+1,) int64 CSR row offsets
    packed: np.ndarray         #: (2*pairs,) int32 ``(nbr << 2) | code``
    nbr: np.ndarray            #: (2*pairs,) ``packed >> 2`` (precomputed)
    deg: np.ndarray            #: (n,) row degrees

    pair_u: np.ndarray         #: (P,) int64
    pair_v: np.ndarray         #: (P,) int64
    pair_code: np.ndarray      #: (P,) int32, incl. inter-side bit if oriented

    counts: np.ndarray         #: (P,) pre-prune items per pair (deg_u+deg_v)
    offsets: np.ndarray        #: (P+1,) int64 prefix sum of ``counts``
    pair_term: np.ndarray      #: (P,) int64 closed-form term n-deg_u-deg_v
    pair_mut: np.ndarray       #: (P,) bool — pair dyad is mutual

    @property
    def num_pairs(self) -> int:
        return self.pair_u.shape[0]

    @property
    def num_items_preprune(self) -> int:
        """Size W₀ of the pre-prune flat item space (Σ deg_u + deg_v)."""
        return int(self.offsets[-1])

    def num_items_postprune(self) -> int:
        """Exact post-prune work-item count W without emitting any items
        (the sum of :func:`postprune_pair_counts`)."""
        if self.num_pairs == 0:
            return 0
        return int(postprune_pair_counts(self).sum())

    def base_slices(self, starts: np.ndarray) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """Additive (base_asym, base_mut) shares for the slices delimited by
        pre-prune item positions ``starts`` (ascending, covering [0, W₀)).

        Each pair's term is credited to the slice containing the pair's
        first pre-prune item, so the shares sum exactly to the global bases
        regardless of where slice boundaries fall (including mid-pair).
        """
        starts = np.asarray(starts, dtype=np.int64)
        nchunks = starts.shape[0]
        which = np.searchsorted(starts, self.offsets[:-1], side="right") - 1
        which = np.clip(which, 0, max(nchunks - 1, 0))
        asym = np.zeros(nchunks, dtype=np.int64)
        mut = np.zeros(nchunks, dtype=np.int64)
        np.add.at(asym, which[~self.pair_mut], self.pair_term[~self.pair_mut])
        np.add.at(mut, which[self.pair_mut], self.pair_term[self.pair_mut])
        return asym, mut


def make_pair_space(g: CompactDigraph, pair_u: np.ndarray,
                    pair_v: np.ndarray, pair_code: np.ndarray, *,
                    orient: str, prune_self: bool = True,
                    pair_term: np.ndarray | None = None) -> PairSpace:
    """Assemble a :class:`PairSpace` over ``g`` from an explicit canonical
    -pair sequence — the constructor behind :func:`pair_space`.

    ``pair_code`` is taken as given, including any degree-orientation
    inter-side bits already stamped on it.  ``pair_term`` overrides the
    closed-form dyadic terms ``n - deg_u - deg_v``.
    """
    if orient not in ("none", "degree"):
        raise ValueError(f"unknown orient mode {orient!r}")
    indptr, packed = g.indptr, g.packed
    deg = g.degrees
    pair_u = np.asarray(pair_u, dtype=np.int64)
    pair_v = np.asarray(pair_v, dtype=np.int64)
    pair_code = np.asarray(pair_code, dtype=np.int32)
    num_pairs = pair_u.shape[0]

    deg_u, deg_v = deg[pair_u], deg[pair_v]
    counts = (deg_u + deg_v).astype(np.int64)
    offsets = np.zeros(num_pairs + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])

    # slot/pair gain a packed flag bit, so they must fit in 30 value bits
    if packed.shape[0] >= 2**30:
        raise ValueError("graph exceeds int32 packed-item indexing "
                         "(need slots < 2**30); shard the graph first")

    if pair_term is None:
        pair_term = (g.n - deg_u - deg_v).astype(np.int64)
    max_deg = int(deg.max()) if g.n else 0
    return PairSpace(
        n=g.n, orient=orient, prune_self=prune_self, max_degree=max_deg,
        search_iters=max(1, int(np.ceil(np.log2(max_deg + 1)))),
        indptr=indptr, packed=packed, nbr=packed >> 2, deg=deg,
        pair_u=pair_u, pair_v=pair_v, pair_code=pair_code,
        counts=counts, offsets=offsets,
        pair_term=np.asarray(pair_term, dtype=np.int64),
        pair_mut=(pair_code & 3) == 3)


def pair_space(g: CompactDigraph, orient: str = "none",
               prune_self: bool = True) -> PairSpace:
    """Build the O(pairs) pair decomposition for ``g`` (no items yet)."""
    if orient not in ("none", "degree"):
        raise ValueError(f"unknown orient mode {orient!r}")
    # canonical pairs: CSR entries with nbr > row
    pair_u, pair_v, pair_code = canonical_pairs(g)
    pair_code = pair_code.astype(np.int32)
    if orient == "degree" and pair_u.shape[0]:
        deg = g.degrees
        inter_side = (deg[pair_v] < deg[pair_u]).astype(np.int32)
        pair_code = pair_code | (inter_side << INTER_SIDE_BIT)
    return make_pair_space(g, pair_u, pair_v, pair_code, orient=orient,
                           prune_self=prune_self)


def searchsorted_many(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``np.searchsorted(a, v)`` for many queries, searched in ascending
    order: on a large ``a`` each query of a random order misses the cache
    at nearly every probe, an ascending run of queries mostly hits it.
    The same result, in ``v``'s order."""
    v = np.asarray(v)
    if v.shape[0] < 2**16:
        return np.searchsorted(a, v)
    order = np.argsort(v)
    out = np.empty(v.shape[0], dtype=np.intp)
    out[order] = np.searchsorted(a, v[order])
    return out


def postprune_pair_counts(space: PairSpace,
                          pair_ids: np.ndarray | None = None,
                          entry_key: np.ndarray | None = None
                          ) -> np.ndarray:
    """Exact post-prune work items per pair, (P,) int64, without emitting.

    With self-pruning each pair loses its two guaranteed self-items; with
    degree orientation the witness side keeps its ``deg - 1`` non-self
    items while the other side keeps only the entries past the
    co-endpoint in its sorted row — countable from the CSR in
    O(P log m) via the globally sorted entry keys.  ``pair_ids``
    restricts the computation to a pair subset (result aligned with
    ``pair_ids``); ``entry_key`` passes precomputed sorted
    ``row * n + nbr`` keys.
    """
    if space.num_pairs == 0:
        return np.zeros(0 if pair_ids is None else len(pair_ids),
                        dtype=np.int64)
    counts = space.counts if pair_ids is None else space.counts[pair_ids]
    if space.orient != "degree":
        return counts - (2 if space.prune_self else 0)
    pu = space.pair_u if pair_ids is None else space.pair_u[pair_ids]
    pv = space.pair_v if pair_ids is None else space.pair_v[pair_ids]
    code = (space.pair_code if pair_ids is None
            else space.pair_code[pair_ids])
    if entry_key is None:
        rows = np.repeat(np.arange(space.n, dtype=np.int64),
                         space.deg.astype(np.int64))
        entry_key = rows * space.n + space.nbr.astype(np.int64)
    pos_v_in_u = (np.searchsorted(entry_key, pu * space.n + pv)
                  - space.indptr[pu])
    pos_u_in_v = (searchsorted_many(entry_key, pv * space.n + pu)
                  - space.indptr[pv])
    deg_u = space.deg[pu].astype(np.int64)
    deg_v = space.deg[pv].astype(np.int64)
    inter = (code >> INTER_SIDE_BIT) & 1
    side0 = np.where(inter == 0, deg_u - 1, deg_u - pos_v_in_u - 1)
    side1 = np.where(inter == 1, deg_v - 1, deg_v - pos_u_in_v - 1)
    return side0 + side1


def emit_items(space: PairSpace, lo: int, hi: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialize pre-prune item range ``[lo, hi)`` with pruning applied.

    Returns ``(item_pair, item_slot, item_side)`` for the surviving items,
    in pre-prune order, using O(hi - lo) memory.  Slices may start or end
    mid-pair (intra-pair splits for hub pairs are exactly this).
    """
    offsets = space.offsets
    lo, hi = int(lo), int(hi)
    if not (0 <= lo <= hi <= space.num_items_preprune):
        raise ValueError(f"slice [{lo}, {hi}) outside item space "
                         f"[0, {space.num_items_preprune})")
    empty = np.zeros(0, np.int64)
    if hi == lo:
        return empty, empty, empty.astype(np.int8)

    p0 = int(np.searchsorted(offsets, lo, side="right") - 1)
    p1 = int(np.searchsorted(offsets, hi, side="left"))
    ids = np.arange(p0, p1, dtype=np.int64)
    overlap = (np.minimum(offsets[ids + 1], hi)
               - np.maximum(offsets[ids], lo))
    item_pair = np.repeat(ids, overlap)
    within = np.arange(lo, hi, dtype=np.int64) - offsets[item_pair]
    return _materialize_items(space, item_pair, within)


def _materialize_items(space: PairSpace, item_pair: np.ndarray,
                       within: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Turn (pair, within-pair position) coordinates into concrete pruned
    ``(pair, slot, side)`` items — the tail shared by :func:`emit_items`
    and :func:`emit_items_for_pairs`, so the contiguous-slice and
    pair-subset paths can never diverge."""
    deg_u = space.deg[space.pair_u[item_pair]]
    item_side = (within >= deg_u).astype(np.int8)
    item_slot = np.where(
        item_side == 0,
        space.indptr[space.pair_u[item_pair]] + within,
        space.indptr[space.pair_v[item_pair]] + within - deg_u)
    return prune_items(space, item_pair, item_slot, item_side)


def prune_items(space: PairSpace, item_pair: np.ndarray,
                item_slot: np.ndarray, item_side: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply the space's pruning/orientation policy to raw items — the
    shared tail of :func:`emit_items` and :func:`emit_items_for_pairs`."""
    if space.orient == "degree":
        inter_side = (space.pair_code[item_pair] >> INTER_SIDE_BIT) & 1
        w_ids = space.nbr[item_slot]
        u_of = space.pair_u[item_pair]
        v_of = space.pair_v[item_pair]
        on_inter = item_side == inter_side
        not_self = (w_ids != u_of) & (w_ids != v_of)
        # non-inter-side items survive only if the canonical predicate can
        # hold: N(u)-side needs w > v; N(v)-side needs w > u (plan-time
        # facts — see census.classify_items for the device-side predicate)
        can_count = np.where(item_side == 0, w_ids > v_of, w_ids > u_of)
        keep = not_self & (on_inter | can_count)
        return item_pair[keep], item_slot[keep], item_side[keep]
    if space.prune_self:
        w_ids = space.nbr[item_slot]
        keep = ~(((item_side == 0) & (w_ids == space.pair_v[item_pair])) |
                 ((item_side == 1) & (w_ids == space.pair_u[item_pair])))
        return item_pair[keep], item_slot[keep], item_side[keep]
    return item_pair, item_slot, item_side


def emit_items_for_pairs(space: PairSpace, pair_ids
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Materialize the (pruned) work items of an arbitrary pair subset.

    ``pair_ids`` indexes the space's canonical pair arrays; items come out
    grouped by pair in the given order, in O(Σ counts[pair_ids]) memory.
    The union over a partition of all pairs reproduces exactly the items
    of :func:`emit_items` over ``[0, W₀)`` (possibly permuted — census
    partials are order-invariant integer sums), which is what makes
    per-subset census contributions additive.
    """
    ids = np.asarray(pair_ids, dtype=np.int64).ravel()
    empty = np.zeros(0, np.int64)
    if ids.size == 0:
        return empty, empty, empty.astype(np.int8)
    if ids.min() < 0 or ids.max() >= space.num_pairs:
        raise ValueError(f"pair id outside [0, {space.num_pairs})")
    counts = space.counts[ids]
    total = int(counts.sum())
    item_pair = np.repeat(ids, counts)
    starts = np.cumsum(counts) - counts
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    return _materialize_items(space, item_pair, within)


#: bytes per pair descriptor shipped by the device-emission path: three
#: int32 words (pair id, window-local cumulative offset, within-pair start)
DESC_BYTES = 12

#: padding value for ``desc_cum`` — larger than any window-local item
#: index, so the lower-bound search never lands on a padding descriptor
DESC_CUM_PAD = 2**31 - 1

#: anchor-table stride for the in-kernel item→descriptor lookup: one
#: precomputed anchor per ``DESC_ANCHOR_STRIDE`` flat items narrows the
#: per-lane lower-bound search to the <= stride + 1 descriptors that can
#: overlap one stride span (every descriptor spans >= 1 pre-prune item),
#: making the search depth a small constant independent of the window's
#: pair count
DESC_ANCHOR_STRIDE = 16

#: lower-bound depth sufficient for any anchored search range
DESC_SEARCH_ITERS = int(np.ceil(np.log2(DESC_ANCHOR_STRIDE + 2)))


def num_desc_anchors(chunk_shape: int) -> int:
    """Fixed anchor-table length for a ``chunk_shape``-lane window (the
    +2 covers the partial trailing stride and the closing bound)."""
    return int(chunk_shape) // DESC_ANCHOR_STRIDE + 2


def max_pairs_per_window(offsets: np.ndarray, window: int) -> int:
    """Widest pair span of any chunk in the equal-``window`` slicing of
    an item space — the one boundary convention (searchsorted right/left
    over the prefix ``offsets``) shared by every descriptor-shape sizing
    decision."""
    offsets = np.asarray(offsets, dtype=np.int64)
    total = int(offsets[-1])
    if total == 0 or offsets.shape[0] <= 1:
        return 1
    starts = np.arange(0, total, int(window), dtype=np.int64)
    stops = np.minimum(starts + int(window), total)
    p0 = np.searchsorted(offsets, starts, side="right") - 1
    p1 = np.searchsorted(offsets, stops, side="left")
    return max(int((p1 - p0).max()), 1)


@dataclass(frozen=True)
class DescriptorWindow:
    """Compact per-pair descriptors for one window of an item space.

    O(pairs-in-window) descriptors from which the device expands every
    flat item index ``i`` in ``[0, num_preprune)`` back to its
    ``(pair, slot, side)`` coordinates arithmetically
    (:func:`repro_torch.core.census.expand_work_items`).  ``desc_cum[j]``
    is the window-local index of descriptor j's first item;
    ``desc_within0[j]`` is the within-pair position of that first item —
    non-zero only when the window starts mid-pair.  Arrays are padded to
    a fixed ``desc_shape``.
    """

    start: int                 #: window [start, stop) in its item space
    stop: int
    num_preprune: int          #: stop - start (valid expansion lanes)
    num_descs: int             #: live descriptors before padding
    desc_pair: np.ndarray      #: (desc_shape,) int32 pair ids, pad 0
    desc_cum: np.ndarray       #: (desc_shape,) int32, pad DESC_CUM_PAD
    desc_within0: np.ndarray   #: (desc_shape,) int32, pad 0
    anchors: np.ndarray        #: (num_anchors,) int32 item→desc anchors
    #                            (empty: the device builds them)

    @property
    def upload_bytes(self) -> int:
        """Host→device plan bytes this window ships (padded descriptor
        arrays + anchor table + the 4-byte valid-lane count)."""
        return (DESC_BYTES * int(self.desc_pair.shape[0])
                + 4 * int(self.anchors.shape[0]) + 4)

    def device_words(self) -> np.ndarray:
        """The window as ONE int32 buffer — ``[num_preprune, desc_pair…,
        desc_cum…, desc_within0…, anchors…]`` — so each chunk costs a
        single host→device upload; the device step slices the fields
        back apart (see :func:`split_device_words`)."""
        return np.concatenate([
            np.array([self.num_preprune], dtype=np.int32),
            self.desc_pair, self.desc_cum, self.desc_within0,
            self.anchors])


def split_device_words(words, num_anchors: int):
    """Slice a :meth:`DescriptorWindow.device_words` buffer (numpy array
    or tensor) back into ``(num_valid (1,), desc_pair, desc_cum,
    desc_within0, anchors)`` views."""
    num_descs = (words.shape[0] - 1 - num_anchors) // 3
    return (words[:1], words[1:1 + num_descs],
            words[1 + num_descs:1 + 2 * num_descs],
            words[1 + 2 * num_descs:1 + 3 * num_descs],
            words[1 + 3 * num_descs:])


def descriptor_window(offsets: np.ndarray, lo: int, hi: int,
                      desc_shape: int, num_anchors: int,
                      pair_ids=None) -> DescriptorWindow:
    """Build the descriptors of item window ``[lo, hi)``.

    ``offsets`` is the (K+1,) pre-prune prefix over a pair sequence —
    :attr:`PairSpace.offsets` for the global space (``pair_ids=None``:
    descriptor j's pair id is its absolute index), or a subset prefix with
    ``pair_ids`` giving the actual pair ids.  ``num_anchors`` fixes the
    anchor-table shape (:func:`num_desc_anchors` of the dispatch lane
    count); 0 builds no table, for a launch that builds it on the device
    from ``desc_cum`` (``repro_torch.kernels.ops.desc_anchors``), and the
    window's words then end at ``desc_within0``.  O(pairs-in-window +
    num_anchors) time and memory; boundaries may fall mid-pair.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    lo, hi = int(lo), int(hi)
    if not (0 <= lo <= hi <= int(offsets[-1])):
        raise ValueError(f"window [{lo}, {hi}) outside item space "
                         f"[0, {int(offsets[-1])})")
    j0 = int(np.searchsorted(offsets, lo, side="right") - 1) if hi > lo \
        else 0
    j1 = int(np.searchsorted(offsets, hi, side="left")) if hi > lo else 0
    nd = j1 - j0
    if nd > desc_shape:
        raise ValueError(f"window [{lo}, {hi}) spans {nd} pairs "
                         f"> desc_shape {desc_shape}")
    dp = np.zeros(desc_shape, dtype=np.int32)
    dc = np.full(desc_shape, DESC_CUM_PAD, dtype=np.int32)
    dw = np.zeros(desc_shape, dtype=np.int32)
    anchors = np.zeros(num_anchors, dtype=np.int32)
    if nd:
        ids = (np.arange(j0, j1, dtype=np.int64) if pair_ids is None
               else np.asarray(pair_ids, dtype=np.int64)[j0:j1])
        starts = offsets[j0:j1]
        dp[:nd] = ids
        cum = np.maximum(starts - lo, 0)
        dc[:nd] = cum
        dw[:nd] = np.maximum(lo - starts, 0)
    if nd and num_anchors:
        with span(ANCHORS):
            grid = (np.arange(num_anchors, dtype=np.int64)
                    * DESC_ANCHOR_STRIDE)
            anchors[:] = np.clip(
                np.searchsorted(cum, grid, side="right") - 1, 0, nd - 1)
    return DescriptorWindow(start=lo, stop=hi, num_preprune=hi - lo,
                            num_descs=nd, desc_pair=dp, desc_cum=dc,
                            desc_within0=dw, anchors=anchors)


def iter_descriptor_windows(offsets: np.ndarray, max_items: int,
                            desc_shape: int, num_anchors: int,
                            pair_ids=None):
    """Cover an item space with descriptor windows of at most ``max_items``
    items AND at most ``desc_shape`` pairs each (a window over many small
    pairs shrinks its item span instead of overflowing the fixed-shape
    descriptor buffers)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    total = int(offsets[-1])
    num_pairs = offsets.shape[0] - 1
    lo = 0
    while lo < total:
        j0 = int(np.searchsorted(offsets, lo, side="right") - 1)
        hi = min(lo + int(max_items), total,
                 int(offsets[min(j0 + int(desc_shape), num_pairs)]))
        yield descriptor_window(offsets, lo, hi, desc_shape, num_anchors,
                                pair_ids=pair_ids)
        lo = hi


def base_for_pairs(space: PairSpace, pair_ids) -> tuple[int, int]:
    """Subset-additive ``(base_asym, base_mut)`` closed-form shares for an
    arbitrary pair subset; over a partition of all pairs these sum exactly
    to :func:`global_bases`."""
    ids = np.asarray(pair_ids, dtype=np.int64).ravel()
    mut = space.pair_mut[ids]
    term = space.pair_term[ids]
    return int(term[~mut].sum()), int(term[mut].sum())


def pad_and_pack(item_pair: np.ndarray, item_slot: np.ndarray,
                 item_side: np.ndarray, length: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pad emitted items with invalid (all-zero) entries to ``length`` and
    fold them into the two packed int32 words — the one padding/packing
    convention shared by the monolithic plan and every streamed chunk."""
    num_items = item_pair.shape[0]
    pad = length - num_items
    item_pair = np.concatenate([item_pair, np.zeros(pad, np.int64)])
    item_slot = np.concatenate([item_slot, np.zeros(pad, np.int64)])
    item_side = np.concatenate([item_side, np.zeros(pad, np.int8)])
    item_valid = np.concatenate(
        [np.ones(num_items, bool), np.zeros(pad, bool)])
    return pack_items(item_slot, item_side, item_pair, item_valid)


@dataclass(frozen=True)
class CensusPlan:
    """Flattened iteration space + exact host-side closed-form terms."""

    n: int
    num_pairs: int
    num_items: int             #: pre-padding work-item count W
    max_degree: int
    search_iters: int          #: binary-search depth = ceil(log2(max_deg+1))
    orient: str                #: "none" or "degree"

    # device arrays (int32): graph
    indptr: np.ndarray         #: (n+1,)
    packed: np.ndarray         #: (2*pairs,)
    # canonical pairs
    pair_u: np.ndarray         #: (P,)
    pair_v: np.ndarray         #: (P,)
    pair_code: np.ndarray      #: (P,) dyad code in {1,2,3} | inter_side << 2
    # flat work items (padded to `pad_to`), packed two-words-per-item
    item_sp: np.ndarray        #: (Wp,) ``slot << 1 | side``
    item_pv: np.ndarray        #: (Wp,) ``pair << 1 | valid``

    # exact int64 host terms for the dyadic (012/102) closed forms:
    # census[t] = base_t + (# intersections found on device for pairs of t)
    base_asym: int
    base_mut: int

    def balance_stats(self, num_shards: int) -> dict[str, float]:
        """Work-imbalance metrics (paper Fig 9 utilization analogue): the
        flat plan against pair-granular partitioning (what a naive
        parallel-for over pairs would give on a power-law graph)."""
        wp = self.item_pv.shape[0]
        flat_max = -(-wp // num_shards) if wp else 0
        flat_mean = wp / num_shards
        _, _, item_pair, item_valid = unpack_items(self.item_sp,
                                                   self.item_pv)
        cost = np.bincount(item_pair[item_valid],
                           minlength=self.num_pairs).astype(np.int64)
        bounds = np.linspace(0, self.num_pairs, num_shards + 1).astype(int)
        per = np.add.reduceat(cost, bounds[:-1]) if self.num_pairs else \
            np.zeros(num_shards)
        stats = {
            "flat_max_over_mean":
                flat_max / max(flat_mean, 1e-9) if wp else 1.0,
            "pair_max_over_mean": float(per.max() / max(per.mean(), 1e-9))
            if self.num_pairs else 1.0,
            "items": int(self.num_items),
            "pairs": int(self.num_pairs),
        }
        return stats


def build_plan(g: CompactDigraph, pad_to: int = 1,
               prune_self: bool = True, orient: str = "none") -> CensusPlan:
    """Construct the flat census plan for a compact graph.

    The one-chunk special case of the streaming planner: the whole
    pre-prune item space is emitted as a single :func:`emit_items` slice,
    so host memory is O(W).  For large graphs use
    :class:`repro_torch.core.engine.CensusEngine` with a ``max_items``
    budget, which never materializes more than one chunk.

    ``prune_self`` drops the two guaranteed no-op items per pair at plan
    time; ``orient="degree"`` applies the degree-oriented pruning (see
    module docstring).  A plan with zero work items has zero-length item
    arrays, and the engine resolves it from the closed-form bases alone.
    """
    space = pair_space(g, orient=orient, prune_self=prune_self)
    item_pair, item_slot, item_side = emit_items(
        space, 0, space.num_items_preprune)
    num_items = int(item_pair.shape[0])

    # pad the flat plan to a multiple of pad_to (a zero-item plan stays
    # zero-length — no phantom padded items)
    wp = -(-num_items // pad_to) * pad_to
    if wp >= 2**31:
        raise PlanOverflowError(
            "plan exceeds int32 packed-item indexing; "
            "stream it in chunks (CensusEngine max_items)")
    item_sp, item_pv = pad_and_pack(item_pair, item_slot, item_side, wp)
    base_asym, base_mut = global_bases(space)
    return CensusPlan(
        n=space.n, num_pairs=space.num_pairs, num_items=num_items,
        max_degree=space.max_degree, search_iters=space.search_iters,
        orient=orient,
        indptr=space.indptr.astype(np.int32), packed=space.packed,
        pair_u=space.pair_u.astype(np.int32),
        pair_v=space.pair_v.astype(np.int32),
        pair_code=space.pair_code,
        item_sp=item_sp, item_pv=item_pv,
        base_asym=base_asym, base_mut=base_mut)


def global_bases(space: PairSpace) -> tuple[int, int]:
    """Exact closed-form dyadic bases summed over all pairs."""
    base_mut = int(space.pair_term[space.pair_mut].sum())
    base_asym = int(space.pair_term[~space.pair_mut].sum())
    return base_asym, base_mut
