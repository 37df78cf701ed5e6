"""Chunked out-of-core planning: bounded slices of the census plan.

:func:`repro_torch.core.planner.build_plan` materializes the whole O(W)
flat work plan at once.  This module slices the same canonical-pair
iteration space into contiguous *pre-prune item ranges* of at most
``max_items`` items each, so peak host memory for the item arrays is
O(max_items) regardless of W.

Key properties:

* **Exact partition.**  Chunk items are exactly the monolithic plan's items,
  split by pre-prune index; histograms and intersection counters are
  integer sums, so accumulating per-chunk partials is bit-identical to the
  single dispatch.
* **Intra-pair splits.**  Boundaries fall at arbitrary item indices, so a
  hub pair whose item count exceeds ``max_items`` simply spans several
  chunks.
* **Additive bases.**  The closed-form dyadic bases are credited to the
  chunk containing each pair's first pre-prune item and sum exactly to the
  global bases.
* **Fixed chunk shape.**  Every chunk's packed item arrays are padded to
  the same ``chunk_shape``, and every descriptor window to the same
  ``desc_shape``, so the engine preallocates its device buffers once.

Host-side numpy, framework-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.planner import (
    DESC_SEARCH_ITERS, DescriptorWindow, PairSpace, PlanOverflowError,
    descriptor_window, emit_items, max_pairs_per_window, num_desc_anchors,
    pad_and_pack, pair_space)


@dataclass(frozen=True)
class PlanChunk:
    """One bounded slice of the flat work plan.

    ``item_sp``/``item_pv`` are the planner's packed words, padded with
    invalid (all-zero) items to the chunker's fixed ``chunk_shape``.
    ``base_asym``/``base_mut`` are this chunk's additive share of the
    closed-form dyadic terms.
    """

    index: int                 #: chunk number, 0-based
    num_chunks: int
    start: int                 #: pre-prune item range [start, stop)
    stop: int
    num_items: int             #: valid (post-prune) items in this chunk
    item_sp: np.ndarray        #: (chunk_shape,) int32
    item_pv: np.ndarray        #: (chunk_shape,) int32
    base_asym: int
    base_mut: int


class PlanChunker:
    """Slices a graph's census iteration space into bounded chunks.

    ``max_items`` bounds the *pre-prune* items per chunk (so valid items
    per chunk are ≤ max_items); ``pad_to`` rounds the fixed chunk shape up
    to a multiple.  ``orient`` / ``prune_self`` match
    :func:`repro_torch.core.planner.build_plan`.  A prebuilt ``space``
    bypasses the graph decomposition (``orient``/``prune_self`` are then
    the space's own).
    """

    def __init__(self, g: CompactDigraph | None, max_items: int | None,
                 orient: str = "none", pad_to: int = 1,
                 prune_self: bool = True, *,
                 space: PairSpace | None = None):
        if max_items is not None and max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items}")
        if pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        self.space: PairSpace = space if space is not None else \
            pair_space(g, orient=orient, prune_self=prune_self)
        w_pre = self.space.num_items_preprune
        #: ``max_items=None`` covers the whole item space as one chunk —
        #: the monolithic schedule expressed in chunker terms
        self.max_items = int(max_items) if max_items is not None \
            else max(w_pre, 1)
        self.pad_to = int(pad_to)
        self.num_chunks = -(-w_pre // self.max_items) if w_pre else 0
        #: fixed padded per-chunk item-array length; clamped to the actual
        #: work when the budget exceeds it
        span = min(self.max_items, max(w_pre, 1))
        self.chunk_shape = -(-span // self.pad_to) * self.pad_to
        if self.chunk_shape >= 2**31:
            raise PlanOverflowError(
                f"chunk_shape {self.chunk_shape} exceeds int32 item "
                f"indexing and would silently wrap the per-window int32 "
                f"accumulator lanes; pass a smaller max_items budget "
                f"(< 2**31)")
        starts = np.arange(self.num_chunks, dtype=np.int64) * self.max_items
        self._starts = starts
        self._base_asym, self._base_mut = self.space.base_slices(starts)
        # descriptor-space view of the same schedule: the fixed desc_shape
        # is the widest per-chunk pair span
        self.desc_shape = max_pairs_per_window(self.space.offsets,
                                               self.max_items)
        #: lower-bound depth per lane — a constant, thanks to the
        #: anchored search (see planner.DESC_ANCHOR_STRIDE)
        self.desc_iters = DESC_SEARCH_ITERS
        self.num_anchors = num_desc_anchors(self.chunk_shape)

    def __len__(self) -> int:
        return self.num_chunks

    @property
    def num_items_preprune(self) -> int:
        return self.space.num_items_preprune

    def device_arrays(self) -> tuple[np.ndarray, ...]:
        """The 5 chunk-invariant device arrays (graph + pairs), int32 —
        uploaded once by the engine and reused across every chunk."""
        s = self.space
        return (s.indptr.astype(np.int32), s.packed,
                s.pair_u.astype(np.int32), s.pair_v.astype(np.int32),
                s.pair_code)

    def _bounds(self, k: int) -> tuple[int, int]:
        if not 0 <= k < self.num_chunks:
            raise IndexError(f"chunk {k} out of range "
                             f"[0, {self.num_chunks})")
        lo = int(self._starts[k])
        return lo, min(lo + self.max_items, self.space.num_items_preprune)

    def chunk(self, k: int) -> PlanChunk:
        """Materialize chunk ``k`` (O(max_items) memory)."""
        lo, hi = self._bounds(k)
        item_pair, item_slot, item_side = emit_items(self.space, lo, hi)
        num_items = int(item_pair.shape[0])
        item_sp, item_pv = pad_and_pack(item_pair, item_slot, item_side,
                                        self.chunk_shape)
        return PlanChunk(
            index=k, num_chunks=self.num_chunks, start=lo, stop=hi,
            num_items=num_items, item_sp=item_sp, item_pv=item_pv,
            base_asym=int(self._base_asym[k]),
            base_mut=int(self._base_mut[k]))

    def descriptors(self, k: int) -> DescriptorWindow:
        """Chunk ``k`` as a pair-descriptor window (O(pairs-in-chunk)
        memory, no item materialization).  Intra-pair splits surface as
        the window's ``desc_within0`` offsets."""
        lo, hi = self._bounds(k)
        return descriptor_window(self.space.offsets, lo, hi,
                                 self.desc_shape, self.num_anchors)

    def bases(self, k: int) -> tuple[int, int]:
        """Chunk ``k``'s additive (base_asym, base_mut) share."""
        return int(self._base_asym[k]), int(self._base_mut[k])

    def __iter__(self) -> Iterator[PlanChunk]:
        for k in range(self.num_chunks):
            yield self.chunk(k)


def iter_plan_chunks(g: CompactDigraph, max_items: int,
                     orient: str = "none", pad_to: int = 1,
                     prune_self: bool = True) -> Iterator[PlanChunk]:
    """Generator convenience over :class:`PlanChunker`."""
    yield from PlanChunker(g, max_items, orient=orient, pad_to=pad_to,
                           prune_self=prune_self)
