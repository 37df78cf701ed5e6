"""Vectorized triad census — the device half of the algorithm, in torch.

Each flat work item (pair p=(u,v), neighbor slot) is processed
independently: decode w and its direction code from the packed entry,
binary-search w in the *other* endpoint's sorted row, classify the triad
in situ from the 2-bit codes, and accumulate a 64-bin tricode histogram.

Backends (one-to-one with the JAX package's ``jnp`` / ``pallas`` /
``pallas-fused``):

* ``torch`` — plain torch tensor code; the oracle for everything below.
* ``hist``  — classification in torch, the 64-bin histogram in the CUDA
  kernel :mod:`repro_torch.kernels.tricode_hist`.
* ``fused`` — the whole per-item pipeline (expansion, gather, binary
  search, classification, histogram) in one CUDA kernel
  (:mod:`repro_torch.kernels.census_fused`); the per-item tricode never
  reaches device memory.

Returned per dispatch: ``hist64`` (connected-triad tricode histogram) and
``inter`` (count of N(u)∩N(v) elements split by pair mutuality, plus the
pruning predicate's keep count under device emission), all int32 on the
device; the engine merges them in int64 on the host
(:func:`assemble_counts`).

Every gather here stays inside its array.  XLA clamps an out-of-range
gather index, torch raises on the CPU and faults on CUDA, so each index
that the JAX package leaves to clamping is either clamped explicitly (the
fixed-depth searches) or pinned to a safe lane before use (padding lanes
of :func:`expand_work_items`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.planner import (
    DESC_ANCHOR_STRIDE, CensusPlan, num_desc_anchors, split_device_words)
from repro_torch.core.tricode import FOLD_64_TO_16

BACKENDS = ("torch", "hist", "fused")


def segment_searchsorted(keys: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, q: torch.Tensor,
                         iters: int) -> torch.Tensor:
    """First index i in [lo, hi) with keys[i] >= q, per element (batched).

    ``iters`` must be >= ceil(log2(max segment length + 1)).  A fixed
    number of steps with the probe clamped into ``keys``, exactly as the
    JAX package runs it, so that lanes which converge early end where its
    lanes end.
    """
    size = keys.shape[0]
    for _ in range(iters):
        mid = (lo + hi) >> 1
        km = keys[mid.clamp(0, size - 1)]
        go_right = km < q
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right, hi, mid))
    return lo


def classify_items(indptr, packed, pair_u, pair_v, pair_code,
                   item_pair, item_slot, item_side, item_valid,
                   search_iters: int):
    """Per-item triad classification. Returns (tricode, count_mask,
    inter_mask, is_mut).

    tricode is in [0, 64); count_mask marks items contributing a connected
    triad under the canonical-selection predicate; inter_mask marks items
    witnessing an element of N(u) ∩ N(v) on the pair's designated witness
    side (bit 2 of ``pair_code``; 0 unless the plan is degree-oriented).
    Every item coordinate must index its array (padding items carry
    pair 0 / slot 0).
    """
    nbr_ids = packed >> 2
    w_packed = packed[item_slot]
    w = w_packed >> 2
    c_side = w_packed & 3

    u = pair_u[item_pair]
    v = pair_v[item_pair]
    pc = pair_code[item_pair]
    c_uv = pc & 3
    inter_side = (pc >> 2) & 1

    side0 = item_side == 0
    other = torch.where(side0, v, u)
    lo = indptr[other]
    hi = indptr[other + 1]
    pos = segment_searchsorted(nbr_ids, lo, hi, w, search_iters)
    hit = packed[pos.clamp(0, packed.shape[0] - 1)]
    found = (pos < hi) & ((hit >> 2) == w)
    c_other = torch.where(found, hit & 3, 0)

    c_uw = torch.where(side0, c_side, c_other)
    c_vw = torch.where(side0, c_other, c_side)

    not_self = (w != u) & (w != v)
    dedup = ~(found & (item_side == 1))      # union duplicates count once
    canonical = (v < w) | ((u < w) & (w < v) & (c_uw == 0))
    count_mask = item_valid & not_self & dedup & canonical
    inter_mask = item_valid & not_self & found & (item_side == inter_side)

    tricode = c_uv * 16 + c_uw * 4 + c_vw
    return tricode, count_mask, inter_mask, c_uv == 3


def lane_descriptors(desc_cum, anchors, num_valid, idx,
                     desc_iters: int):
    """``(d, valid)``: the descriptor each flat item index of a window
    belongs to (descriptor 0 for padding lanes), by the anchored
    lower-bound search of :func:`expand_work_items`."""
    num_descs = desc_cum.shape[0]
    valid = idx < num_valid
    idx = torch.where(valid, idx, 0)
    a = (idx // DESC_ANCHOR_STRIDE).clamp(0, anchors.shape[0] - 1)
    lo_d = anchors[a]
    hi_d = (lo_d + DESC_ANCHOR_STRIDE + 1).clamp(max=num_descs)
    d = segment_searchsorted(desc_cum, lo_d, hi_d, idx + 1,
                             desc_iters) - 1
    d = torch.minimum(d.clamp(0, num_descs - 1), hi_d - 1)
    return torch.where(valid, d, 0), valid


def expand_work_items(indptr, pair_u, pair_v, desc_pair, desc_cum,
                      desc_within0, anchors, num_valid, idx,
                      desc_iters: int):
    """Map flat item indices back to ``(pair, slot, side, valid)`` from a
    per-pair descriptor window — the device-resident inverse of the host
    planner's ``emit_items``.

    ``desc_cum`` is the window-local cumulative-offset table (padded with
    :data:`repro_torch.core.planner.DESC_CUM_PAD`).  ``anchors``
    pre-resolves each :data:`DESC_ANCHOR_STRIDE`-item span to its first
    descriptor, so the per-lane search covers at most ``stride + 1``
    candidates and ``desc_iters`` is the constant
    :data:`repro_torch.core.planner.DESC_SEARCH_ITERS`.  ``num_valid`` is
    a (1,) tensor: lanes at or past it are padding and come out as
    (pair 0, slot 0, side 0, invalid).  Padding lanes are pinned to lane 0
    before any arithmetic, so that no gather leaves its array and no
    ``IDX_PAD`` sum overflows.
    """
    d, valid = lane_descriptors(desc_cum, anchors, num_valid, idx,
                                desc_iters)
    idx = torch.where(valid, idx, 0)
    pair = desc_pair[d]
    within = desc_within0[d] + (idx - desc_cum[d])
    u = pair_u[pair]
    v = pair_v[pair]
    row_u = indptr[u]
    deg_u = indptr[u + 1] - row_u
    side = (within >= deg_u).to(torch.int32)
    slot = torch.where(side == 0, row_u + within, indptr[v] + within - deg_u)
    return (torch.where(valid, pair, 0), torch.where(valid, slot, 0),
            torch.where(valid, side, 0), valid)


def prune_keep_mask(packed, pair_u, pair_v, pair_code,
                    item_pair, item_slot, item_side, item_valid,
                    orient: str, prune_self: bool):
    """Device-side mirror of the planner's plan-time pruning predicate
    (:func:`repro_torch.core.planner.prune_items`): which expanded items a
    host plan would have shipped.  Pruned items already contribute zero to
    every census counter, so this mask only feeds the valid-item
    statistics."""
    w_ids = packed[item_slot] >> 2
    u_of = pair_u[item_pair]
    v_of = pair_v[item_pair]
    not_self = (w_ids != u_of) & (w_ids != v_of)
    if orient == "degree":
        inter_side = (pair_code[item_pair] >> 2) & 1
        can_count = torch.where(item_side == 0, w_ids > v_of, w_ids > u_of)
        return item_valid & not_self & (
            (item_side == inter_side) | can_count)
    if prune_self:
        return item_valid & not_self
    return item_valid


def _partials_reduce(tricode, count_mask, inter_mask, is_mut,
                     histogram_fn=None, keep_mask=None):
    """Shared reduction tail: fold per-item classifications into the
    ``hist64`` histogram and the intersection counters (plus a valid-item
    count when ``keep_mask`` is given — the device-emission stats lane).

    Every count is accumulated in int32, the type the kernels return:
    the plan-time guards (:class:`repro_torch.core.planner
    .PlanOverflowError`) bound a dispatch below ``2**31`` lanes, and
    torch's default int64 sums would hide a missing guard.
    """
    if histogram_fn is None:
        hist64 = torch.zeros(64, dtype=torch.int32,
                             device=tricode.device).index_add_(
            0, torch.where(count_mask, tricode, 0),
            count_mask.to(torch.int32))
    else:
        hist64 = histogram_fn(tricode, count_mask)
    lanes = [
        (inter_mask & ~is_mut).sum(dtype=torch.int32),
        (inter_mask & is_mut).sum(dtype=torch.int32),
    ]
    if keep_mask is not None:
        lanes.append(keep_mask.sum(dtype=torch.int32))
    return hist64, torch.stack(lanes)


def census_partials(indptr, packed, pair_u, pair_v, pair_code,
                    item_sp, item_pv, search_iters: int, histogram_fn=None):
    """Dispatch partials from packed work items: (hist64, inter2) int32."""
    item_slot = item_sp >> 1
    item_side = item_sp & 1
    item_pair = item_pv >> 1
    item_valid = (item_pv & 1) == 1
    tricode, count_mask, inter_mask, is_mut = classify_items(
        indptr, packed, pair_u, pair_v, pair_code,
        item_pair, item_slot, item_side, item_valid, search_iters)
    return _partials_reduce(tricode, count_mask, inter_mask, is_mut,
                            histogram_fn)


def census_partials_desc(indptr, packed, pair_u, pair_v, pair_code,
                         desc_pair, desc_cum, desc_within0, anchors,
                         num_valid, idx, search_iters: int,
                         desc_iters: int, orient: str, prune_self: bool,
                         histogram_fn=None):
    """Dispatch partials from *pair descriptors*: ``(hist64, inter3)``.

    Expands each flat index in ``idx`` back to its work item
    (:func:`expand_work_items`) and classifies it in place.  ``inter3``
    carries the two intersection counters plus the count of items the
    plan-time pruning predicate would keep (:func:`prune_keep_mask`).
    """
    item_pair, item_slot, item_side, item_valid = expand_work_items(
        indptr, pair_u, pair_v, desc_pair, desc_cum, desc_within0,
        anchors, num_valid, idx, desc_iters)
    tricode, count_mask, inter_mask, is_mut = classify_items(
        indptr, packed, pair_u, pair_v, pair_code,
        item_pair, item_slot, item_side, item_valid, search_iters)
    keep = prune_keep_mask(packed, pair_u, pair_v, pair_code,
                           item_pair, item_slot, item_side, item_valid,
                           orient, prune_self)
    return _partials_reduce(tricode, count_mask, inter_mask, is_mut,
                            histogram_fn, keep_mask=keep)


def census_partials_desc_batch(indptr, packed, pair_u, pair_v, pair_code,
                               words_batch, idx, search_iters: int,
                               desc_iters: int, orient: str,
                               prune_self: bool, histogram_fn=None,
                               real: int | None = None):
    """K-window megastep partials: ``(hist64s (K, 64), inter3s (K, 3))``.

    ``words_batch`` is a ``(K, words)`` int32 batch of stacked
    :meth:`repro_torch.core.planner.DescriptorWindow.device_words` rows,
    all of the schedule-wide width ``1 + 3 * desc_shape + num_anchors``
    (``num_anchors`` from the length of ``idx``).  Each row runs through
    :func:`census_partials_desc`; a row whose word 0 (``num_preprune``) is
    0 is padding and gives exact zeros without any compute, as the JAX
    package's ``lax.cond`` does.  ``real`` (1 to K; every row when None)
    counts the batch's real windows: rows from ``real`` on are never read
    and give zeros, whatever they hold.  The per-row partials come back
    stacked, int32, for the engine to merge on the host in int64.
    """
    num_anchors = num_desc_anchors(idx.shape[0])
    rows = words_batch.shape[0]
    real = batch_real_rows(rows, real)
    hist = torch.zeros((rows, 64), dtype=torch.int32,
                       device=words_batch.device)
    inter = torch.zeros((rows, 3), dtype=torch.int32,
                        device=words_batch.device)
    for r in range(real):
        words = words_batch[r]
        if int(words[0]) == 0:
            continue
        nv, dp, dc, dw, an = split_device_words(words, num_anchors)
        hist[r], inter[r] = census_partials_desc(
            indptr, packed, pair_u, pair_v, pair_code, dp, dc, dw, an, nv,
            idx, search_iters, desc_iters, orient, prune_self,
            histogram_fn)
    return hist, inter


def batch_real_rows(rows: int, real: int | None) -> int:
    """The real windows of a ``rows``-row megastep batch: ``real``, or
    every row when None.  Raises unless ``1 <= real <= rows``."""
    if real is None:
        return rows
    if isinstance(real, bool) or int(real) != real or not 1 <= real <= rows:
        raise ValueError(f"a batch of {rows} rows holds 1 to {rows} real "
                         f"windows, got {real!r}")
    return int(real)


def assemble_counts(n: int, base_asym: int, base_mut: int,
                    hist64: np.ndarray, inter: np.ndarray) -> np.ndarray:
    """Combine (accumulated) device partials with the closed-form bases
    into the 16 counts, in int64 on the host."""
    hist64 = np.asarray(hist64, dtype=np.int64)
    inter = np.asarray(inter, dtype=np.int64)
    census = FOLD_64_TO_16 @ hist64
    census[1] += base_asym + int(inter[0])   # 012
    census[2] += base_mut + int(inter[1])    # 102
    total = n * (n - 1) * (n - 2) // 6
    census[0] = total - census[1:].sum()
    return census


def assemble_census(plan: CensusPlan, hist64: np.ndarray,
                    inter: np.ndarray) -> np.ndarray:
    """Combine device partials with host closed forms into the 16 counts."""
    return assemble_counts(plan.n, plan.base_asym, plan.base_mut,
                           hist64, inter)


def partials_fn(backend: str, search_iters: int):
    """Per-dispatch partials callable for ``backend``: maps the 7 device
    arrays (graph + pairs + packed items) to ``(hist64, inter)``."""
    if backend == "fused":
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.fused_census_partials,
                                 search_iters=search_iters)
    histogram_fn = None
    if backend == "hist":
        from repro_torch.kernels import ops as kops
        histogram_fn = kops.tricode_histogram
    return functools.partial(census_partials, search_iters=search_iters,
                             histogram_fn=histogram_fn)


def desc_partials_fn(backend: str, search_iters: int, desc_iters: int,
                     orient: str, prune_self: bool):
    """Descriptor-expansion counterpart of :func:`partials_fn`: maps the
    10 device arrays (graph + pairs + descriptor window + valid count) and
    the resident flat-index array to ``(hist64, inter3)``."""
    if backend == "fused":
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.fused_census_desc_partials,
                                 search_iters=search_iters,
                                 desc_iters=desc_iters, orient=orient,
                                 prune_self=prune_self)
    histogram_fn = None
    if backend == "hist":
        from repro_torch.kernels import ops as kops
        histogram_fn = kops.tricode_histogram
    return functools.partial(census_partials_desc,
                             search_iters=search_iters,
                             desc_iters=desc_iters, orient=orient,
                             prune_self=prune_self,
                             histogram_fn=histogram_fn)


def desc_anchors_fn(backend: str):
    """What makes a device-emission dispatch's anchor table for
    ``backend``: ``build(desc_cum, table) -> anchors``, the table of the
    window whose padded ``desc_cum`` the device holds.  ``fused`` and
    ``hist`` write it into ``table`` with the ``desc_anchors`` kernel (its
    plain version on the CPU); ``torch``, the oracle, computes it in
    plain torch."""
    from repro_torch.kernels import ops as kops
    if backend == "torch":
        return lambda desc_cum, table: kops.desc_anchors_ref(
            desc_cum, table.shape[0])
    return kops.desc_anchors


def desc_batch_partials_fn(backend: str, search_iters: int, desc_iters: int,
                           orient: str, prune_self: bool):
    """Megastep counterpart of :func:`desc_partials_fn`: maps the 5 graph
    arrays, a ``(K, words)`` window batch and the resident flat-index
    array to ``(hist64s (K, 64), inter3s (K, 3))``; ``fused`` is one CUDA
    launch per batch."""
    if backend == "fused":
        from repro_torch.kernels import ops as kops
        return functools.partial(kops.fused_census_desc_partials_batch,
                                 search_iters=search_iters,
                                 desc_iters=desc_iters, orient=orient,
                                 prune_self=prune_self)
    histogram_fn = None
    if backend == "hist":
        from repro_torch.kernels import ops as kops
        histogram_fn = kops.tricode_histogram
    return functools.partial(census_partials_desc_batch,
                             search_iters=search_iters,
                             desc_iters=desc_iters, orient=orient,
                             prune_self=prune_self,
                             histogram_fn=histogram_fn)


def triad_census(plan: CensusPlan, backend: str = "torch",
                 device=None) -> np.ndarray:
    """Single-device exact 16-type triad census from a plan.

    Thin wrapper over :class:`repro_torch.core.engine.CensusEngine`
    (monolithic, host-emitted items).  ``device=None`` means the CUDA
    device; pass ``device="cpu"`` to run on the host.
    """
    from repro_torch.core.engine import CensusEngine
    return CensusEngine(device=device, backend=backend).run_plan(plan)
