"""CUDA kernels: the whole census per-item pipeline, fused.

Counterpart of the Pallas kernels in the JAX package's
``kernels/census_fused.py``.  Each launch expands (device emission) or
decodes (host emission) its work items, gathers ``w`` and its direction
code from the packed CSR, binary-searches the other endpoint's row,
classifies the triad and folds a 64-bin histogram plus the counter lanes
— the per-item tricode never reaches device memory.  The kernels live in
``csrc/census_fused.cu``; see its header for what bounds them and how
the design answers it.

The graph arrays are read in place from device memory, so unlike the
Pallas kernels there is no on-chip size limit on the graph.  Inputs are
true-length, unpadded int32 vectors; the kernels handle the ragged tail.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.census import batch_real_rows
from repro_torch.core.planner import (
    DESC_ANCHOR_STRIDE, DESC_CUM_PAD, num_desc_anchors)
from repro_torch.kernels import build

#: work items per CUDA block of either kernel (256 threads, 16 items
#: each, walked as two independent chains)
BLOCK_ITEMS = 4096

#: the desc kernel's staging capacity per block: descriptors, and anchor
#: entries (a tile's lane positions span BLOCK_ITEMS / 16 + 1 anchors)
STAGE_DESCS = 512
STAGE_ANCHORS = BLOCK_ITEMS // DESC_ANCHOR_STRIDE + 2

#: the items kernel's staging capacity per block: run records (runs of
#: lanes of one pair), and row-buffer words (both rows of each staged
#: run's pair)
STAGE_RUNS = 512
STAGE_WORDS = 4096

#: the packed-CSR sentinel of the JAX package (larger than any entry, so a
#: padded row tail stays sorted and unmatchable); the CUDA searches take
#: explicit row bounds and never read past a row, so nothing is padded
PACKED_PAD = 2**31 - 1

#: output words: hist64, inter-asym, inter-mut, kept
OUT_WORDS = 67

#: most windows one megastep launch takes (the grid's y extent)
MAX_BATCH_ROWS = 65535

#: ``keep_mode`` codes of ``census_fused_desc_launch`` (lane 2's
#: plan-time pruning predicate)
_KEEP_ALL, _KEEP_NOT_SELF, _KEEP_DEGREE = 1, 2, 3


def _keep_mode(orient: str, prune_self: bool) -> int:
    if orient == "degree":
        return _KEEP_DEGREE
    if orient != "none":
        raise ValueError(f"unknown orient mode {orient!r}")
    return _KEEP_NOT_SELF if prune_self else _KEEP_ALL


def _graph_pointers(what: str, indptr, packed, pair_u, pair_v, pair_code):
    """Validate the graph arrays (CUDA, int32, contiguous, consistent
    pair lengths); return their device and data pointers."""
    if not isinstance(packed, torch.Tensor) or packed.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors")
    device = packed.device
    ptrs = [build.require_vector("indptr", indptr, device),
            build.require_vector("packed", packed, device),
            build.require_vector("pair_u", pair_u, device)]
    num_pairs = pair_u.shape[0]
    ptrs += [build.require_vector("pair_v", pair_v, device, num_pairs),
             build.require_vector("pair_code", pair_code, device,
                                  num_pairs)]
    return device, ptrs


class TileRanges(NamedTuple):
    """How ``census_fused_desc`` splits a launch's lanes."""

    lo: torch.Tensor          #: per tile: first staged descriptor
    hi: torch.Tensor          #: per tile: one past the last
    staged: torch.Tensor      #: per tile: staged, with its lane table
    live: torch.Tensor        #: per tile: it holds a valid lane
    from_stage: torch.Tensor  #: per lane: valid and resolved from its
    #                           tile's stage (else from global memory)


def tile_desc_ranges(anchors, desc_cum, num_valid, idx) -> TileRanges:
    """The rule by which ``census_fused_desc`` stages descriptors.

    A valid lane ``i`` (``0 <= i < num_valid``) searches descriptors
    ``[anchors[a], min(anchors[a] + 17, num_descs))`` with ``a =
    min(i // 16, len(anchors) - 1)`` and lands on one of them or on the
    one before.  Tile ``k`` holds lanes ``[k * BLOCK_ITEMS, (k + 1) *
    BLOCK_ITEMS)``; an in-order ``idx`` puts indices of anchors ``[a0,
    a1]`` there, so the tile stages ``[max(min - 1, 0), min(max + 17,
    num_descs))`` over those anchors' min and max: when that is at most
    ``STAGE_DESCS`` descriptors, the anchors lie in ``[0, num_descs)``,
    and the window is well formed there (``desc_cum`` never falls over
    the range and rises strictly below index ``16 (a1 + 1)``, and each
    anchor ``a`` is the last descriptor starting at or before index
    ``16 a``).  A valid lane with an index in ``[16 a0, 16
    (a1 + 1))`` of a staged tile is resolved from the stage; any other
    lane from global memory.  Works on CPU and CUDA tensors alike.
    """
    n = idx.shape[0]
    tiles = max(1, -(-n // BLOCK_ITEMS))
    device = idx.device
    num_descs = desc_cum.shape[0]
    first = torch.arange(tiles, device=device) * BLOCK_ITEMS
    count = (n - first).clamp(min=1, max=BLOCK_ITEMS)
    last_anchor = anchors.shape[0] - 1
    a0 = (first // DESC_ANCHOR_STRIDE).clamp(max=last_anchor)
    a1 = ((first + count - 1) // DESC_ANCHOR_STRIDE).clamp(max=last_anchor)
    grid = torch.minimum(
        a0[:, None] + torch.arange(STAGE_ANCHORS, device=device),
        a1[:, None])
    an = anchors.long()
    reached = an[grid]
    amin, amax = reached.amin(1), reached.amax(1)
    lo = (amin - 1).clamp(min=0)
    hi = (amax + DESC_ANCHOR_STRIDE + 1).clamp(max=num_descs)
    fits = (amin >= 0) & (amax < num_descs) & (hi - lo <= STAGE_DESCS)
    # well formed: over [lo, hi) desc_cum never falls and rises strictly
    # below the tile's last index (padding repeats DESC_CUM_PAD above it),
    # and every anchor of [a0, a1] is exact
    cum = desc_cum.long()
    end = (a1 + 1) * DESC_ANCHOR_STRIDE
    j = lo[:, None] + 1 + torch.arange(STAGE_DESCS, device=device)
    prev = cum[(j - 1).clamp(max=num_descs - 1)]
    step = cum[j.clamp(max=num_descs - 1)]
    bad = (j < hi[:, None]) & ((step < prev)
                              | ((step == prev) & (prev < end[:, None])))
    rises = ~bad.any(1)
    at = an.clamp(0, num_descs - 1)
    index = torch.arange(an.shape[0], device=device) * DESC_ANCHOR_STRIDE
    after = torch.where(at + 1 < num_descs,
                        cum[(at + 1).clamp(max=num_descs - 1)], index + 1)
    exact = (cum[at] <= index) & ((at + 1 == num_descs) | (after > index))
    inexact = torch.zeros(an.shape[0] + 1, dtype=torch.long, device=device)
    inexact[1:] = torch.cumsum((~exact).long(), 0)
    staged = fits & rises & (inexact[a1 + 1] == inexact[a0])
    lanes = idx.long()
    valid = (lanes >= 0) & (lanes < int(num_valid.reshape(-1)[0]))
    tile = torch.arange(n, device=device) // BLOCK_ITEMS
    from_stage = (valid & staged[tile]
                  & (lanes >= a0[tile] * DESC_ANCHOR_STRIDE)
                  & (lanes < (a1[tile] + 1) * DESC_ANCHOR_STRIDE))
    live = torch.zeros(tiles, dtype=torch.bool, device=device)
    live[tile[valid]] = True
    return TileRanges(lo, hi, staged, live, from_stage)


def _launch_desc(indptr, packed, pair_u, pair_v, pair_code, desc_pair,
                 desc_cum, desc_within0, anchors, num_valid, idx,
                 orient: str, prune_self: bool, probe: bool):
    """Launch ``census_fused_desc`` (or, with ``probe``, its instance
    that also reports the branch each tile and lane took) on CUDA
    tensors; returns the output and, with ``probe``, the int32 tile and
    lane flags."""
    device, ptrs = _graph_pointers("census_fused_desc_kernel", indptr,
                                   packed, pair_u, pair_v, pair_code)
    num_descs = desc_pair.shape[0]
    num_anchors = anchors.shape[0]
    if num_descs < 1 or num_anchors < 1:
        raise ValueError("a descriptor window needs >= 1 descriptor and "
                         ">= 1 anchor")
    ptrs += [
        build.require_vector("desc_pair", desc_pair, device),
        build.require_vector("desc_cum", desc_cum, device, num_descs),
        build.require_vector("desc_within0", desc_within0, device,
                             num_descs),
        build.require_vector("anchors", anchors, device),
        build.require_vector("num_valid", num_valid, device, 1),
        build.require_vector("idx", idx, device),
    ]
    num_items = idx.shape[0]
    keep_mode = _keep_mode(orient, prune_self)
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=device)
    flags = ()
    if probe:
        tiles = max(1, -(-num_items // BLOCK_ITEMS))
        flags = (torch.full((tiles,), -1, dtype=torch.int32, device=device),
                 torch.full((num_items,), -1, dtype=torch.int32,
                            device=device))
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        entry = (lib.census_fused_desc_probe_launch if probe
                 else lib.census_fused_desc_launch)
        err = entry(*ptrs, num_items, num_descs, num_anchors, keep_mode,
                    out.data_ptr(), *(f.data_ptr() for f in flags), stream)
    build.check(lib, err, "census_fused_desc")
    return out, *flags


def census_fused_desc_kernel(indptr, packed, pair_u, pair_v, pair_code,
                             desc_pair, desc_cum, desc_within0, anchors,
                             num_valid, idx, orient: str,
                             prune_self: bool) -> torch.Tensor:
    """Launch the device-emission kernel on CUDA tensors.

    Returns the zero-initialised-then-accumulated ``int32[67]`` output:
    ``hist64`` then lanes [inter-asym, inter-mut, kept].  Launches on the
    current stream and does not synchronise.
    """
    return _launch_desc(indptr, packed, pair_u, pair_v, pair_code,
                        desc_pair, desc_cum, desc_within0, anchors,
                        num_valid, idx, orient, prune_self, probe=False)[0]


def census_fused_desc_batch_kernel(indptr, packed, pair_u, pair_v,
                                   pair_code, words_batch, idx, orient: str,
                                   prune_self: bool,
                                   real: int | None = None) -> torch.Tensor:
    """Launch the K-window megastep on CUDA tensors: one launch runs
    ``census_fused_desc``'s stage and fold on the first ``real`` rows
    (all ``K`` when None) of the row-major ``(K, words)`` int32
    ``words_batch`` (:meth:`repro_torch.core.planner.DescriptorWindow
    .device_words` rows of one geometry: ``words = 1 + 3 * num_descs +
    num_anchors`` with ``num_anchors = num_desc_anchors(len(idx))``), each
    row expanding the same flat-index array ``idx``.  Rows at or past
    ``real`` are never read: they may hold anything.

    Returns the ``int32 (K, 67)`` output: row y < ``real`` is what
    ``census_fused_desc_kernel`` returns for row y (zero when its word 0
    is 0), and every row past ``real`` is zero.  Launches on the current
    stream and does not synchronise.
    """
    device, ptrs = _graph_pointers("census_fused_desc_batch_kernel", indptr,
                                   packed, pair_u, pair_v, pair_code)
    if (not isinstance(words_batch, torch.Tensor)
            or words_batch.device != device
            or words_batch.dtype != torch.int32 or words_batch.dim() != 2
            or not words_batch.is_contiguous()):
        raise ValueError("words_batch must be a row-major (K, words) int32 "
                         f"tensor on {device}")
    rows, width = words_batch.shape
    num_anchors = num_desc_anchors(idx.shape[0])
    num_descs = (width - 1 - num_anchors) // 3
    if num_descs < 1 or width != 1 + 3 * num_descs + num_anchors:
        raise ValueError(f"a batch row of {width} words is no descriptor "
                         f"window of {num_anchors} anchors")
    if not 1 <= rows <= MAX_BATCH_ROWS:
        raise ValueError(f"a batch holds 1 to {MAX_BATCH_ROWS} windows, "
                         f"got {rows}")
    real = batch_real_rows(rows, real)
    ptrs += [words_batch.data_ptr(), build.require_vector("idx", idx, device)]
    out = torch.empty((rows, OUT_WORDS), dtype=torch.int32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.census_fused_desc_batch_launch(
            *ptrs, real, width, num_descs, num_anchors, idx.shape[0],
            _keep_mode(orient, prune_self), out.data_ptr(), stream)
        build.check(lib, err, "census_fused_desc_batch")
        if real < rows:
            out[real:].zero_()
    return out


def desc_anchors_kernel(desc_cum, out) -> torch.Tensor:
    """Launch ``desc_anchors`` on CUDA tensors: writes the anchor table
    of the window whose padded ``desc_cum`` is given into ``out`` (its
    length is the table's) and returns ``out``.  Launches on the current
    stream and does not synchronise."""
    device = desc_cum.device
    ptrs = (build.require_vector("desc_cum", desc_cum, device),
            build.require_vector("out", out, device))
    num_anchors = out.shape[0]
    # every grid point must lie below the padding, so the search never
    # counts a padding descriptor
    if DESC_ANCHOR_STRIDE * (num_anchors - 1) >= DESC_CUM_PAD:
        raise ValueError(f"{num_anchors} anchors reach past int32 items")
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.desc_anchors_launch(ptrs[0], desc_cum.shape[0], ptrs[1],
                                      num_anchors, stream)
    build.check(lib, err, "desc_anchors")
    return out


def desc_occupancy(device) -> dict:
    """The CUDA ``device``'s SM count and the resident blocks per SM of
    ``census_fused_desc`` and of the megastep (the occupancy calculator's
    answer for their registers and shared memory)."""
    lib = build.load_library()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        build.check(lib, lib.census_fused_desc_occupancy(out),
                    "census_fused_desc_occupancy")
    return dict(sms=out[0], desc_blocks_per_sm=out[1],
                batch_blocks_per_sm=out[2])


class DescProbe(NamedTuple):
    """What ``census_fused_desc`` computed, and which branch it took."""

    out: torch.Tensor          #: int32[67], as ``census_fused_desc_kernel``
    tile_staged: torch.Tensor  #: per tile: it staged its lane table
    lane_staged: torch.Tensor  #: per lane: resolved from its tile's stage


def census_fused_desc_probe(indptr, packed, pair_u, pair_v, pair_code,
                            desc_pair, desc_cum, desc_within0, anchors,
                            num_valid, idx, orient: str,
                            prune_self: bool) -> DescProbe:
    """Run the device-emission kernel's body on CUDA tensors and report,
    from the card, which branch each tile and each lane took.

    A diagnostic beside the main launch (same kernel body, compiled once
    more with the flags written): the tests and the smoke hold its flags
    to :func:`tile_desc_ranges` (``staged`` and ``from_stage``) and its
    output to the plain version.  Not a launch of the wrapper in
    :mod:`repro_torch.kernels.ops`, and not counted as one.  Synchronises.
    """
    out, tiles, lanes = _launch_desc(
        indptr, packed, pair_u, pair_v, pair_code, desc_pair, desc_cum,
        desc_within0, anchors, num_valid, idx, orient, prune_self,
        probe=True)
    if bool((tiles < 0).any()) or bool((lanes < 0).any()):
        raise RuntimeError("census_fused_desc probe left flags unwritten")
    return DescProbe(out, tiles == 1, lanes == 1)


class ItemStage(NamedTuple):
    """How ``census_fused_items`` splits a launch's lanes."""

    runs: torch.Tensor        #: per tile: runs of valid lanes of one pair
    staged: torch.Tensor      #: per tile: its runs were recorded
    staged_runs: torch.Tensor  #: per tile: runs whose rows it staged
    words: torch.Tensor       #: per tile: row-buffer words it filled
    live: torch.Tensor        #: per tile: it holds a valid lane
    from_stage: torch.Tensor  #: per lane: valid and resolved from its
    #                           tile's staged rows (else from global memory)


def tile_item_stage(item_pv, indptr, pair_u, pair_v) -> ItemStage:
    """The rule by which ``census_fused_items`` stages rows.

    Tile ``k`` holds lanes ``[k * BLOCK_ITEMS, (k + 1) * BLOCK_ITEMS)``.
    A lane is valid when its ``item_pv`` word has the valid bit; a run
    starts at each valid lane whose pair (``item_pv >> 1``) differs from
    the previous valid lane's in the tile.  A tile of at most
    ``STAGE_RUNS`` runs records them all; in run order, each run's pair
    ``(u, v)`` needs ``len = deg(u) + deg(v)`` words for both rows, and
    a run is staged when ``0 < len <= STAGE_WORDS`` (it fits alone) and
    it ends within ``STAGE_WORDS`` at the running sum of the lengths of
    the earlier runs that fit alone.  A valid lane of a staged run is
    resolved from the stage; any other valid lane from global memory.
    Works on CPU and CUDA tensors alike.
    """
    n = item_pv.shape[0]
    tiles = max(1, -(-n // BLOCK_ITEMS))
    device = item_pv.device
    pv = item_pv.long()
    valid = (pv & 1) == 1
    lane_tile = torch.arange(n, device=device) // BLOCK_ITEMS
    at = torch.nonzero(valid).reshape(-1)
    pair, tile = pv[at] >> 1, lane_tile[at]
    head = torch.ones(at.shape[0], dtype=torch.bool, device=device)
    head[1:] = (pair[1:] != pair[:-1]) | (tile[1:] != tile[:-1])
    runs = torch.zeros(tiles, dtype=torch.long, device=device)
    runs.index_add_(0, tile, head.long())
    staged = runs <= STAGE_RUNS
    # per run, in order: its tile, pair and row words
    run_tile, run_pair = tile[head], pair[head]
    deg = (indptr[1:] - indptr[:-1]).long()
    length = deg[pair_u[run_pair].long()] + deg[pair_v[run_pair].long()]
    fits = (length > 0) & (length <= STAGE_WORDS)
    fit_len = torch.where(fits, length, 0)
    incl = torch.cumsum(fit_len, 0)
    tile_start = torch.zeros(tiles + 1, dtype=torch.long, device=device)
    tile_start[1:] = torch.cumsum(
        torch.zeros(tiles, dtype=torch.long, device=device).index_add_(
            0, run_tile, fit_len), 0)
    off = incl - fit_len - tile_start[run_tile]
    run_staged = staged[run_tile] & fits & (off + length <= STAGE_WORDS)
    staged_runs = torch.zeros(tiles, dtype=torch.long, device=device)
    staged_runs.index_add_(0, run_tile, run_staged.long())
    words = torch.zeros(tiles, dtype=torch.long, device=device)
    words.index_add_(0, run_tile, torch.where(run_staged, length, 0))
    run_of = torch.cumsum(head.long(), 0) - 1
    from_stage = torch.zeros(n, dtype=torch.bool, device=device)
    from_stage[at] = run_staged[run_of]
    live = torch.zeros(tiles, dtype=torch.bool, device=device)
    live[tile] = True
    return ItemStage(runs, staged, staged_runs, words, live, from_stage)


def _launch_items(indptr, packed, pair_u, pair_v, pair_code, item_sp,
                  item_pv, probe: bool):
    """Launch ``census_fused_items`` (or, with ``probe``, its instance
    that also reports the branch each tile and lane took, and when) on
    CUDA tensors; returns the output and, with ``probe``, the int32 tile
    and lane flags and the int64 (tiles, 4) clocks."""
    device, ptrs = _graph_pointers("census_fused_kernel", indptr, packed,
                                   pair_u, pair_v, pair_code)
    num_items = item_sp.shape[0]
    ptrs += [
        build.require_vector("item_sp", item_sp, device),
        build.require_vector("item_pv", item_pv, device, num_items),
    ]
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=device)
    flags = ()
    if probe:
        tiles = max(1, -(-num_items // BLOCK_ITEMS))
        flags = (torch.full((tiles,), -1, dtype=torch.int32, device=device),
                 torch.full((num_items,), -1, dtype=torch.int32,
                            device=device),
                 torch.full((tiles, 4), -1, dtype=torch.int64,
                            device=device))
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        entry = (lib.census_fused_items_probe_launch if probe
                 else lib.census_fused_items_launch)
        err = entry(*ptrs, num_items, out.data_ptr(),
                    *(f.data_ptr() for f in flags), stream)
    build.check(lib, err, "census_fused_items")
    return out, *flags


def census_fused_kernel(indptr, packed, pair_u, pair_v, pair_code,
                        item_sp, item_pv) -> torch.Tensor:
    """Launch the host-emission kernel on CUDA tensors.

    Returns the ``int32[67]`` output: ``hist64`` then lanes [inter-asym,
    inter-mut, 0].  Zero item words are padding.  Launches on the current
    stream and does not synchronise.
    """
    return _launch_items(indptr, packed, pair_u, pair_v, pair_code,
                         item_sp, item_pv, probe=False)[0]


class ItemsProbe(NamedTuple):
    """What ``census_fused_items`` computed, which branch it took, and
    where each tile's time went."""

    out: torch.Tensor          #: int32[67], as ``census_fused_kernel``
    tile_staged: torch.Tensor  #: per tile: it recorded its runs
    lane_staged: torch.Tensor  #: per lane: resolved from staged rows
    cycles: torch.Tensor       #: per tile, SM clock cycles: (runs and
    #                            records, rows staged, lanes classified)


def census_fused_items_probe(indptr, packed, pair_u, pair_v, pair_code,
                             item_sp, item_pv) -> ItemsProbe:
    """Run the host-emission kernel's body on CUDA tensors and report,
    from the card, which branch each tile and each lane took, and how
    many SM clock cycles each tile spent in each phase (the probe's own
    flag writes included).

    A diagnostic beside the main launch, as :func:`census_fused_desc_probe`
    is: the tests and the smoke hold its flags to :func:`tile_item_stage`
    (``staged`` and ``from_stage``) and its output to the plain version.
    Not counted as a launch of the wrapper.  Synchronises.
    """
    out, tiles, lanes, clocks = _launch_items(
        indptr, packed, pair_u, pair_v, pair_code, item_sp, item_pv,
        probe=True)
    if bool((tiles < 0).any()) or bool((lanes < 0).any()) \
            or bool((clocks < 0).any()):
        raise RuntimeError("census_fused_items probe left flags unwritten")
    return ItemsProbe(out, tiles == 1, lanes == 1, clocks.diff(dim=1))
