#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the triad census on one GPU.

    python3 chip_smoke.py              # on a machine with a CUDA card

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(``nvcc``, into ``build/`` at first use), then:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the kernel build time;
2. holds every kernel against its plain torch version on the card, at the
   shapes of the main path (the first descriptor window of a
   patents-sized graph; for ``pair_codes``, tiles of that window's row
   pairs, and random tiles of the same shape where most queries hit
   repeated keys), bit for bit (``torch.equal``), and times kernel,
   plain version and — where one PyTorch call computes the same function
   — that library call, by CUDA events with the L2 flushed before each
   call (and the kernel once more with the L2 warm); the desc kernel
   also at the first window of the hub graph of step 4 and at a
   session-style subset window (the affected pairs of a seeded
   16,500-arc citation delta on the unedited patents-size graph), each
   with the share of its tiles and lanes on the staged branch, as the
   kernel's probe instance reports them from the card and held to the
   staging rule ``tile_desc_ranges``; the host-item kernel at the same
   three windows as host items (the subset window's pairs in a session's
   order), each with its staged tiles, runs and lanes and its tiles'
   clock cycles per phase from its probe instance, held to
   ``tile_item_stage``; the histogram with the device operations its
   timed call holds (from a trace) and how skewed its bins are;
3. runs the main path at real size: ``CensusEngine(backend="fused")
   .run(g, max_items=2**24)`` with device emission on a graph the size of
   the US-patents citation graph (3,774,768 nodes, ~15.5M arcs), for both
   orient modes, under ``torch.profiler``, and holds each census to the
   plain torch engine on the card and to C(n, 3); the desc kernel must
   launch once per window, by its counter and in the trace, which also
   gives the host ranges, the kernel time and the device's idle share;
4. runs a hub-heavy graph (Orkut-like, max degree ~28k) the same way;
5. opens a resident session on the patents-size graph
   (``CensusEngine(backend="fused").session(g, max_items=2**24)``), holds
   its census to the main path's, and applies three seeded citation-stream
   deltas (k = 1,000, 16,500 and 165,000 arcs deleted and as many added);
   each updated census must equal a from-scratch fused census of the
   edited graph and sum to C(n, 3), the first also a plain torch session
   on the card, and each update must launch the desc kernel once per
   dispatch; the first delta is repeated with ``orient="degree"``;
6. runs the patents-size graph over four logical devices on the card
   (``default_devices(4)``: four streams): partitioned 1D async with
   megasteps of up to 8 windows for both orients, 1D lock-step, 2D
   (2, 2) async, and replicated over 2 devices; each census held to the
   single-device fused census of step 3 and to C(n, 3), the megastep's
   launches to the async runs' dispatches and the single-window
   kernel's to the lock-step windows; the first async run traced for
   the device's idle share and for kernels of different streams running
   at once (the kernel phase also times the megastep at 8 shard windows
   against 8 single launches, and window 0 of the 4 shards on their 4
   streams against one stream);
7. on the same graph and four logical devices, fault tolerance and the
   sessions of a multi-device engine: a seeded faulty 1D async run
   (producer error, dispatch error, a poisoned dispatch, one lane
   retired) held to the single-device census, with its retries,
   failovers and launches beside the fault-free wall; a checkpointed
   run stopped half way, its journal compacted, and resumed to the same
   census; a ``PartitionedEngineSession`` (census, then the first two
   deltas of step 5), a ``PartitionedEngineSession2D`` (2, 2) update
   from the 1D session's checkpointed census, and a replicated session
   over 2 lanes, each held to step 5's from-scratch censuses;
8. runs the temporal monitor (``TriadMonitor``) at full width on the
   monitor-backbone stream (2,000,000 hosts: a 3M-arc service backbone
   in every 4M-edge window, 1 slot in 50 an ephemeral peer flow): one
   full window and 8 incremental slides of 200,000 edges under
   fused/device, each window held to a monitor that recounts every
   window from scratch and to C(n, 3), the slides' items at least 2x
   fewer than their ``full_items``; then ``orient="degree"`` for one
   window and 3 slides and the partitioned monitor over
   ``default_devices(4)`` for one window and 1 slide; then the ``network_monitor_torch`` example's scenario under
   fused/device, fused/host, hist and without the pair-space index,
   each equal to the plain torch monitor on the CPU in censuses,
   proportions and alarms, and once more under the example's fault
   plan (a degraded window carried forward, the rest equal);
9. drives the entry point ``pair_codes`` once on (B, 128) tiles cut from
   the patents-size graph (row pairs of window 0);
10. runs the small oracle workloads through every backend × orient × emit
    against the serial Batagelj–Mrvar census, as one-shot runs and as
    sessions over a short delta stream;
11. serves an LM through ``ServeEngine`` (the LM substrate has no
    hand-written kernel: plain torch, bfloat16): qwen2-0.5b at full width
    and depth (seeded random weights on the card; 3 requests of batch 8,
    prompt 512, 64 new tokens, two greedy and one at temperature 0.8),
    printing parameters, prefill and decode times and rates, the decode
    step's weight-read bound, kernel launches per decode step and the
    idle share of a traced request, and holding (a) greedy requests
    repeatable, the prompt echoed, ids below the vocabulary, (b)
    prefill(P) against prefill(P - 1) + one decode step at corr ≥ 0.999,
    (c) the weights cut to 2 layers, card against the CPU path, prefill
    and 8 teacher-forced decode steps at corr ≥ 0.9999 and max
    difference ≤ 0.02 · max logit; then granite-moe-3b-a800m (4 layers;
    (a), dropped tokens in prefill and decode, one MoE layer in float32
    card against CPU), qwen2-vl-2b (2 layers, patch embeddings over a
    quarter of the prompt with M-RoPE positions; (a)-(c)) and
    seamless-m4t-medium (2 + 2 layers; (a), (c), its prefill/decode
    correlation printed, not held), each at full width, batch 4,
    prompt 128, 16 new tokens.

Any mismatch raises, so the exit code is non-zero.  The line before the
last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with an error before any result.

``--rehearse`` runs the same phases on the CPU at toy sizes through the
plain versions (no build, no device numbers) and never prints a result;
it checks the script's own control flow before a run on the card.

Each phase logs the script's elapsed time when it is done.

``--ab A.cu [B.cu ...]`` runs none of the phases: it builds the kernel
library once more for each given version of one of the CUDA sources --
the ``csrc`` file whose name the version's name is or ends with, as in
``build/ab/parent-census_fused.cu`` -- and times each kernel of that file
whose C entry kept its parameters against the package's, in turns, at
the kernel's measured windows (same card, same call), holding every
launch to the plain version bit for bit::

    python3 chip_smoke.py --ab build/ab/parent-census_fused.cu
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks from NVIDIA's data sheet: HBM3 bytes/s, and the int32
#: operation rate of the CUDA cores.  The sheet gives 67 TFLOP/s in
#: float32, counting an FMA as 2 flops (33.5e12 fp32 instructions/s); an
#: H100 SM has 64 int32 lanes beside its 128 fp32 lanes, so int32
#: compares, selects and adds issue at half that: 16.75e12 ops/s
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

#: the main-path graph: US-patents scale (the paper's smallest real graph)
PATENTS = dict(n=3_774_768, avg_degree=4.38, exponent=3.126, mutual_p=0.0,
               preferential=False, seed=0)
#: the hub-heavy graph: paper_workload("orkut", n, avg_degree)
HUB = dict(n=50_000, avg_degree=20.0)
#: the oracle workloads (name -> (n, avg_degree)), as the JAX package's
#: tests/test_census_fused.py SMALL_SIZES
SMALL_SIZES = {"patents": (600, 3.0), "orkut": (250, 12.0),
               "webgraph": (400, 6.0)}
MAX_ITEMS = 2**24
#: arcs deleted and added by each delta of the session phase: ~0.006 %,
#: 0.1 % and 1 % of the patents-size graph's arcs
SESSION_DELTAS = (1_000, 16_500, 165_000)
#: rows of the pair_codes tiles, and rows per plain-version block (its
#: (rows, 128, 128) temporaries)
PAIR_CODE_ROWS = 2**18
PAIR_CODE_BLOCK = 8192
#: seed of the dense pair_codes tiles
PAIR_CODE_SEED = 12
#: clock cycles of the spin kernel queued before each timed call (~1 ms)
SPIN_CYCLES = 2_000_000
#: seed of the citation delta whose first subset window (over the
#: unedited graph's affected pairs) the kernel phase measures
SESSION_WINDOW_SEED = 13


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, device, reps: int, flush=None) -> float:
    """Median milliseconds of one call of ``fn()`` over ``reps`` calls,
    each between two CUDA events (the host clock on the CPU, rehearsal
    only), after one warm-up call.  With ``flush`` (a tensor larger than
    the 50 MB L2) the tensor is overwritten before each call, so ``fn``
    finds its inputs in HBM as each window of the main path does.  A spin
    kernel queued ahead of the first event keeps the card busy while the
    host enqueues the call, so the events hold device time only, not the
    wrapper's host-side checks."""
    import torch
    fn()
    per_call = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if device.type == "cuda":
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            per_call.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            per_call.append((time.perf_counter() - t0) * 1e3)
    per_call.sort()
    return per_call[len(per_call) // 2]


def ceil_log2_plus1(x):
    """ceil(log2(x + 1)) per element: the probes a lower-bound search
    over a range of x candidates makes."""
    import torch
    return torch.ceil(torch.log2(x.to(torch.float64) + 1.0))


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: max(bytes / HBM rate, int32 ops / int32
    rate)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def header(device) -> None:
    import torch
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        log(smi)           # the card's name and power limit, verbatim
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")


def build_kernels() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    seconds = time.perf_counter() - t0
    build.load_library()
    log(f"kernels built in {seconds:.3f} s -> {lib}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return seconds


def graph_tensors(chunker, device):
    import torch
    return tuple(torch.from_numpy(a).to(device)
                 for a in chunker.device_arrays())


def max_abs_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max())
               for a, b in zip(got, want))


def graph_words_read(indptr, pair_u, pair_v, pairs) -> int:
    """int32 words of the resident graph that a window over ``pairs``
    (unique pair ids) must read: each pair's u, v and code; ``indptr`` at
    both ends of both endpoints' rows; and the rows themselves, whose
    entries are the witnesses and hold the searched neighbours."""
    import torch
    pu, pv = pair_u[pairs].long(), pair_v[pairs].long()
    ends = torch.unique(torch.cat([pu, pv]))
    indptr_words = torch.unique(torch.cat([ends, ends + 1])).numel()
    row_words = int((indptr[ends + 1] - indptr[ends]).sum())
    return 3 * pairs.numel() + indptr_words + row_words


class DescCase(NamedTuple):
    """One descriptor window of the desc kernel, on the card."""

    label: str
    graph: tuple          # indptr, packed, pair_u, pair_v, pair_code
    window: tuple         # num_valid, desc_pair, desc_cum, desc_within0,
    #                       anchors (split_device_words order)
    idx: object           # the flat-index array, arange as on the main path
    iters: tuple          # search_iters, desc_iters
    orient: str

    def args(self):
        nv, dp, dc, dw, an = self.window
        return (*self.graph, dp, dc, dw, an, nv, self.idx, *self.iters,
                self.orient, True)


def desc_case(label, chunker, words, device, orient) -> DescCase:
    """The case of one window's ``device_words()`` over ``chunker``'s
    graph arrays."""
    import torch
    from repro_torch.core.planner import split_device_words
    window = split_device_words(torch.from_numpy(words).to(device),
                                chunker.num_anchors)
    return DescCase(label, graph_tensors(chunker, device), window,
                    torch.arange(chunker.chunk_shape, dtype=torch.int32,
                                 device=device),
                    (chunker.space.search_iters, chunker.desc_iters), orient)


class ItemCase(NamedTuple):
    """One window of host-emitted items of the items kernel, on the card."""

    label: str
    graph: tuple          # indptr, packed, pair_u, pair_v, pair_code
    sp: object            # item_sp words
    pv: object            # item_pv words
    search_iters: int
    orient: str

    def args(self):
        return (*self.graph, self.sp, self.pv, self.search_iters)


def item_case(label, chunker, sp, pv, device, orient) -> ItemCase:
    import torch
    return ItemCase(label, graph_tensors(chunker, device),
                    torch.from_numpy(sp).to(device),
                    torch.from_numpy(pv).to(device),
                    chunker.space.search_iters, orient)


def measured_windows(g, hub, device, max_items: int, session_k: int):
    """The kernels' measured windows.  For the desc kernel: window 0 of
    the main graph (orient "none"), window 0 of the hub graph (orient
    "degree"), and a session-style subset window: the first of the
    windows over the main graph's pairs that a ``session_k``-arc citation
    delta (seed ``SESSION_WINDOW_SEED``) touches, as a session's update
    recounts the old graph's affected pairs first.  For the items kernel
    the same three as host items: window 0 of each graph as the chunker
    emits it, and the items of the subset window's pairs in the order a
    session emits them (``emit_items_for_pairs``).  Returns the desc
    cases, the item cases and the main graph's chunker."""
    import repro_torch as rt
    from repro_torch import PlanChunker
    from repro_torch.core.engine import _desc_capacity
    from repro_torch.core.incremental import (affected_pair_ids,
                                              subset_descriptor_windows)
    from repro_torch.core.planner import (emit_items_for_pairs,
                                          max_pairs_per_window, pad_and_pack)
    chunker = PlanChunker(g, max_items)
    hub_chunker = PlanChunker(hub, max_items, orient="degree")
    _, delta = rt.apply_delta(g, *citation_delta(
        g, session_k, np.random.default_rng(SESSION_WINDOW_SEED)))
    space, lanes = chunker.space, chunker.chunk_shape
    session_win = next(subset_descriptor_windows(
        space, affected_pair_ids(space, delta.touched), lanes,
        _desc_capacity(lanes, max_pairs_per_window(space.offsets, lanes)),
        chunker.num_anchors))
    label = f"subset-k{session_k}-w0"
    desc = [
        desc_case("patents-w0", chunker,
                  chunker.descriptors(0).device_words(), device, "none"),
        desc_case("orkut-hub-w0", hub_chunker,
                  hub_chunker.descriptors(0).device_words(), device,
                  "degree"),
        desc_case(label, chunker, session_win.device_words(), device,
                  "none"),
    ]
    first, hub_first = chunker.chunk(0), hub_chunker.chunk(0)
    pair, slot, side = emit_items_for_pairs(
        space, session_win.desc_pair[:session_win.num_descs])
    session_words = pad_and_pack(pair, slot, side,
                                 max(lanes, pair.shape[0]))
    items = [
        item_case("patents-w0", chunker, first.item_sp, first.item_pv,
                  device, "none"),
        item_case("orkut-hub-w0", hub_chunker, hub_first.item_sp,
                  hub_first.item_pv, device, "degree"),
        item_case(label, chunker, *session_words, device, "none"),
    ]
    return desc, items, chunker


def desc_branches(case: DescCase, want) -> tuple:
    """Which branch the desc kernel took on ``case``: on the card, its
    probe instance's per-tile and per-lane flags, held to the staging
    rule ``tile_desc_ranges`` and its output to the plain version's
    ``want``; on the CPU (rehearsal, no kernel) the rule's.  Returns the
    tiles that hold a valid lane, the (tile, lane) flags, and whether the
    flags came from the card."""
    import torch
    from repro_torch.kernels.census_fused import (census_fused_desc_probe,
                                                  tile_desc_ranges)
    nv, dp, dc, dw, an = case.window
    rule = tile_desc_ranges(an, dc, nv, case.idx)
    if case.idx.device.type != "cuda":
        return rule.live, rule.staged, rule.from_stage, False
    probe = census_fused_desc_probe(*case.graph, dp, dc, dw, an, nv,
                                    case.idx, case.orient, True)
    require(torch.equal(probe.out[:64], want[0])
            and torch.equal(probe.out[64:], want[1]),
            f"desc kernel probe != plain version at {case.label}")
    require(torch.equal(probe.tile_staged, rule.staged),
            f"desc kernel staged other tiles than its rule at {case.label}")
    require(torch.equal(probe.lane_staged, rule.from_stage),
            f"desc kernel resolved other lanes from a stage than its rule "
            f"at {case.label}")
    return rule.live, probe.tile_staged, probe.lane_staged, True


def desc_work(case: DescCase, want) -> dict:
    """What a desc-kernel window must do, from its data: the expanded
    items, the bytes and the int32 operations of its bound; and how the
    kernel split its tiles (``desc_branches``)."""
    import torch
    from repro_torch.core import census
    indptr, _, pair_u, pair_v, _ = case.graph
    nv, dp, dc, dw, an = case.window
    idx = case.idx
    pair, slot, side, valid = census.expand_work_items(
        indptr, pair_u, pair_v, dp, dc, dw, an, nv, idx, case.iters[1])
    # per valid lane, the probes of the anchored descriptor search and
    # of the row search
    other = torch.where(side == 0, pair_v[pair], pair_u[pair])
    row_probes = ceil_log2_plus1(indptr[other + 1] - indptr[other])[valid]
    a = (idx // 16).clamp(0, an.shape[0] - 1)
    lo_d = an[a]
    hi_d = (lo_d + 17).clamp(max=dp.shape[0])
    desc_probes = ceil_log2_plus1(hi_d - lo_d)[valid]
    n_valid = int(valid.sum())
    # words read: idx, num_valid, the anchors and the descriptors (one
    # per pair in a window) the valid lanes use, the graph words of the
    # window's pairs; then the 67 output words
    pairs = torch.unique(pair[valid])
    nwords = (idx.numel() + 1 + torch.unique(a[valid]).numel()
              + 3 * pairs.numel()
              + graph_words_read(indptr, pair_u, pair_v, pairs) + 67)
    ops = (float(row_probes.sum()) + float(desc_probes.sum()) + n_valid)
    b, by = bound_ms(4 * nwords, ops)
    live, tile_staged, lane_staged, on_card = desc_branches(case, want)
    return dict(items=(pair, slot, side, valid), bound_ms=b, bound_by=by,
                bound_bytes=4 * nwords, bound_ops=ops, lanes=idx.numel(),
                valid_lanes=n_valid, tiles=int(live.sum()),
                staged_tiles=int((live & tile_staged).sum()),
                staged_lanes=int(lane_staged.sum()),
                branches_from=("the card" if on_card
                               else "the rule (no kernel)"))


def item_branches(case: ItemCase, want) -> dict:
    """Which branch the items kernel took on ``case``: on the card, its
    probe instance's per-tile and per-lane flags, held to the staging
    rule ``tile_item_stage`` and its output to the plain version's
    ``want``; on the CPU (rehearsal, no kernel) the rule's."""
    import torch
    from repro_torch.kernels.census_fused import (census_fused_items_probe,
                                                  tile_item_stage)
    indptr, _, pair_u, pair_v, _ = case.graph
    rule = tile_item_stage(case.pv, indptr, pair_u, pair_v)
    tile_staged, lane_staged = rule.staged, rule.from_stage
    on_card = case.pv.device.type == "cuda"
    cycles = None
    if on_card:
        probe = census_fused_items_probe(*case.graph, case.sp, case.pv)
        require(torch.equal(probe.out[:64], want[0])
                and torch.equal(probe.out[64:66], want[1]),
                f"items kernel probe != plain version at {case.label}")
        require(torch.equal(probe.tile_staged, rule.staged),
                f"items kernel staged other tiles than its rule at "
                f"{case.label}")
        require(torch.equal(probe.lane_staged, rule.from_stage),
                f"items kernel resolved other lanes from staged rows than "
                f"its rule at {case.label}")
        tile_staged, lane_staged = probe.tile_staged, probe.lane_staged
        # mean SM clock cycles of a tile holding a valid lane, per phase
        cycles = [float(x) for x in
                  probe.cycles[rule.live].double().mean(0).tolist()]
    return dict(tiles=int(rule.live.sum()),
                staged_tiles=int((rule.live & tile_staged).sum()),
                runs=int(rule.runs.sum()),
                staged_runs=int(rule.staged_runs.sum()),
                staged_words=int(rule.words.sum()),
                staged_lanes=int(lane_staged.sum()), tile_cycles=cycles,
                branches_from=("the card" if on_card
                               else "the rule (no kernel)"))


def items_work(case: ItemCase, want) -> dict:
    """What a window of host items must do, from its data: the bytes and
    the int32 operations of its bound; and how the kernel split its
    tiles (``item_branches``)."""
    import torch
    indptr, _, pair_u, pair_v, _ = case.graph
    side, pair = case.sp & 1, case.pv >> 1
    valid = (case.pv & 1) == 1
    other = torch.where(side == 0, pair_v[pair], pair_u[pair])
    probes = float(ceil_log2_plus1(indptr[other + 1] - indptr[other])[
        valid].sum())
    n_items = int(valid.sum())
    # words read: every item_pv word, item_sp of the valid items, the
    # graph words of their pairs; then the 67 output words
    nwords = (case.pv.numel() + n_items + graph_words_read(
        indptr, pair_u, pair_v, torch.unique(pair[valid])) + 67)
    b, by = bound_ms(4 * nwords, probes + n_items)
    return dict(bound_ms=b, bound_by=by, bound_bytes=4 * nwords,
                lanes=case.pv.numel(), valid_lanes=n_items,
                **item_branches(case, want))


def device_ops(fn, device) -> list[str]:
    """The device operations (kernels, memsets, copies) of one call of
    ``fn``, in order, from a ``torch.profiler`` trace; none on the CPU."""
    import torch
    from torch.autograd import DeviceType
    if device.type != "cuda":
        return []
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]


def kernel_phase(g, hub, part, device, max_items: int, session_k: int,
                 reps: int) -> list[dict]:
    """Each kernel against its plain version at main-path shapes: the
    first descriptor window of the main graph (orient "none"); the desc
    kernel also at a hub-graph window and a session-update window, and
    its megastep entry at a batch of 8 shard windows of ``part``."""
    import torch
    from repro_torch.core import census
    from repro_torch.kernels import ops

    cases, item_cases, chunker = measured_windows(g, hub, device, max_items,
                                                  session_k)
    space = chunker.space
    graph = cases[0].graph
    iters = cases[0].iters
    lanes = chunker.chunk_shape
    # overwritten before each cold launch: 128 MB, past the 50 MB L2
    flush = torch.empty(2**25 if device.type == "cuda" else 1,
                        dtype=torch.int32, device=device)
    log(f"kernel shapes: window 0 of {chunker.num_chunks}, lanes {lanes}, "
        f"desc_shape {chunker.desc_shape}, anchors {chunker.num_anchors}, "
        f"search_iters {space.search_iters}")
    records = []

    def timings(kernel, plain, library=None) -> dict:
        """Kernel, plain and library ms with L2 flushed before each call
        (the main path's case), and the kernel's warm-L2 ms."""
        return dict(
            ms=timed_ms(kernel, device, reps, flush),
            plain_ms=timed_ms(plain, device, max(3, reps // 10), flush),
            library_ms=(None if library is None
                        else timed_ms(library, device, reps, flush)),
            warm_ms=timed_ms(kernel, device, reps))

    # 1. fused desc kernel (the main path's kernel), at each window
    windows = []
    for case in cases:
        def desc_kernel(case=case):
            return ops.fused_census_desc_partials(*case.args())

        def desc_plain(case=case):
            return ops.fused_census_desc_partials_ref(*case.args())

        got, want = desc_kernel(), desc_plain()
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"fused desc kernel != plain version at {case.label}: "
                f"{got} vs {want}")
        work = desc_work(case, want)
        windows.append(dict(
            window=case.label, orient=case.orient,
            max_abs_err=max_abs_err(got, want),
            **timings(desc_kernel, desc_plain),
            **{k: v for k, v in work.items() if k != "items"}))
        if case is cases[0]:
            pair, slot, side, valid = work["items"]
    for w in windows:
        log(f"kernel fused_census_desc_partials at {w['window']} (orient "
            f"{w['orient']}): ms {w['ms']:.4f} (L2 flushed) warm_ms "
            f"{w['warm_ms']:.4f} plain_ms {w['plain_ms']:.4f} bound_ms "
            f"{w['bound_ms']:.4f} ({w['bound_by']}, {w['bound_bytes']} "
            f"bytes) lanes {w['lanes']} valid {w['valid_lanes']}; staged "
            f"tiles {w['staged_tiles']} of {w['tiles']} "
            f"({w['staged_tiles'] / max(w['tiles'], 1):.4%}), valid lanes "
            f"resolved from a stage {w['staged_lanes']} "
            f"({w['staged_lanes'] / max(w['valid_lanes'], 1):.4%}), as "
            f"{w['branches_from']} reports")
    head = windows[0]
    records.append(dict(
        name="fused_census_desc_partials", route="cuda",
        source="src/repro_torch/kernels/csrc/census_fused.cu",
        replaces="src/repro/kernels/census_fused.py:187", launches=0,
        max_abs_err=max(w["max_abs_err"] for w in windows),
        **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "warm_ms",
                                "bound_ms", "bound_by", "bound_bytes",
                                "lanes", "valid_lanes")},
        windows=[{k: v for k, v in w.items() if k != "bound_ops"}
                 for w in windows],
        batch=batch_record(part, max_items, device, reps, flush, timings)))

    # 2. fused host-item kernel, at the same three windows as host items
    item_windows = []
    for case in item_cases:
        def items_kernel(case=case):
            return ops.fused_census_partials(*case.args())

        def items_plain(case=case):
            return ops.fused_census_partials_ref(*case.args())

        got, want = items_kernel(), items_plain()
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"fused item kernel != plain version at {case.label}: "
                f"{got} vs {want}")
        item_windows.append(dict(
            window=case.label, orient=case.orient,
            max_abs_err=max_abs_err(got, want),
            **timings(items_kernel, items_plain), **items_work(case, want)))
    for w in item_windows:
        log(f"kernel fused_census_partials at {w['window']} (orient "
            f"{w['orient']}): ms {w['ms']:.4f} (L2 flushed) warm_ms "
            f"{w['warm_ms']:.4f} plain_ms {w['plain_ms']:.4f} bound_ms "
            f"{w['bound_ms']:.4f} ({w['bound_by']}, {w['bound_bytes']} "
            f"bytes) lanes {w['lanes']} valid {w['valid_lanes']}; staged "
            f"tiles {w['staged_tiles']} of {w['tiles']} "
            f"({w['staged_tiles'] / max(w['tiles'], 1):.4%}), runs with "
            f"staged rows {w['staged_runs']} of {w['runs']} "
            f"({w['staged_runs'] / max(w['runs'], 1):.4%}, by the rule), "
            f"valid lanes resolved from staged rows {w['staged_lanes']} "
            f"({w['staged_lanes'] / max(w['valid_lanes'], 1):.4%}), as "
            f"{w['branches_from']} reports; mean SM cycles of a tile: "
            + ("not measured" if w["tile_cycles"] is None else
               "runs and records {:.0f}, rows {:.0f}, lanes {:.0f} (probe "
               "instance)".format(*w["tile_cycles"])))
    head = item_windows[0]
    records.append(dict(
        name="fused_census_partials", route="cuda",
        source="src/repro_torch/kernels/csrc/census_fused.cu",
        replaces="src/repro/kernels/census_fused.py:150", launches=0,
        max_abs_err=max(w["max_abs_err"] for w in item_windows),
        **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "warm_ms",
                                "bound_ms", "bound_by", "bound_bytes",
                                "lanes", "valid_lanes")},
        windows=item_windows))

    # 3. histogram kernel, on window 0's classified tricodes
    tricode, count_mask, _, _ = census.classify_items(
        *graph, pair, slot, side, valid, iters[0])
    tricode = tricode.contiguous()

    def hist_kernel():
        return ops.tricode_histogram(tricode, count_mask)

    def hist_plain():
        return ops.tricode_histogram_ref(
            torch.where(count_mask, tricode, 64))

    def hist_library():
        return torch.bincount(torch.where(count_mask, tricode, 64),
                              minlength=65)[:64]

    got, want, lib = hist_kernel(), hist_plain(), hist_library()
    err = max_abs_err([got], [want])
    require(torch.equal(got, want), "histogram kernel != plain version")
    require(torch.equal(got.long(), lib), "histogram kernel != bincount")
    w = tricode.numel()
    b, by = bound_ms(5 * w + 4 * 64, w)
    records.append(dict(
        name="tricode_histogram", route="cuda",
        source="src/repro_torch/kernels/csrc/tricode_hist.cu",
        replaces="src/repro/kernels/tricode_hist.py:41",
        launches=0, max_abs_err=err,
        **timings(hist_kernel, hist_plain, hist_library),
        bound_ms=b, bound_by=by, bound_bytes=5 * w + 4 * 64,
        lanes=w, valid_lanes=int(count_mask.sum()),
        nonzero_bins=int((got > 0).sum()), top_bin=int(got.argmax()),
        top_bin_share=int(got.max()) / max(int(got.sum()), 1),
        call_ops=device_ops(hist_kernel, device)))
    h = records[-1]
    log(f"kernel tricode_histogram: codes {tricode.dtype}, mask "
        f"{count_mask.dtype}; the timed call ops.tricode_histogram holds "
        f"{len(h['call_ops'])} device operations {h['call_ops']} (one "
        f"traced call); {h['valid_lanes']} of {w} items counted into "
        f"{h['nonzero_bins']} non-zero bins, top bin {h['top_bin']} with "
        f"{h['top_bin_share']:.4%} of them")
    # 4. pair_codes, on tiles of window 0's row pairs, and at the same B on
    # random tiles where most queries hit: keys repeat within a row and
    # fill all 128 lanes, and full-range codes make the sums wrap
    q, k, kc = (torch.from_numpy(t).to(device)
                for t in pair_code_tiles(g, chunker, PAIR_CODE_ROWS))
    rows = q.shape[0]
    gen = torch.Generator(device=device).manual_seed(PAIR_CODE_SEED)
    dense = (torch.randint(0, 80, (rows, 128), generator=gen,
                           device=device, dtype=torch.int32),
             torch.randint(0, 64, (rows, 128), generator=gen,
                           device=device, dtype=torch.int32),
             torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=gen,
                           device=device, dtype=torch.int32))

    def codes_kernel():
        return ops.pair_codes(q, k, kc)

    def codes_plain():
        return pair_codes_blocks(q, k, kc)

    got, want = codes_kernel(), codes_plain()
    dense_got, dense_want = ops.pair_codes(*dense), pair_codes_blocks(*dense)
    err = max_abs_err([got, dense_got], [want, dense_want])
    require(torch.equal(got, want), "pair_codes kernel != plain version")
    require(torch.equal(dense_got, dense_want),
            "pair_codes kernel != plain version on the dense tiles")
    hits, dense_hits = pair_code_hits(q, k), pair_code_hits(*dense[:2])
    nbytes = 4 * rows * 128 * 4
    # per (query, key): one compare and one conditional add
    b, by = bound_ms(nbytes, 2 * rows * 128 * 128)
    records.append(dict(
        name="pair_codes", route="cuda",
        source="src/repro_torch/kernels/csrc/pair_codes.cu",
        replaces="src/repro/kernels/pair_codes.py:36",
        launches=0, max_abs_err=err, **timings(codes_kernel, codes_plain),
        bound_ms=b, bound_by=by, bound_bytes=nbytes,
        lanes=rows * 128, valid_lanes=hits, dense_valid_lanes=dense_hits))
    for r in records:
        log(f"kernel {r['name']}: ms {r['ms']:.4f} (L2 flushed) warm_ms "
            f"{r['warm_ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}"
            f", {r['bound_bytes']} bytes) lanes {r['lanes']} valid "
            f"{r['valid_lanes']}")
    log("kernel fused_census_desc_partials, fused_census_partials and "
        "pair_codes have no single PyTorch call that computes the same "
        "function: library_ms null")
    log(f"kernel pair_codes tiles: {rows} row pairs of window 0, "
        f"{hits} of {rows * 128} queries found a key; dense tiles at the "
        f"same B: {dense_hits} found one or more (repeated keys, codes "
        f"that wrap), equal to the plain version")
    return records, (q, k, kc, want)


def lib_launch(entry: str, args, out_words: int, device, split=None):
    """A call of the C entry ``entry`` of a kernel library on device
    tensors ``args`` (pointers) and integer arguments, as the wrappers
    make it; ``run(lib)`` returns the output split as the wrapper
    returns it."""
    import torch
    from repro_torch.kernels import build

    def run(lib):
        out = torch.zeros(out_words, dtype=torch.int32, device=device)
        vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = getattr(lib, entry)(*vals, out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, entry)
        return split(out) if split else (out,)
    return run


def ab_kernels(target: str, g, hub, part, device, max_items: int,
               session_k: int) -> list:
    """The timed calls of the kernels of ``csrc/<target>``: (C entry,
    window label, plain version's output, ``run(lib)``)."""
    import torch
    from repro_torch.core import census
    from repro_torch.kernels import ops
    from repro_torch.kernels.census_fused import OUT_WORDS, _keep_mode
    desc, items, chunker = measured_windows(g, hub, device, max_items,
                                            session_k)
    calls = []
    if target == "census_fused.cu":
        for case in desc:
            nv, dp, dc, dw, an = case.window
            calls.append((
                "census_fused_desc_launch", case.label,
                ops.fused_census_desc_partials_ref(*case.args()),
                lib_launch("census_fused_desc_launch",
                           (*case.graph, dp, dc, dw, an, nv, case.idx,
                            case.idx.numel(), dp.numel(), an.numel(),
                            _keep_mode(case.orient, True)),
                           OUT_WORDS, device, lambda o: (o[:64], o[64:]))))
        batch, cases, sched = shard_batch_case(part, max_items, device, 8)
        case = cases[0]
        calls.append((
            "census_fused_desc_batch_launch", f"shard0-x{len(cases)}",
            tuple(t.reshape(-1) for t in
                  ops.fused_census_desc_partials_batch_ref(
                      *case.graph, batch, case.idx, *case.iters, "none",
                      True)),
            lib_launch("census_fused_desc_batch_launch",
                       (*case.graph, batch, case.idx, batch.shape[0],
                        batch.shape[1], sched.desc_shape, sched.num_anchors,
                        case.idx.numel(), _keep_mode("none", True)),
                       OUT_WORDS * batch.shape[0], device,
                       lambda o: (o.reshape(-1, OUT_WORDS)[:, :64]
                                  .reshape(-1),
                                  o.reshape(-1, OUT_WORDS)[:, 64:]
                                  .reshape(-1)))))
        for case in items:
            calls.append((
                "census_fused_items_launch", case.label,
                ops.fused_census_partials_ref(*case.args()),
                lib_launch("census_fused_items_launch",
                           (*case.graph, case.sp, case.pv, case.sp.numel()),
                           OUT_WORDS, device, lambda o: (o[:64], o[64:66]))))
    elif target == "tricode_hist.cu":
        case = desc[0]
        nv, dp, dc, dw, an = case.window
        indptr, _, pair_u, pair_v, _ = case.graph
        expanded = census.expand_work_items(
            indptr, pair_u, pair_v, dp, dc, dw, an, nv, case.idx,
            case.iters[1])
        tricode, mask, _, _ = census.classify_items(
            *case.graph, *expanded, case.iters[0])
        tricode = tricode.to(torch.int32).contiguous()
        calls.append((
            "tricode_hist_launch", case.label,
            (ops.tricode_histogram_ref(torch.where(mask, tricode, 64)),),
            lib_launch("tricode_hist_launch",
                       (tricode, mask, tricode.numel()), 64, device)))
    elif target == "pair_codes.cu":
        q, k, kc = (torch.from_numpy(t).to(device)
                    for t in pair_code_tiles(g, chunker, PAIR_CODE_ROWS))
        calls.append((
            "pair_codes_launch", "patents-w0",
            (pair_codes_blocks(q, k, kc).reshape(-1),),
            lib_launch("pair_codes_launch", (q, k, kc, q.shape[0]),
                       q.numel(), device)))
    return calls


def c_entry_arity(source: Path) -> dict:
    """Each ``extern "C"`` function of a kernel source: name -> its
    parameter count."""
    import re
    text = source.read_text()
    text = text[text.index('extern "C" {'):]
    return {name: len(params.split(",")) for name, params in re.findall(
        r"^(?:int|const char\*) (\w+)\(([^)]*)\)", text, re.M)}


def ab_phase(g, hub, part, device, max_items: int, session_k: int,
             sources, reps: int) -> None:
    """Time the kernels of other versions of the package's CUDA sources
    against the package's own, in turns -- the package's, each version,
    each version again in reverse order, the package's -- with the L2
    flushed and warm.  A version replaces the ``csrc`` file whose name
    its own name is or ends with (``census_fused.cu``,
    ``parent-census_fused.cu``); every kernel of that file whose C entry
    kept its parameter count is timed at its measured windows (the desc
    and the items kernel at three each), and every launch is held to the
    plain version bit for bit.  Prints one line per turn, then the mean
    of each library's turns per kernel and window as one JSON object."""
    import torch
    from repro_torch.kernels import build
    package = {s.name: s for s in build.SOURCES}
    targets = {}
    for src in sources:
        names = [n for n in package if src.name == n
                 or src.name.endswith("-" + n)]
        if not names:
            raise SystemExit(f"--ab {src}: its name is none of, and ends "
                             f"in '-' and none of, {sorted(package)}")
        targets[str(src)] = names[0]
    libs = {"package": build.SOURCES}
    for src in sources:
        libs[str(src)] = tuple(src.resolve() if s.name == targets[str(src)]
                               else s for s in build.SOURCES)
    for name, srcs in libs.items():
        log_ptxas(name, build.build(srcs).parent / "build.log")
    flush = torch.empty(2**25, dtype=torch.int32, device=device)
    turns = []
    for target in sorted(set(targets.values())):
        names = [n for n, t in targets.items() if t == target]
        mine = c_entry_arity(package[target])
        for entry, label, want, run in ab_kernels(
                target, g, hub, part, device, max_items, session_k):
            kept = [n for n in names
                    if c_entry_arity(Path(n)).get(entry) == mine[entry]]
            for n in sorted(set(names) - set(kept)):
                log(f"ab {n}: {entry} has another C interface; not timed")
            order = ["package", *kept, *reversed(kept), "package"]
            for turn, name in enumerate(order):
                lib = build.load_library(libs[name])
                got = run(lib)
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"{name} {entry} != plain at {label}")
                row = dict(entry=entry, window=label, lib=name, turn=turn,
                           ms=timed_ms(lambda: run(lib), device, reps,
                                       flush),
                           warm_ms=timed_ms(lambda: run(lib), device, reps))
                turns.append(row)
                log(f"ab {entry} {label} turn {turn} {name}: ms "
                    f"{row['ms']:.4f} (L2 flushed) warm_ms "
                    f"{row['warm_ms']:.4f}; equal")
    summary = []
    for key in dict.fromkeys((t["entry"], t["window"], t["lib"])
                             for t in turns):
        rows = [t for t in turns
                if (t["entry"], t["window"], t["lib"]) == key]
        summary.append(dict(
            entry=key[0], window=key[1], lib=key[2],
            ms=sum(t["ms"] for t in rows) / len(rows),
            warm_ms=sum(t["warm_ms"] for t in rows) / len(rows)))
    print(json.dumps({"ab": summary}))


def log_ptxas(name: str, build_log: Path) -> None:
    """Log ptxas' resource line of every kernel in a build log."""
    current = ""
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line
        elif "Used" in line:
            log(f"ab {name} ptxas {current}: {line.strip()}")


def pair_codes_blocks(q, k, kc):
    """The plain version over blocks of ``PAIR_CODE_BLOCK`` rows (its
    (rows, 128, 128) temporaries would not fit the card at full B)."""
    import torch
    from repro_torch.kernels import ops
    return torch.cat([
        ops.pair_codes_ref(q[i:i + PAIR_CODE_BLOCK],
                           k[i:i + PAIR_CODE_BLOCK],
                           kc[i:i + PAIR_CODE_BLOCK])
        for i in range(0, q.shape[0], PAIR_CODE_BLOCK)])


def pair_code_hits(q, k) -> int:
    """Queries equal to at least one key of their row."""
    return sum(int((q[i:i + PAIR_CODE_BLOCK, :, None]
                    == k[i:i + PAIR_CODE_BLOCK, None, :]).any(2).sum())
               for i in range(0, q.shape[0], PAIR_CODE_BLOCK))


def pair_code_tiles(g, chunker, rows: int):
    """(q, k, kc) int32 (B, 128) tiles of the first ``rows`` canonical
    pairs (u, v) of window 0 whose rows both have <= 128 entries: q is
    N(v) padded with -1, k is N(u) padded with -2, kc is u's direction
    codes (0 in the padding)."""
    win = chunker.descriptors(0)
    space = chunker.space
    ids = win.desc_pair[:win.num_descs].astype(np.int64)
    u, v = space.pair_u[ids], space.pair_v[ids]
    fits = (space.deg[u] <= 128) & (space.deg[v] <= 128)
    u, v = u[fits][:rows], v[fits][:rows]

    def tiles(verts, pad):
        starts = g.indptr[verts]
        deg = g.indptr[verts + 1] - starts
        row = np.repeat(np.arange(verts.shape[0]), deg)
        col = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg,
                                                    deg)
        entry = g.packed[np.repeat(starts, deg) + col]
        ids = np.full((verts.shape[0], 128), pad, dtype=np.int32)
        codes = np.zeros((verts.shape[0], 128), dtype=np.int32)
        ids[row, col] = entry >> 2
        codes[row, col] = entry & 3
        return ids, codes

    q, _ = tiles(v, -1)
    k, kc = tiles(u, -2)
    return q, k, kc


def census_run(g, device, backend: str, orient: str, max_items,
               emit: str = "device"):
    """One engine run; returns (census, stats, wall seconds)."""
    import torch
    from repro_torch import CensusEngine
    engine = CensusEngine(device=device, backend=backend, emit=emit)
    t0 = time.perf_counter()
    census = engine.run(g, max_items=max_items, orient=orient)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return census, engine.stats, time.perf_counter() - t0


def trace_split(prof, device) -> dict:
    """Where a traced run's time went: the engine's host ranges
    (``census.plan``, ``census.window``; seconds), and on the card the
    desc kernel's launches and summed time and the time any device
    activity (kernel, copy, memset) was running (ms, union of spans)."""
    from torch.autograd import DeviceType
    # a range appears twice, as a host event and as its device-side
    # annotation: only the host event is host time, and only kernels,
    # copies and memsets are device activity
    host = {e.key: e.cpu_time_total / 1e6 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and e.key in ("census.plan", "census.partition",
                          "census.window")}
    split = dict(plan_s=host.get("census.plan", 0.0),
                 partition_s=host.get("census.partition", 0.0),
                 window_s=host.get("census.window", 0.0),
                 kernel_launches=0, kernel_ms=None, busy_ms=None)
    if device.type != "cuda":
        return split
    activity = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("census.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in activity)
    kernels = [e for e in activity if "census_fused_desc" in e.name]
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    split.update(kernel_launches=len(kernels),
                 kernel_ms=sum(e.time_range.elapsed_us()
                               for e in kernels) / 1e3,
                 busy_ms=busy_us / 1e3)
    return split


def held_run(label: str, g, device, orient: str, max_items: int,
             w0: int) -> dict:
    """Fused engine run, traced, held to the plain torch engine and to
    C(n, 3); its desc-kernel launches must equal its window count, in the
    wrapper's counter and in the trace."""
    import torch
    from repro_torch.kernels import ops
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = ops.fused_census_desc_partials.launches
    with torch.profiler.profile(activities=activities) as prof:
        census, st, wall = census_run(g, device, "fused", orient, max_items)
    launches = ops.fused_census_desc_partials.launches - before
    expect = st.chunks if device.type == "cuda" else 0
    require(launches == expect,
            f"{label}/{orient}: desc kernel launched {launches} times for "
            f"{st.chunks} windows")
    split = trace_split(prof, device)
    require(split["kernel_launches"] == expect,
            f"{label}/{orient}: the trace holds {split['kernel_launches']} "
            f"desc kernels for {st.chunks} windows")
    ref, _, ref_wall = census_run(g, device, "torch", orient, max_items)
    require((census == ref).all(),
            f"{label}/{orient}: fused {census.tolist()} != torch "
            f"{ref.tolist()}")
    total = g.n * (g.n - 1) * (g.n - 2) // 6
    require(int(census.sum()) == total,
            f"{label}/{orient}: census sums to {int(census.sum())}, "
            f"not C(n,3)={total}")
    log(f"{label} orient={orient}: windows {st.chunks} W0 {w0} items "
        f"{st.items} desc_shape {st.desc_shape} wall {wall:.3f} s "
        f"({w0 / wall:.4g} pre-prune lanes/s, {st.items / wall:.4g} "
        f"items/s) desc launches {launches}; torch engine wall "
        f"{ref_wall:.3f} s; census {census.tolist()}")
    if device.type == "cuda":
        device_part = (
            f"desc kernel {split['kernel_ms']:.4f} ms over "
            f"{split['kernel_launches']} launches "
            f"({split['kernel_ms'] / st.chunks:.4f} ms per window), device "
            f"busy {split['busy_ms']:.4f} ms = "
            f"{split['busy_ms'] / 1e3 / wall:.4%} of the wall, idle "
            f"{1 - split['busy_ms'] / 1e3 / wall:.4%}")
    else:
        device_part = "device not measured"
    log(f"{label} orient={orient} trace: host plan {split['plan_s']:.3f} s, "
        f"host windows {split['window_s']:.3f} s, {device_part}; engine "
        f"wall {wall:.3f} s")
    return dict(graph=label, orient=orient, windows=st.chunks, w0=w0,
                items=st.items, wall_s=wall, torch_wall_s=ref_wall,
                launches=launches, census=census, **split)


def citation_delta(g, k: int, rng):
    """One sliding re-count of a citation stream, as (add_src, add_dst,
    del_src, del_dst): k arcs deleted, sampled from ``g``'s arcs, and k
    added, each from a uniform source to the head of an existing arc
    (cited patents get cited again)."""
    out_arcs = np.flatnonzero(g.packed & 1)     # CSR entries u -> w
    gone = rng.choice(out_arcs, k, replace=False)
    heads = g.packed[rng.choice(out_arcs, k)] >> 2
    tails = np.searchsorted(g.indptr, gone, side="right") - 1
    return (rng.integers(0, g.n, k), heads, tails, g.packed[gone] >> 2)


def session_phase(g, device, max_items: int, census_none, census_degree,
                  ks, seed: int = 0) -> dict:
    """Resident fused sessions on the main graph: census, then one update
    per delta size, each held to a from-scratch fused census of the
    edited graph and to C(n, 3); the first also to a plain torch session
    on the card, and once more with ``orient="degree"``.  Each session
    call must launch the desc kernel once per dispatch.  Returns the
    session's desc-kernel launches and the per-update rows."""
    import torch
    from repro_torch import CensusEngine
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    total = g.n * (g.n - 1) * (g.n - 2) // 6
    rng = np.random.default_rng(seed)
    launches = 0

    def held(label, session, call):
        """Run one session call, timed to the card's completion; its
        desc launches must equal its dispatches."""
        nonlocal launches
        before = ops.fused_census_desc_partials.launches
        t0 = time.perf_counter()
        census = call()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        count = ops.fused_census_desc_partials.launches - before
        require(count == (session.stats.chunks if cuda else 0),
                f"session {label}: desc kernel launched {count} times for "
                f"{session.stats.chunks} dispatches")
        require(int(census.sum()) == total,
                f"session {label}: census sums to {int(census.sum())}")
        launches += count
        return census, wall

    def scratch(graph, orient):
        census, st, wall = census_run(graph, device, "fused", orient,
                                      max_items)
        return census, wall

    t0 = time.perf_counter()
    s = CensusEngine(device=device, backend="fused").session(
        g, orient="none", max_items=max_items)
    open_s = time.perf_counter() - t0
    c0, wall = held("census", s, s.census)
    require((c0 == census_none).all(), "session census != main path")
    log(f"session orient=none: opened in {open_s:.3f} s (chunk_shape "
        f"{s.chunk_shape} desc_shape {s.desc_shape}), census windows "
        f"{s.stats.chunks} items {s.stats.items} wall {wall:.3f} s")
    rows, deltas = [], []
    for k in ks:
        delta = citation_delta(s.graph, k, rng)
        deltas.append(delta)
        got, wall = held(f"update k={k}", s, lambda: s.update(*delta))
        st = s.stats
        want, scratch_wall = scratch(s.graph, "none")
        require((got == want).all(),
                f"session update k={k}: {got.tolist()} != from-scratch "
                f"{want.tolist()}")
        rows.append(dict(k=k, touched=int(s.last_delta.touched.shape[0]),
                         changed_pairs=int(s.last_delta.num_changed),
                         affected_pairs=st.affected_pairs, items=st.items,
                         full_items=st.full_items, chunks=st.chunks,
                         wall_s=wall, host_pair_s=st.host_pair_seconds,
                         host_merge_s=st.host_merge_seconds,
                         host_emit_s=st.host_emit_seconds,
                         scratch_wall_s=scratch_wall, census=got))
        log(f"session update k={k}: touched {rows[-1]['touched']} "
            f"vertices, changed pairs {rows[-1]['changed_pairs']}, "
            f"affected pairs {st.affected_pairs}, items {st.items} of "
            f"full_items {st.full_items} ({st.items / st.full_items:.4%}), "
            f"dispatches {st.chunks}, update wall {wall:.4f} s (host pair "
            f"{st.host_pair_seconds:.4f} s, merge "
            f"{st.host_merge_seconds:.4f} s, emit "
            f"{st.host_emit_seconds:.4f} s); from-scratch fused census "
            f"wall {scratch_wall:.3f} s; equal")
    s.close()

    t = CensusEngine(device=device, backend="torch").session(
        g, orient="none", max_items=max_items)
    require((t.census() == c0).all(), "torch session census != fused")
    got = t.update(*deltas[0])
    require((got == rows[0]["census"]).all(),
            f"torch session update k={ks[0]} != fused session")
    t.close()
    log(f"session update k={ks[0]}: plain torch session on the card equal")

    d = CensusEngine(device=device, backend="fused").session(
        g, orient="degree", max_items=max_items)
    cd, _ = held("census degree", d, d.census)
    require((cd == census_degree).all(),
            "degree session census != main path")
    got, wall = held("update degree", d, lambda: d.update(*deltas[0]))
    st = d.stats
    want, scratch_wall = scratch(d.graph, "degree")
    require((got == want).all(), "degree session update != from-scratch")
    require((got == rows[0]["census"]).all(),
            "degree session update != orient none")
    log(f"session orient=degree update k={ks[0]}: affected pairs "
        f"{st.affected_pairs}, items {st.items} of full_items "
        f"{st.full_items}, dispatches {st.chunks}, update wall "
        f"{wall:.4f} s (host pair {st.host_pair_seconds:.4f} s, merge "
        f"{st.host_merge_seconds:.4f} s, emit {st.host_emit_seconds:.4f} "
        f"s); from-scratch wall {scratch_wall:.3f} s; equal")
    d.close()
    if cuda:
        require(launches > 0, "the session phase launched no desc kernel")
    log(f"session phase: desc launches {launches}")
    return dict(launches=launches, rows=rows, deltas=deltas)


def shard_batch_case(part, max_items: int, device, cap: int):
    """The megastep's measured batch: the first ``cap`` descriptor windows
    of shard 0 of a 1D partition over 4 shards, as one (cap, words) int32
    batch, with shard 0's resident arrays (``stacked_device_arrays`` rows,
    as the engine commits them) and the flat-index array.  Returns the
    batch, the single-window ``DescCase`` of each row and the schedule."""
    import torch
    from repro_torch import ShardSchedule, stacked_device_arrays
    from repro_torch.core.planner import split_device_words
    sched = ShardSchedule([sh.space for sh in part.shards], max_items,
                          len(part.shards))
    graph = tuple(torch.from_numpy(a[0]).to(device)
                  for a in stacked_device_arrays(part.shards))
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=device)
    rows = min(cap, sched.steps_for(0))
    batch = torch.from_numpy(np.stack([
        sched.descriptors(0, j).device_words() for j in range(rows)])
    ).to(device)
    iters = (part.space.search_iters, sched.desc_iters)
    cases = [DescCase(f"shard0-w{j}", graph,
                      split_device_words(batch[j], sched.num_anchors), idx,
                      iters, "none") for j in range(rows)]
    return batch, cases, sched


def batch_record(part, max_items: int, device, reps: int, flush,
                 timings) -> dict:
    """The megastep entry against its plain version and against one
    single-window launch per row of the same batch: one (8, words) launch
    vs 8 launches, L2 flushed and warm.  The bound counts each input once
    over the batch: the index array, each row's valid count, anchors and
    descriptors, and the graph words of the union of the rows' pairs."""
    import torch
    from repro_torch.kernels import ops
    batch, cases, sched = shard_batch_case(part, max_items, device, 8)
    graph, idx = cases[0].graph, cases[0].idx
    args = (*cases[0].iters, "none", True)

    def kernel():
        return ops.fused_census_desc_partials_batch(*graph, batch, idx, *args)

    def plain():
        return ops.fused_census_desc_partials_batch_ref(*graph, batch, idx,
                                                        *args)

    def singles():
        return [ops.fused_census_desc_partials(*c.args()) for c in cases]

    got, want = kernel(), plain()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "megastep kernel != plain version on the shard batch")
    for r, one in enumerate(singles()):
        require(torch.equal(got[0][r], one[0]) and torch.equal(got[1][r],
                                                               one[1]),
                f"megastep row {r} != its single-window launch")
    indptr, _, pair_u, pair_v, _ = graph
    pairs, nwords, nops = [], idx.numel(), 0.0
    for r, case in enumerate(cases):
        work = desc_work(case, (want[0][r], want[1][r]))
        pair, _, _, valid = work["items"]
        nv, dp, dc, dw, an = case.window
        a = (idx // 16).clamp(0, an.shape[0] - 1)
        pairs.append(torch.unique(pair[valid]))
        nwords += 1 + torch.unique(a[valid]).numel() + 3 * pairs[-1].numel()
        nops += work["bound_ops"]
    union = torch.unique(torch.cat(pairs))
    nwords += graph_words_read(indptr, pair_u, pair_v, union) \
        + 67 * len(cases)
    b, by = bound_ms(4 * nwords, nops)
    t = timings(kernel, plain)
    parallel, serial = shard_streams_ms(part, max_items, device, reps, flush)
    rec = dict(
        name="fused_census_desc_partials_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/census_fused.cu",
        replaces="src/repro/kernels/census_fused.py:187", launches=0,
        max_abs_err=max_abs_err(got, want), **t, bound_ms=b, bound_by=by,
        bound_bytes=4 * nwords, windows=len(cases),
        lanes=len(cases) * idx.numel(),
        valid_lanes=sum(int(c.window[0][0]) for c in cases),
        singles_ms=timed_ms(singles, device, reps, flush),
        singles_warm_ms=timed_ms(singles, device, reps),
        words=int(batch.shape[1]), chunk_shape=sched.chunk_shape,
        shards_streams_ms=parallel, shards_one_stream_ms=serial)
    log(f"kernel fused_census_desc_partials_batch: one ({rec['windows']}, "
        f"{rec['words']}) launch over shard 0's first windows "
        f"({sched.chunk_shape} lanes each) ms {rec['ms']:.4f} (L2 flushed)"
        f" warm_ms {rec['warm_ms']:.4f}; {rec['windows']} single-window "
        f"launches ms {rec['singles_ms']:.4f} warm_ms "
        f"{rec['singles_warm_ms']:.4f}; plain_ms {rec['plain_ms']:.4f} "
        f"bound_ms {b:.4f} ({by}, {4 * nwords} bytes); equal to the plain "
        f"version and, row for row, to the single launches")
    log(f"kernel fused_census_desc_partials: window 0 of each of the 4 "
        f"shards, launched back to back on the 4 logical devices' streams "
        f"ms {parallel:.4f} (L2 flushed), on one stream ms {serial:.4f}: "
        f"the kernels of different shard streams "
        + ("overlap on the card" if parallel < 0.9 * serial
           else "do not overlap much on the card"))
    return rec


def shard_streams_ms(part, max_items: int, device, reps: int, flush):
    """Device time of window 0 of each shard of ``part``, one single-window
    launch per shard, each on its logical device's own stream (as the
    partitioned runs launch them) and all on one stream, L2 flushed."""
    import torch
    from repro_torch import ShardSchedule, default_devices
    from repro_torch import stacked_device_arrays
    from repro_torch.core.planner import split_device_words
    from repro_torch.kernels import ops
    sched = ShardSchedule([sh.space for sh in part.shards], max_items,
                          len(part.shards))
    arrays = stacked_device_arrays(part.shards)
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=device)
    iters = (part.space.search_iters, sched.desc_iters)
    cases = [DescCase(
        f"shard{s}-w0", tuple(torch.from_numpy(a[s]).to(device)
                              for a in arrays),
        split_device_words(torch.from_numpy(
            sched.descriptors(s, 0).device_words()).to(device),
            sched.num_anchors), idx, iters, "none")
        for s in range(len(part.shards))]
    def one_stream():
        for c in cases:
            ops.fused_census_desc_partials(*c.args())

    if device.type != "cuda":
        return (timed_ms(one_stream, device, reps),) * 2
    lanes = default_devices(len(cases))

    def on_streams():
        here = torch.cuda.current_stream()
        for ld, c in zip(lanes, cases):
            ld.stream.wait_stream(here)
            with torch.cuda.stream(ld.stream):
                ops.fused_census_desc_partials(*c.args())
        for ld in lanes:
            here.wait_stream(ld.stream)

    return (timed_ms(on_streams, device, reps, flush),
            timed_ms(one_stream, device, reps, flush))


def stream_overlap(prof) -> dict:
    """From a trace: the census kernels' time per device stream, the time
    any ran, and the time kernels of two or more streams ran at once."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "census_fused" in e.name]
    marks = []
    for e in kernels:
        stream = getattr(e, "device_resource_id", e.thread)
        marks += [(e.time_range.start, 1, stream),
                  (e.time_range.end, -1, stream)]
    marks.sort(key=lambda m: (m[0], m[1]))
    active: dict = {}
    busy = both = 0.0
    last = None
    for at, step, stream in marks:
        live = sum(1 for v in active.values() if v > 0)
        if last is not None:
            busy += (at - last) if live else 0.0
            both += (at - last) if live >= 2 else 0.0
        active[stream] = active.get(stream, 0) + step
        last = at
    streams = sorted({getattr(e, "device_resource_id", e.thread)
                      for e in kernels})
    return dict(kernels=len(kernels), streams=len(streams),
                kernel_busy_ms=busy / 1e3, overlap_ms=both / 1e3)


def partitioned_phase(g, device, max_items: int, part_none, part_s: float,
                      census_none, census_degree) -> dict:
    """Partitioned and replicated full runs over 4 logical devices (one
    card: four streams): 1D async (megastep cap 8) both orients, 1D
    lock-step, 2D (2, 2) async, and replicated over 2 devices; each
    census held to the main path's fused census and to C(n, 3).  Launch
    counts start from 0 just before each run: the megastep's must equal
    the async run's dispatches, the single-window kernel's the lock-step
    windows (steps x devices) and the replicated lanes (chunks x 2).
    The first async run is traced.  Returns the megastep's launches."""
    import torch
    from repro_torch import CensusEngine, default_devices
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    total = g.n * (g.n - 1) * (g.n - 2) // 6
    devices = default_devices(4, None if cuda else "cpu")
    runs = [
        ("1d async", "none", dict(partition=True), part_none, True),
        ("1d async", "degree", dict(partition=True), None, False),
        ("1d lockstep", "none", dict(partition=True, schedule="lockstep"),
         part_none, False),
        ("2d (2, 2) async", "none", dict(partition_2d=(2, 2)), None, False),
        ("replicated x2", "none", dict(), None, False),
    ]
    batch_launches = 0
    walls = {}
    for label, orient, kw, part, traced in runs:
        engine = CensusEngine(devices=devices[:2] if not kw else devices,
                              backend="fused", max_windows_per_dispatch=8,
                              **kw)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if traced:
            with torch.profiler.profile(activities=activities) as prof:
                census = engine.run(g, max_items=max_items, orient=orient,
                                    part=part)
                if cuda:
                    torch.cuda.synchronize()
        else:
            census = engine.run(g, max_items=max_items, orient=orient,
                                part=part)
            if cuda:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls[(label, orient)] = wall
        batch = ops.fused_census_desc_partials_batch.launches
        single = ops.fused_census_desc_partials.launches
        st = engine.stats
        want = census_none if orient == "none" else census_degree
        require((census == want).all(),
                f"{label} {orient}: {census.tolist()} != single-device "
                f"fused census {want.tolist()}")
        require(int(census.sum()) == total,
                f"{label} {orient}: census sums to {int(census.sum())}")
        if st.schedule == "async":
            require(batch == (st.dispatches_total if cuda else 0)
                    and single == 0,
                    f"{label}: megastep launched {batch} times for "
                    f"{st.dispatches_total} dispatches (single {single})")
            batch_launches += batch
        elif st.schedule == "lockstep":
            require(single == (st.dispatches_total * st.ndev if cuda
                               else 0) and batch == 0,
                    f"{label}: desc kernel launched {single} times for "
                    f"{st.dispatches_total} steps x {st.ndev} windows")
        else:
            require(single == (st.chunks * st.ndev if cuda else 0),
                    f"{label}: desc kernel launched {single} times for "
                    f"{st.chunks} chunks x {st.ndev} devices")
        items = np.asarray(st.shard_items or [st.items])
        windows = sum(st.shard_steps) if st.schedule else st.chunks
        saving = st.graph_replicated_bytes / max(st.graph_resident_bytes, 1)
        part_seconds = (st.host_partition_seconds if part is None
                        else part_s)
        log(f"partitioned {label} orient={orient}: wall {wall:.3f} s, host "
            f"partition {part_seconds:.3f} s"
            + (" (prebuilt, shared with the lock-step run)"
               if part is not None else "")
            + f", ndev {st.ndev}, shard_items max {int(items.max())} mean "
            f"{items.mean():.1f} ({st.shard_max_over_mean:.4f}), "
            f"shard_steps {st.shard_steps}, windows {windows}, dispatches "
            f"{st.dispatches_total}, windows per dispatch mean "
            f"{st.windows_per_dispatch_mean:.4f} max "
            f"{st.windows_per_dispatch_max} (cap "
            f"{st.dispatch_batch_limit}), stall_steps {st.stall_steps}, "
            f"idle_steps {st.idle_steps}, resident bytes per device "
            f"{st.graph_resident_bytes} vs replicated "
            f"{st.graph_replicated_bytes} "
            f"({saving:.4f}x less); launches megastep {batch} single {single}; "
            f"census equal to the single-device census and C(n,3)")
        if traced:
            split = trace_split(prof, device)
            if cuda:
                over = stream_overlap(prof)
                share = over["overlap_ms"] / max(over["kernel_busy_ms"], 1e-9)
                log(f"partitioned {label} orient={orient} trace: host "
                    f"ranges census.partition {split['partition_s']:.3f} s, "
                    f"census.plan {split['plan_s']:.3f} s; "
                    f"{over['kernels']} census kernels on {over['streams']}"
                    f" streams, kernels running {over['kernel_busy_ms']:.4f}"
                    f" ms, two or more streams' kernels at once "
                    f"{over['overlap_ms']:.4f} ms "
                    f"({share:.4%} of it); device busy {split['busy_ms']:.4f} ms = "
                    f"{split['busy_ms'] / 1e3 / wall:.4%} of the wall, idle "
                    f"{1 - split['busy_ms'] / 1e3 / wall:.4%}")
            else:
                log(f"partitioned {label} orient={orient} trace: device not "
                    f"measured")
    return dict(batch_launches=batch_launches,
                async_wall_s=walls[("1d async", "none")])


class _Stop(Exception):
    """Raised by a progress callback to stop a checkpointed run."""


#: seed of the faulty run's plan: FaultPlan.seeded(1, 4, ...) makes one
#: producer error (shard 1), one dispatch error (lane 3), one poisoned
#: dispatch (lane 0) and retires lane 2 at its first dispatch
FAULT_SEED = 1


def faults_sessions_phase(g, device, max_items: int, part, census_none,
                          async_wall: float, session: dict) -> dict:
    """Fault tolerance and the sessions of a multi-device engine on the
    main graph over 4 logical devices (one card: four streams):

    * a seeded faulty 1D async ``none`` run on the prebuilt partition
      (producer error, dispatch error, a poisoned dispatch, one lane
      retired), held to the single-device census; its megastep launches
      at least its dispatches (a poisoned window launches again);
    * a checkpointed 1D async run stopped by its progress callback after
      half of its windows, its journal compacted, then resumed: the same
      census, the journal's windows not dispatched again;
    * a ``PartitionedEngineSession`` (census, then the session phase's
      first two deltas), a ``PartitionedEngineSession2D`` (2, 2) that
      adopts the 1D session's census from its checkpoint and applies the
      first delta, and a replicated session over 2 lanes (census, first
      delta): each census held to the single-device census and each
      update to the session phase's from-scratch census of the edited
      graph; each session call launches the desc kernel once per
      dispatch.

    Launch counts start from 0 just before each run or session call.
    Returns the phase's megastep and desc-kernel launches."""
    import tempfile

    import torch
    from repro_torch import CensusEngine, FaultPlan, default_devices
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    total = g.n * (g.n - 1) * (g.n - 2) // 6
    devices = default_devices(4, None if cuda else "cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- the seeded faulty run
    plan = FaultPlan.seeded(FAULT_SEED, 4, producer_errors=1,
                            dispatch_errors=1, retire_devices=1, poisons=1)
    engine = CensusEngine(devices=devices, backend="fused", partition=True,
                          max_windows_per_dispatch=8, faults=plan)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    census = engine.run(g, max_items=max_items, part=part)
    sync()
    wall = time.perf_counter() - t0
    st = engine.stats
    batch = ops.fused_census_desc_partials_batch.launches
    single = ops.fused_census_desc_partials.launches
    require((census == census_none).all(),
            f"faulty run: {census.tolist()} != single-device census")
    require(int(census.sum()) == total, "faulty run: census != C(n,3)")
    require(st.retries >= 1 and st.failovers == 1
            and len(st.retired_devices) == 1,
            f"faulty run: retries {st.retries} failovers {st.failovers} "
            f"retired {st.retired_devices}")
    require(single == 0 and (batch >= st.dispatches_total if cuda
                             else batch == 0),
            f"faulty run: megastep launched {batch} times for "
            f"{st.dispatches_total} dispatches (single {single})")
    batch_launches = batch
    fired = sorted({(f.site, f.kind) for f in plan.faults})
    log(f"faults 1d async orient=none: plan seed {FAULT_SEED} {fired}; "
        f"wall {wall:.3f} s (fault-free 1d async {async_wall:.3f} s, "
        f"{wall / async_wall:.4f}x); retries {st.retries}, failovers "
        f"{st.failovers}, retired lanes {st.retired_devices}, watchdog "
        f"fires {st.watchdog_fires}, windows {sum(st.shard_steps)}, "
        f"dispatches {st.dispatches_total}, megastep launches {batch} "
        f"({batch - st.dispatches_total} beyond the dispatches), "
        f"shard_steps {st.shard_steps}; census equal to the single-device "
        f"census")

    # ---- a checkpointed run, stopped half way and resumed
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "run.ckpt")
        engine = CensusEngine(devices=devices, backend="fused",
                              partition=True, max_windows_per_dispatch=8)
        half = {}

        def stop(done, total_windows, num):
            half["total"] = total_windows
            if done + 1 >= total_windows // 2:
                raise _Stop

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            engine.run(g, max_items=max_items, part=part, checkpoint=ck,
                       progress=stop)
            require(False, "checkpointed run was not stopped")
        except _Stop:
            pass
        sync()
        stop_wall = time.perf_counter() - t0
        stopped_launches = ops.fused_census_desc_partials_batch.launches
        info = CensusEngine.compact_checkpoint(ck)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        census = engine.resume(g, ck, max_items=max_items, part=part)
        sync()
        resume_wall = time.perf_counter() - t0
        st = engine.stats
        batch = ops.fused_census_desc_partials_batch.launches
        require((census == census_none).all(),
                f"resumed run: {census.tolist()} != uninterrupted census")
        require(st.resumed_windows >= 1
                and st.resumed_windows + sum(st.shard_steps)
                == half["total"],
                f"resumed run: {st.resumed_windows} resumed + "
                f"{sum(st.shard_steps)} run != {half['total']} windows")
        require(batch == (st.dispatches_total if cuda else 0),
                f"resumed run: megastep launched {batch} times for "
                f"{st.dispatches_total} dispatches")
        batch_launches += stopped_launches + batch
        log(f"checkpoint 1d async orient=none: stopped after "
            f"{st.resumed_windows} of {half['total']} windows in "
            f"{stop_wall:.3f} s ({stopped_launches} megastep launches); "
            f"journal {info['records']} records {info['bytes']} bytes, "
            f"compacted to {info['compacted']} records "
            f"{info['compacted_bytes']} bytes; resumed {st.resumed_windows} "
            f"windows from it and ran {sum(st.shard_steps)} in "
            f"{st.dispatches_total} dispatches ({batch} launches), wall "
            f"{resume_wall:.3f} s; census equal to the uninterrupted one")

        # ---- sessions of a multi-device engine
        rows, deltas = session["rows"], session["deltas"]
        desc_launches = 0

        def held(label, s, call, want):
            nonlocal desc_launches
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            got = call()
            sync()
            wall = time.perf_counter() - t0
            count = ops.fused_census_desc_partials.launches
            require((got == want).all(),
                    f"{label}: {got.tolist()} != {want.tolist()}")
            require(int(got.sum()) == total, f"{label}: census != C(n,3)")
            # a replicated dispatch launches once on each lane
            lanes = 1 if s.stats.partitioned else s.stats.ndev
            require(count == (s.stats.chunks * lanes if cuda else 0)
                    and ops.fused_census_desc_partials_batch.launches == 0,
                    f"{label}: desc kernel launched {count} times for "
                    f"{s.stats.chunks} dispatches x {lanes} lanes")
            desc_launches += count
            return wall

        def update_line(label, s, k, wall):
            st = s.stats
            dispatched = [i for i, x in enumerate(st.shard_items) if x]
            log(f"{label} update k={k}: shards with dispatched items "
                f"{len(dispatched)} {dispatched} of {st.ndev}, affected "
                f"pairs {st.affected_pairs}, items {st.items} of "
                f"full_items {st.full_items} "
                f"({st.items / st.full_items:.4%}), dispatches "
                f"{st.chunks}, update wall {wall:.4f} s (host pair "
                f"{st.host_pair_seconds:.4f} s, merge "
                f"{st.host_merge_seconds:.4f} s, emit "
                f"{st.host_emit_seconds:.4f} s), load_max_over_mean "
                f"{s.load_max_over_mean:.4f}; equal to the from-scratch "
                f"census")

        t0 = time.perf_counter()
        s1 = CensusEngine(devices=devices, backend="fused",
                          partition=True).session(g, max_items=max_items)
        open_s = time.perf_counter() - t0
        wall = held("partitioned session census", s1, s1.census,
                    census_none)
        log(f"partitioned session 1d x4: opened in {open_s:.3f} s "
            f"(chunk_shape {s1.chunk_shape} desc_shape {s1.desc_shape}, "
            f"shard loads max/mean {s1.load_max_over_mean:.4f}), census "
            f"windows {s1.stats.chunks} items {s1.stats.items} wall "
            f"{wall:.3f} s; equal to the single-device census")
        sess_ck = str(Path(tmp) / "session.ckpt")
        s1.save_checkpoint(sess_ck)
        for row, delta in list(zip(rows, deltas))[:2]:
            wall = held(f"partitioned session update k={row['k']}", s1,
                        lambda: s1.update(*delta), row["census"])
            update_line("partitioned session 1d x4", s1, row["k"], wall)
            log(f"partitioned session 1d x4 update k={row['k']}: "
                f"single-device session update wall "
                f"{row['wall_s']:.4f} s, from-scratch fused census wall "
                f"{row['scratch_wall_s']:.3f} s")
        s1.close()

        t0 = time.perf_counter()
        s2 = CensusEngine(devices=devices, backend="fused",
                          partition_2d=(2, 2)).session(
            g, max_items=max_items)
        open_s = time.perf_counter() - t0
        s2.load_checkpoint(sess_ck)
        wall = held(f"2d session update k={rows[0]['k']}", s2,
                    lambda: s2.update(*deltas[0]), rows[0]["census"])
        log(f"partitioned session 2d (2, 2): opened in {open_s:.3f} s, "
            f"census adopted from the 1d session's checkpoint")
        update_line("partitioned session 2d (2, 2)", s2, rows[0]["k"],
                    wall)
        s2.close()

        t0 = time.perf_counter()
        s3 = CensusEngine(devices=devices[:2], backend="fused").session(
            g, max_items=max_items)
        open_s = time.perf_counter() - t0
        census_wall = held("replicated session census", s3, s3.census,
                           census_none)
        wall = held(f"replicated session update k={rows[0]['k']}", s3,
                    lambda: s3.update(*deltas[0]), rows[0]["census"])
        st = s3.stats
        log(f"replicated session x2: opened in {open_s:.3f} s, census "
            f"wall {census_wall:.3f} s; update k={rows[0]['k']}: items "
            f"{st.items} of full_items {st.full_items}, dispatches "
            f"{st.chunks} (x2 lanes), update wall {wall:.4f} s; equal to "
            f"the from-scratch census")
        s3.close()
    if cuda:
        require(desc_launches > 0, "the sessions launched no desc kernel")
    log(f"faults and multi-device sessions phase: megastep launches "
        f"{batch_launches}, desc launches {desc_launches}")
    return dict(batch_launches=batch_launches, desc_launches=desc_launches)


#: the monitor-backbone stream (the JAX package's benchmark stream of
#: its indexed-planner gate at 20x): a service backbone of 3M arcs among
#: 400k servers cycled through every window, and 1 stream slot in 50 an
#: ephemeral flow between two of 1.6M peers, churning on every slide
MONITOR = dict(n_servers=400_000, n_peers=1_600_000,
               backbone_arcs=3_000_000, window=4_000_000, stride=200_000,
               slides=8, eph_every=50)
#: slides of the smaller-depth monitors: orient="degree", and the
#: partitioned one (cut to one slide: the smoke ran past 420 s on the card)
MONITOR_DEGREE_SLIDES = 3
MONITOR_PARTITIONED_SLIDES = 1
#: the network_monitor_torch example's scenario as the phase runs it
EXAMPLE_MONITOR = dict(window=1200, windows=30, stride=600)
#: the example's --inject-faults seed the degradation run takes
EXAMPLE_FAULT_SEED = 0


def monitor_stream(rng, n_servers, n_peers, backbone_arcs, length,
                   eph_every):
    """Monitoring workload: a persistent service backbone (a fixed server
    mesh cycled through the stream, so it sits in every window and never
    churns) with every ``eph_every``-th stream slot an ephemeral
    peer-to-peer flow — the backbone-dominated regime where the pair
    space is large but the per-slide delta stays small.  Returns
    ``(src, dst, n)``."""
    n = n_servers + n_peers
    bs = rng.integers(0, n_servers, backbone_arcs)
    bd = (bs + 1 + rng.integers(0, n_servers - 1, backbone_arcs)) \
        % n_servers
    src = np.empty(length, np.int64)
    dst = np.empty(length, np.int64)
    bb = np.arange(length) % eph_every != 0
    idx = (np.cumsum(bb) - 1)[bb] % backbone_arcs
    src[bb], dst[bb] = bs[idx], bd[idx]
    n_peer_slots = int((~bb).sum())
    src[~bb] = n_servers + rng.integers(0, n_peers, n_peer_slots)
    dst[~bb] = n_servers + rng.integers(0, n_peers, n_peer_slots)
    return src, dst, n


def load_example(name: str):
    """An example script of the repo, imported by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def monitor_phase(device, max_items: int, cfg: dict, example: dict
                  ) -> dict:
    """The temporal monitor on the card.

    Full width: ``TriadMonitor(backend="fused", emit="device",
    orient="none", index=True)`` over the monitor-backbone stream, one
    full window then ``cfg["slides"]`` incremental slides, each window
    held to a second monitor that recounts every window from scratch
    (``incremental=False``) and to C(n, 3), the from-scratch censuses of
    window 0 and the first slide held to the plain torch monitor on the
    card (no kernel launched), the slides' ``full_items`` at
    least twice their ``items``, and each window's desc launches equal
    to its dispatches; then ``orient="degree"`` for one window and
    ``MONITOR_DEGREE_SLIDES`` slides and the partitioned monitor over
    ``default_devices(4)`` for one window and
    ``MONITOR_PARTITIONED_SLIDES``, held to the same windows' censuses.
    The example's scenario runs under fused/device, fused/host and hist
    (and fused/device without the pair-space index), each equal to the
    plain torch monitor on the CPU in censuses, proportions and alarms,
    with an alarm window on the injected scans; under the example's
    fault plan a degraded window carries its predecessor forward and
    every other window equals the fault-free run.  Launch counts start
    from 0 before each run; returns each kernel's sum over the phase."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    launches = {"fused_census_desc_partials": 0,
                "fused_census_partials": 0, "tricode_histogram": 0}

    def counted():
        counts = {fn.__name__: fn.launches for fn in (
            ops.fused_census_desc_partials, ops.fused_census_partials,
            ops.tricode_histogram)}
        require(ops.fused_census_desc_partials_batch.launches == 0,
                "a monitor launched the megastep")
        for name, count in counts.items():
            launches[name] += count
        return counts

    w, s = cfg["window"], cfg["stride"]
    length = w + cfg["slides"] * s
    t0 = time.perf_counter()
    src, dst, n = monitor_stream(
        np.random.default_rng(0), cfg["n_servers"], cfg["n_peers"],
        cfg["backbone_arcs"], length, cfg["eph_every"])
    total = n * (n - 1) * (n - 2) // 6
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g0 = rt.from_edges(src[:w], dst[:w], n=n)
    log(f"monitor-backbone stream: n {n}, {length} edges made in "
        f"{made_s:.3f} s; window {w} edges, stride {s}; window 0 has "
        f"{g0.num_arcs} arcs, {g0.packed.shape[0]} CSR entries (from_edges "
        f"{time.perf_counter() - t0:.3f} s), W0 "
        f"{rt.pair_space(g0).num_items_preprune}")
    del g0
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    def feed(mon, label, slides, held=None, traced=()):
        """One full window then ``slides`` slides through ``mon``; each
        window timed to its census (a host array: the card has landed)
        and its desc launches held to its dispatches.  Each ``(first,
        stop)`` range of windows in ``traced`` runs under one
        ``torch.profiler`` session, for the device's busy share of those
        windows' walls.  Returns per-window rows."""
        rows = []
        spans = [(0, w)] + [(w + k * s, w + (k + 1) * s)
                            for k in range(slides)]
        starts = dict(traced)
        prof, first, stop, traced_wall = None, 0, 0, 0.0
        for k, (lo, hi) in enumerate(spans):
            before = ops.fused_census_desc_partials.launches
            if k in starts:
                prof = torch.profiler.profile(activities=activities)
                first, stop, traced_wall = k, starts[k], 0.0
                prof.start()
            t0 = time.perf_counter()
            out = mon.observe(src[lo:hi], dst[lo:hi])
            wall = time.perf_counter() - t0
            count = ops.fused_census_desc_partials.launches - before
            require(out.shape == (1, 16), f"{label}: window {k} emitted "
                    f"{out.shape[0]} censuses")
            census = out[0]
            st = mon.window_stats[-1]
            require(int(census.sum()) == total,
                    f"{label} window {k}: census sums to "
                    f"{int(census.sum())}, not C(n,3)={total}")
            fused = cuda and mon.engine.backend == "fused"
            require(count == (st.chunks if fused else 0),
                    f"{label} window {k}: desc kernel launched {count} "
                    f"times for {st.chunks} dispatches")
            if held is not None:
                require((census == held[k]).all(),
                        f"{label} window {k}: {census.tolist()} != "
                        f"from-scratch {held[k].tolist()}")
            rows.append(dict(census=census, wall_s=wall, items=st.items,
                             full_items=st.full_items,
                             affected=st.affected_pairs, chunks=st.chunks,
                             launches=count, stats=st))
            extra = ""
            if st.partitioned:
                extra = (f", shard_items {st.shard_items} max/mean "
                         f"{st.shard_max_over_mean:.4f}, resident "
                         f"{st.graph_resident_bytes} B vs replicated "
                         f"{st.graph_replicated_bytes} B")
            if prof is not None:
                traced_wall += wall
            if prof is not None and k + 1 == stop:
                if cuda:
                    torch.cuda.synchronize()
                prof.stop()
                split = trace_split(prof, device)
                prof = None
                if cuda:
                    busy = split["busy_ms"] / 1e3 / traced_wall
                    extra += (f"; traced windows {first}-{k}: desc kernel "
                              f"{split['kernel_launches']} launches "
                              f"{split['kernel_ms']:.4f} ms, device busy "
                              f"{split['busy_ms']:.4f} ms = {busy:.4%} of "
                              f"their {traced_wall:.4f} s, idle "
                              f"{1 - busy:.4%}")
            log(f"{label} window {k}: items {st.items} of full_items "
                f"{st.full_items} ({st.items / max(st.full_items, 1):.4%})"
                f", affected pairs {st.affected_pairs}, dispatches "
                f"{st.chunks}, desc launches {count}, window wall "
                f"{wall:.4f} s (host pair {st.host_pair_seconds:.4f} s, "
                f"merge {st.host_merge_seconds:.4f} s, emit "
                f"{st.host_emit_seconds:.4f} s){extra}")
        return rows

    def monitor(**kw):
        return rt.TriadMonitor(n, window=w, stride=s, history=5,
                               max_items=max_items, **kw)

    # the from-scratch recount first: it holds every later run
    ops.reset_launch_counts()
    full = feed(monitor(device=device, incremental=False),
                "monitor-backbone full", cfg["slides"])
    counted()
    held = [r["census"] for r in full]
    # the plain torch version on the card, window 0 and one slide: holds
    # the fused desc kernel at this graph's own windows
    ops.reset_launch_counts()
    feed(monitor(device=device, backend="torch"),
         "monitor-backbone plain torch", 1, held)
    require(all(count == 0 for count in counted().values()),
            "the plain torch monitor launched a kernel")
    ops.reset_launch_counts()
    inc = feed(monitor(device=device, emit="device", index=True),
               "monitor-backbone incremental", cfg["slides"], held,
               traced=((0, 1), (1, 3)))
    counted()
    items = sum(r["items"] for r in inc[1:])
    full_items = sum(r["full_items"] for r in inc[1:])
    require(full_items >= 2 * items,
            f"monitor-backbone: slides processed {items} items of "
            f"{full_items} full — less than a 2x reduction")
    inc_wall = sum(r["wall_s"] for r in inc[1:])
    full_wall = sum(r["wall_s"] for r in full[1:])
    log(f"monitor-backbone totals: {cfg['slides']} slides, incremental "
        f"wall {inc_wall:.4f} s vs full-recompute wall {full_wall:.4f} s "
        f"({full_wall / inc_wall:.3f}x); items {items} vs {full_items} "
        f"({full_items / max(items, 1):.2f}x item reduction); first "
        f"window {inc[0]['wall_s']:.4f} s vs {full[0]['wall_s']:.4f} s")

    ops.reset_launch_counts()
    feed(monitor(device=device, orient="degree"),
         "monitor-backbone orient=degree", MONITOR_DEGREE_SLIDES, held)
    counted()
    devices = rt.default_devices(4, None if cuda else "cpu")
    ops.reset_launch_counts()
    feed(monitor(devices=devices, partition=True),
         "monitor-backbone partitioned x4", MONITOR_PARTITIONED_SLIDES,
         held)
    counted()

    # the example's scenario through the example's own entry point
    example_mod = load_example("network_monitor_torch")
    ref, spans = example_mod.run(backend="torch", device="cpu", **example)
    scans = max(example_mod.ATTACK_WINDOWS) < example["windows"]
    runs = {}
    for backend, emit, index in (("fused", "device", True),
                                 ("fused", "host", True),
                                 ("hist", None, True),
                                 ("fused", "device", False)):
        label = f"example {backend}/{emit or 'default'}" + (
            "" if index else " no index")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        mon, _ = example_mod.run(backend=backend, device=device, emit=emit,
                                 index=index, **example)
        wall = time.perf_counter() - t0
        counts = counted()
        require(np.array_equal(mon.censuses, ref.censuses)
                and np.array_equal(mon.proportions(), ref.proportions())
                and mon.alarms() == ref.alarms(),
                f"{label}: censuses, proportions or alarms differ from "
                f"the plain torch monitor on the CPU")
        flagged, hit = example_mod.detected(mon, spans)
        require(hit or not scans,
                f"{label}: no alarm window on the injected scans "
                f"(alarms at {sorted(flagged)})")
        runs[label] = mon
        log(f"{label}: {len(mon.window_stats)} windows in {wall:.3f} s, "
            f"alarm windows {sorted(flagged)}, bursts hit {len(hit)}/"
            f"{len(spans)}; launches {counts}; equal to the plain torch "
            f"monitor on the CPU")
    clean = runs["example fused/device"]
    ops.reset_launch_counts()
    mon, _ = example_mod.run(backend="fused", device=device,
                             inject_faults=EXAMPLE_FAULT_SEED, **example)
    counted()
    bad = {d["window"] for d in mon.degraded}
    require(bad, "fault plan: no degraded window")
    require(mon._session.retries >= 1, "fault plan: no retried dispatch")
    for t in range(clean.censuses.shape[0]):
        want = (mon.censuses[t - 1] if t in bad else clean.censuses[t])
        require(np.array_equal(mon.censuses[t], want),
                f"fault plan: window {t} {mon.censuses[t].tolist()} != "
                f"{want.tolist()}")
        require((mon.window_stats[t] is None) == (t in bad),
                f"fault plan: window {t} stats out of step")
    log(f"example under --inject-faults {EXAMPLE_FAULT_SEED}: degraded "
        f"windows {sorted(bad)} carried forward, retries "
        f"{mon._session.retries}, every other window equal to the "
        f"fault-free run")
    if cuda:
        for name, count in launches.items():
            require(count > 0, f"the monitor phase never launched {name}")
    log(f"temporal monitor phase: launches {launches}")
    return launches


def small_delta_stream(g, seed: int):
    """An empty delta, a deletion-heavy one and one growing a row past
    the largest degree, as (add_src, add_dst, del_src, del_dst)."""
    import repro_torch as rt
    rng = np.random.default_rng(seed)
    empty = np.zeros(0, np.int64)
    out = [(empty, empty, empty, empty)]
    g, _ = rt.apply_delta(g, *out[-1])
    src, dst = np.nonzero(rt.to_dense(g))
    take = rng.random(src.shape[0]) < 0.4
    out.append((rng.integers(0, g.n, 3), rng.integers(0, g.n, 3),
                src[take], dst[take]))
    g, _ = rt.apply_delta(g, *out[-1])
    hub = int(rng.integers(0, g.n))
    spokes = rng.choice(g.n, int(g.degrees.max()) + 3, replace=False)
    out.append((np.full(spokes.shape[0], hub), spokes, empty, empty))
    return out


def oracle_phase(device) -> dict:
    """Small workloads × backends × orients × emits against the serial
    Batagelj–Mrvar census; returns each kernel's launch count."""
    import repro_torch as rt
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    runs = 0
    for name, (n, deg) in SMALL_SIZES.items():
        g = rt.paper_workload(name, n=n, avg_degree=deg, seed=0)
        want = rt.census_batagelj_mrvar(g)
        for backend in rt.BACKENDS:
            for orient in ("none", "degree"):
                for emit in rt.EMIT_MODES:
                    for max_items in (None, 4096):
                        got, _, _ = census_run(g, device, backend, orient,
                                               max_items, emit)
                        require((got == want).all(),
                                f"oracle {name} {backend} {orient} {emit} "
                                f"{max_items}: {got.tolist()} != "
                                f"{want.tolist()}")
                        runs += 1
    sessions = 0
    for name, (n, deg) in SMALL_SIZES.items():
        g = rt.paper_workload(name, n=n, avg_degree=deg, seed=0)
        stream = small_delta_stream(g, seed=1)
        graphs = [g]
        for delta in stream:
            graphs.append(rt.apply_delta(graphs[-1], *delta)[0])
        wants = [rt.census_batagelj_mrvar(h) for h in graphs]
        for backend in rt.BACKENDS:
            for orient in ("none", "degree"):
                for emit in rt.EMIT_MODES:
                    s = rt.CensusEngine(device=device, backend=backend).\
                        session(g, orient=orient, emit=emit, max_items=4096)
                    steps = [s.census()] + [s.update(*d) for d in stream]
                    for k, (got, want) in enumerate(zip(steps, wants)):
                        require((got == want).all(),
                                f"oracle session {name} {backend} {orient} "
                                f"{emit} step {k}: {got.tolist()} != "
                                f"{want.tolist()}")
                    require(np.array_equal(s.graph.packed,
                                           graphs[-1].packed),
                            f"oracle session {name}: graph drifted")
                    s.close()
                    sessions += 1
    counts = {fn.__name__: fn.launches for fn in (
        ops.fused_census_desc_partials, ops.fused_census_partials,
        ops.tricode_histogram)}
    if device.type == "cuda":
        for name, count in counts.items():
            require(count > 0, f"oracle phase never launched {name}")
    log(f"oracle phase: {runs} runs and {sessions} sessions (census + "
        f"{len(stream)} updates each) equal census_batagelj_mrvar; "
        f"launches {counts}")
    return counts


#: the LM serving phase: qwen2-0.5b at full width and depth (batch,
#: prompt, new tokens, requests), then three configs at full width with
#: their depth cut (layers; an encoder-decoder's encoder as deep)
LM_MAIN = dict(arch="qwen2-0.5b", batch=8, prompt=512, new=64, q_chunk=64)
LM_SIDE = (("granite-moe-3b-a800m", 4), ("qwen2-vl-2b", 2),
           ("seamless-m4t-medium", 2))
LM_SIDE_SHAPE = dict(batch=4, prompt=128, new=16)
#: hold (c): the full width cut to 2 layers, card against the CPU path
LM_CUT = dict(layers=2, batch=2, prompt=64, steps=8)
LM_CORR, LM_REL = 0.9999, 0.02


def lm_config(arch: str, layers: int | None, rehearse: bool):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if rehearse:
        return cfg.reduced()
    if layers is None:
        return cfg
    changes = dict(num_layers=layers)
    if cfg.is_encdec:
        changes["encoder_layers"] = layers
    return dataclasses.replace(cfg, **changes)


def lm_request(cfg, batch: int, prompt: int, seed: int) -> dict:
    """One request's inputs from ``seed``: prompt ids, and the source
    frames of an encoder-decoder or, for a vision-language model, patch
    embeddings over a quarter of the prompt (an image of 4 rows) with
    their M-RoPE (t, h, w) positions; text keeps its index as position,
    so the last prompt token sits where the decode step counts from."""
    rng = np.random.default_rng(seed)
    req = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, prompt)).astype(np.int32)}
    if cfg.is_encdec:
        req["src_embeds"] = rng.normal(
            size=(batch, prompt, cfg.d_model)).astype(np.float32)
    if cfg.modality == "vlm":
        lo, span = prompt // 8, prompt // 4
        mask = np.zeros((batch, prompt), bool)
        mask[:, lo:lo + span] = True
        pos = np.broadcast_to(np.arange(prompt), (3, batch, prompt)).copy()
        patch = np.arange(span)
        pos[0, :, lo:lo + span] = lo
        pos[1, :, lo:lo + span] = lo + patch // (span // 4)
        pos[2, :, lo:lo + span] = lo + patch % (span // 4)
        req.update(vision_mask=mask, positions3=pos.astype(np.int32),
                   vision_embeds=rng.normal(
                       size=(batch, prompt, cfg.d_model)).astype(np.float32))
    return req


def lm_batch(req: dict, device, upto: int | None = None) -> dict:
    """A request as the model functions take it, cut to its first
    ``upto`` positions."""
    import torch
    cut = slice(None, upto)
    out = {"tokens": torch.as_tensor(req["tokens"][:, cut]).long()}
    if "src_embeds" in req:
        out["src_embeds"] = torch.as_tensor(req["src_embeds"]).to(
            torch.bfloat16)
    if "vision_mask" in req:
        out["vision_mask"] = torch.as_tensor(req["vision_mask"][:, cut])
        out["vision_embeds"] = torch.as_tensor(
            req["vision_embeds"][:, cut]).to(torch.bfloat16)
        out["positions3"] = torch.as_tensor(req["positions3"][..., cut])
    return {k: v.to(device) for k, v in out.items()}


def lm_generate(eng, req: dict, new: int, **kw):
    return eng.generate(req["tokens"], max_new_tokens=new,
                        src_embeds=req.get("src_embeds"),
                        vision_embeds=req.get("vision_embeds"),
                        vision_mask=req.get("vision_mask"),
                        positions3=req.get("positions3"), **kw)


def lm_hold(label: str, got, want, corr=LM_CORR, rel=LM_REL) -> dict:
    """Correlation and max |got - want| over max |want| of two logit
    sets; fails below ``corr`` or above ``rel``."""
    got = got.float().cpu().numpy().ravel()
    want = want.float().cpu().numpy().ravel()
    c = float(np.corrcoef(got, want)[0, 1])
    d = float(np.abs(got - want).max() / np.abs(want).max())
    require(c >= corr and d <= rel,
            f"{label}: corr {c} (>= {corr}), max diff / max {d} "
            f"(<= {rel})")
    return dict(corr=c, rel=d)


def lm_hold_a(label, eng, cfg, req, new) -> tuple:
    """Hold (a): a greedy request run twice gives the same tokens, the
    prompt echoed and every id below ``vocab_size``; returns the tokens
    and the second (warm) run's timing."""
    out = lm_generate(eng, req, new)
    again = lm_generate(eng, req, new)
    timing = dict(eng.timing)
    p = req["tokens"].shape[1]
    require(np.array_equal(out, again), f"{label}: greedy not repeatable")
    require(np.array_equal(out[:, :p], req["tokens"]),
            f"{label}: prompt not echoed")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{label}: ids outside the vocabulary")
    return out, timing


def lm_prefill_vs_decode(cfg, w, req, device, capacity: int, q_chunk):
    """prefill(P) against prefill(P - 1) + one decode step: the two
    paths' next-token logits (the JAX package's test_serve bound)."""
    import torch
    from repro_torch.models import model
    from repro_torch.serve import engine
    p = req["tokens"].shape[1]
    with torch.inference_mode():
        full, _ = model.serve_prefill(
            cfg, w, lm_batch(req, device), q_chunk=q_chunk,
            enc_out=(model.encode(cfg, w, lm_batch(req, device)[
                "src_embeds"], q_chunk=q_chunk) if cfg.is_encdec else None))
        step = engine.teacher_forced_logits(
            cfg, w, lm_batch(req, device, p - 1),
            torch.as_tensor(req["tokens"][:, -1:]).long().to(device),
            capacity=capacity, q_chunk=q_chunk)[-1]
    v = cfg.vocab_size
    a = full[:, -1, :v].float().cpu().numpy().ravel()
    b = step[:, :v].float().cpu().numpy().ravel()
    return float(np.corrcoef(a, b)[0, 1])


def lm_cut_hold(label, cfg, params, device, q_chunk: int, cut: dict
                ) -> dict:
    """Hold (c): ``params`` cut to ``cut["layers"]`` layers of the full
    width, on the card and on the CPU path: the prefill's and
    ``cut["steps"]`` teacher-forced decode steps' logits (tokens: the
    card's greedy ones)."""
    import dataclasses
    import torch
    from repro_torch.models import model
    from repro_torch.serve import engine
    n = cut["layers"]
    cut_cfg = dataclasses.replace(cfg, num_layers=n)
    keep = {k: v for k, v in params.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}
    small = model.LanguageModel(cut_cfg, device="cpu")
    small.load_state_dict(keep)
    cpu_w = model.compute_copy(small)
    card_w = model.compute_copy(small, device=device)
    req = lm_request(cut_cfg, cut["batch"], cut["prompt"], seed=7)
    cap = cut["prompt"] + cut["steps"] + 8
    eng = engine.ServeEngine(cut_cfg, small, max_seq_len=cap,
                             q_chunk=q_chunk, device=device)
    tokens = torch.as_tensor(
        lm_generate(eng, req, cut["steps"])[:, cut["prompt"]:]).long()
    got = engine.teacher_forced_logits(
        cut_cfg, card_w, lm_batch(req, device), tokens.to(device),
        capacity=cap, q_chunk=q_chunk)
    want = engine.teacher_forced_logits(
        cut_cfg, cpu_w, lm_batch(req, "cpu"), tokens, capacity=cap,
        q_chunk=q_chunk)
    v = cfg.vocab_size
    worst = dict(corr=1.0, rel=0.0)
    for i, (g, w) in enumerate(zip(got, want)):
        held = lm_hold(f"{label} (c) step {i}", g[:, :v], w[:, :v])
        worst = dict(corr=min(worst["corr"], held["corr"]),
                     rel=max(worst["rel"], held["rel"]))
    return worst


def lm_moe_holds(label, cfg, params, eng, req, capacity: int, q_chunk,
                 device) -> str:
    """The MoE config's dropped items in a prefill and in its greedy
    decode steps (each MoE call's count, summed over layers), and its
    last MoE layer's ``apply_moe`` in float32 on the card against the
    CPU: equal ``expert_load`` and ``dropped_tokens``, outputs within
    1e-4 of their largest magnitude (float32 sums over 1,536 and 512
    terms in two orders; the reference's fan-in recipe reads an expert
    stack's leading axis, so outputs reach the hundreds)."""
    import torch
    from repro_torch.models import model, moe
    from repro_torch.serve import engine
    drops = {"prefill": [], "decode": []}
    stage = ["prefill"]
    real = moe.apply_moe

    def counted(*a, **kw):
        y, m = real(*a, **kw)
        drops[stage[0]].append(m["dropped_tokens"])
        return y, m

    b, p = req["tokens"].shape
    steps = capacity - p - 8
    model.moe_mod.apply_moe = counted
    try:
        with torch.inference_mode():
            batch = lm_batch(req, device)
            _, caches = model.serve_prefill(cfg, eng.weights, batch,
                                            q_chunk=q_chunk)
            stage[0] = "decode"
            cache = engine.prefill_to_decode_cache(cfg, caches, p, capacity)
            tok = batch["tokens"][:, -1:]
            for _ in range(steps):
                logits, cache = model.decode_step(cfg, eng.weights, tok,
                                                  cache)
                tok = logits[:, -1].argmax(-1)[:, None]
    finally:
        model.moe_mod.apply_moe = real
    layer = params.layers[-1]["moe"]
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(b, p, cfg.d_model)), dtype=torch.float32)
    want, want_m = moe.apply_moe(
        cfg, {k: layer[k].cpu() for k in layer.inits}, x)
    got, got_m = moe.apply_moe(cfg, layer, x.to(device))
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    for key in ("expert_load", "dropped_tokens"):
        require(torch.equal(got_m[key].cpu(), want_m[key]),
                f"{label} apply_moe {key} card != cpu")
    require(err <= 1e-4, f"{label} apply_moe f32 max err / max {err}")
    layers = cfg.num_layers - int(cfg.first_layer_dense)
    return (f"dropped_tokens prefill {sum(int(d) for d in drops['prefill'])}"
            f" of {b * p * cfg.top_k * layers} items, decode "
            f"{sum(int(d) for d in drops['decode'])} of "
            f"{steps * b * cfg.top_k * layers} over {steps} steps; "
            f"apply_moe f32 card vs cpu: expert_load and dropped_tokens "
            f"({int(want_m['dropped_tokens'])}) equal, max err / max "
            f"{err:.3g} (<= 1e-4)")


def lm_trace(fn, device) -> dict:
    """Kernels launched and the device's busy share while ``fn()`` runs,
    from a ``torch.profiler`` trace (busy: the union of every kernel,
    copy and memset span); none on the CPU."""
    import torch
    from torch.autograd import DeviceType
    if device.type != "cuda":
        fn()
        return dict(kernels=None, busy_ms=None, wall_ms=None, idle=None)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    activity = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("serve.")]
    kernels = [e for e in activity
               if not e.name.startswith(("Memcpy", "Memset"))]
    busy_us, reach = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in activity):
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    return dict(kernels=len(kernels), busy_ms=busy_us / 1e3,
                wall_ms=wall_ms, idle=1.0 - busy_us / 1e3 / wall_ms)


def lm_serving_phase(device, rehearse: bool) -> dict:
    """qwen2-0.5b served at full width and depth through ``ServeEngine``,
    then the MoE, vision-language and encoder-decoder configs at full
    width with their depth cut, each held as the module docstring says;
    returns the main cell's numbers."""
    import torch
    from repro_torch.models import model, moe
    from repro_torch.serve import engine
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    main, side, cut = dict(LM_MAIN), dict(LM_SIDE_SHAPE), dict(LM_CUT)
    if rehearse:
        main.update(batch=2, prompt=24, new=4, q_chunk=8)
        side.update(batch=2, prompt=16, new=3)
        cut.update(prompt=16, steps=3)
    # 1. qwen2-0.5b, full config
    cfg = lm_config(main["arch"], None, rehearse)
    t0 = time.perf_counter()
    params = model.make_params(cfg, seed=0, device=device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    b, p, new = main["batch"], main["prompt"], main["new"]
    cap = p + new + 8
    eng = engine.ServeEngine(cfg, params, max_seq_len=cap,
                             q_chunk=main["q_chunk"], device=device)
    w_bytes = sum(t.numel() * t.element_size()
                  for t in eng.weights.parameters())
    log(f"lm {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} (padded {model.pad_vocab(cfg.vocab_size)}): "
        f"{n_params} parameters, {p_bytes} bytes float32, initialised in "
        f"{init_s:.3f} s; compute copy {w_bytes} bytes (bfloat16, norms "
        f"float32)")
    req = lm_request(cfg, b, p, seed=0)
    greedy, timing = lm_hold_a(f"lm {cfg.name}", eng, cfg, req, new)
    sampled = lm_generate(eng, lm_request(cfg, b, p, seed=1), new,
                          temperature=0.8, seed=1)
    require(bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all()),
            "lm sampled ids outside the vocabulary")
    step_ms = timing["decode_ms"] / new
    # the decode step's weight read: every matrix once (the tied
    # embedding as the head), the embedding gather's rows aside
    cache_bytes = (2 * cfg.num_layers * b * cap * cfg.num_kv_heads
                   * cfg.head_dim * 2)
    bound = w_bytes / HBM_BYTES_PER_S * 1e3
    traced = lm_trace(lambda: lm_generate(eng, req, new), device)
    prefill_only = lm_trace(lambda: lm_generate(eng, req, 0), device)
    per_step = (None if traced["kernels"] is None else
                (traced["kernels"] - prefill_only["kernels"]) / new)
    out = dict(prefill_ms=timing["prefill_ms"], decode_step_ms=step_ms,
               prefill_tok_s=b * p / timing["prefill_ms"] * 1e3,
               decode_tok_s=b / step_ms * 1e3, bound_ms=bound,
               launches_per_step=per_step, idle=traced["idle"],
               params=n_params)
    log(f"lm {cfg.name} serve: batch {b}, prompt {p}, {new} new tokens, "
        f"3 requests (2 greedy, 1 at temperature 0.8 seed 1): prefill "
        f"{timing['prefill_ms']:.4f} ms ({out['prefill_tok_s']:.1f} "
        f"tokens/s), decode {step_ms:.4f} ms/step "
        f"({out['decode_tok_s']:.1f} tokens/s); decode bound "
        f"{bound:.4f} ms (weights {w_bytes} bytes / 3.35 TB/s; the KV "
        f"cache adds at most {cache_bytes} bytes); greedy repeatable, "
        f"prompt echoed, ids < vocab")
    untraced_ms = timing["prefill_ms"] + timing["decode_ms"]
    out["idle_untraced"] = (None if traced["busy_ms"] is None
                            else 1 - traced["busy_ms"] / untraced_ms)
    log(f"lm {cfg.name} trace: one greedy request {traced['wall_ms']} ms "
        f"wall under the profiler, device busy {traced['busy_ms']} ms, "
        f"idle share {traced['idle']} (of the untraced request's "
        f"{untraced_ms} ms on the card's clock: {out['idle_untraced']}); "
        f"kernels {traced['kernels']} (prefill alone "
        f"{prefill_only['kernels']}): {per_step} launches per decode step")
    corr_b = lm_prefill_vs_decode(cfg, eng.weights, req, device, cap,
                                  main["q_chunk"])
    require(corr_b >= 0.999, f"lm {cfg.name} (b): prefill vs decode corr "
            f"{corr_b} < 0.999")
    held_c = lm_cut_hold(f"lm {cfg.name}", cfg, params, device,
                         main["q_chunk"], cut)
    log(f"lm {cfg.name} holds: (a) yes; (b) prefill(P) vs prefill(P-1) + "
        f"decode corr {corr_b:.6f} (>= 0.999); (c) {cut['layers']} "
        f"layers card vs cpu, prefill + {cut['steps']} teacher-forced "
        f"steps: min corr {held_c['corr']:.7f} (>= {LM_CORR}), max diff / "
        f"max {held_c['rel']:.5f} (<= {LM_REL}); phase at "
        f"{time.perf_counter() - t_phase:.3f} s")
    del eng, params

    # 2.-3. MoE, vision-language and encoder-decoder at full width
    for arch, layers in LM_SIDE:
        cfg = lm_config(arch, layers, rehearse)
        params = model.make_params(cfg, seed=0, device=device)
        sb, sp, snew = side["batch"], side["prompt"], side["new"]
        scap = sp + snew + 8
        eng = engine.ServeEngine(cfg, params, max_seq_len=scap,
                                 q_chunk=main["q_chunk"], device=device)
        req = lm_request(cfg, sb, sp, seed=2)
        label = f"lm {cfg.name} x{cfg.num_layers}"
        _, timing = lm_hold_a(label, eng, cfg, req, snew)
        notes = []
        if cfg.is_moe:
            notes.append(lm_moe_holds(label, cfg, params, eng, req, scap,
                                      main["q_chunk"], device))
        else:
            held = lm_cut_hold(label, cfg, params, device, main["q_chunk"],
                               cut)
            notes.append(f"(c) min corr {held['corr']:.7f}, max diff / max "
                         f"{held['rel']:.5f}")
            corr_b = lm_prefill_vs_decode(cfg, eng.weights, req, device,
                                          scap, main["q_chunk"])
            if cfg.modality == "vlm":
                require(corr_b >= 0.999, f"{label} (b): prefill vs decode "
                        f"corr {corr_b} < 0.999")
                notes.append(f"(b) corr {corr_b:.6f}")
            else:
                notes.append(f"prefill vs decode corr {corr_b:.6f} (not "
                             f"held: the reference's two paths differ)")
        log(f"{label}: batch {sb}, prompt {sp}, {snew} new tokens: "
            f"prefill {timing['prefill_ms']:.4f} ms, decode "
            f"{timing['decode_ms'] / snew:.4f} ms/step; (a) yes; "
            + "; ".join(notes)
            + f"; phase at {time.perf_counter() - t_phase:.3f} s")
        del eng, params
    return out


def phase_done(name: str, t_start: float) -> None:
    log(f"phase {name} done at {time.perf_counter() - t_start:.3f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rehearse", action="store_true",
                        help="toy sizes on the CPU, plain versions only; "
                             "prints no result")
    parser.add_argument("--ab", nargs="+", type=Path, metavar="CU",
                        help="instead of the phases: time the kernels of "
                             "each given version of a csrc/*.cu (named as "
                             "that file, or ending in '-' and its name) "
                             "against the package's, in turns, at their "
                             "measured windows (on the card); prints no "
                             "result")
    args = parser.parse_args(argv)
    if args.ab and args.rehearse:
        parser.error("--ab runs on the card only")
    t_start = time.perf_counter()

    import torch
    if args.rehearse:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this script "
                             "drives the port on the card")
        device = torch.device("cuda", 0)
    import repro_torch as rt
    header(device)
    if device.type == "cuda":
        build_kernels()

    main_cfg = dict(PATENTS)
    hub_cfg = dict(HUB)
    max_items = MAX_ITEMS
    session_ks = SESSION_DELTAS
    if args.rehearse:
        max_items = 4096
        main_cfg.update(n=5_000)
        hub_cfg.update(n=600)
        session_ks = (10, 100, 1_000)
    t0 = time.perf_counter()
    g = rt.scale_free_digraph(**main_cfg)
    log(f"main graph: n {g.n} arcs {g.num_arcs} csr {g.packed.shape[0]} "
        f"max_degree {int(g.degrees.max())} built in "
        f"{time.perf_counter() - t0:.3f} s")

    hub = rt.paper_workload("orkut", hub_cfg["n"], hub_cfg["avg_degree"],
                            seed=0)
    log(f"hub graph: n {hub.n} csr {hub.packed.shape[0]} max_degree "
        f"{int(hub.degrees.max())}")
    t0 = time.perf_counter()
    part = rt.partition_graph(num_shards=4, space=rt.pair_space(g))
    part_s = time.perf_counter() - t0
    log(f"1D partition of the main graph over 4 shards (orient none): "
        f"{part_s:.3f} s of host (pair space, LPT, shard extraction)\n"
        + rt.shard_report(part))
    phase_done("graphs and partition", t_start)
    reps = 20 if device.type == "cuda" else 2
    if args.ab:
        ab_phase(g, hub, part, device, max_items, session_ks[1], args.ab,
                 reps)
        return 0
    records, codes_case = kernel_phase(g, hub, part, device, max_items,
                                       session_ks[1], reps)
    phase_done("kernel", t_start)

    # the main path, both orients: launch counts from 0 just before it
    from repro_torch.kernels import ops
    w0 = rt.pair_space(g).num_items_preprune
    ops.reset_launch_counts()
    runs = [held_run("patents", g, device, orient, max_items, w0)
            for orient in ("none", "degree")]
    records[0]["launches"] = sum(r["launches"] for r in runs)
    require(ops.fused_census_desc_partials.launches
            == records[0]["launches"], "launches outside the engine runs")

    ops.reset_launch_counts()
    held_run("orkut-hub", hub, device, "degree", max_items,
             rt.pair_space(hub).num_items_preprune)
    phase_done("main path and hub graph", t_start)

    # the session path: counts from 0 just before it
    ops.reset_launch_counts()
    session = session_phase(g, device, max_items, runs[0]["census"],
                            runs[1]["census"], session_ks)
    records[0]["session_launches"] = session["launches"]
    phase_done("session", t_start)

    # the partitioned and replicated full runs: counts from 0 just before
    # each run, inside the phase
    parted = partitioned_phase(g, device, max_items, part, part_s,
                               runs[0]["census"], runs[1]["census"])
    records[0]["batch"]["launches"] = parted["batch_launches"]
    phase_done("partitioned", t_start)

    # faults and the sessions of a multi-device engine: counts from 0
    # just before each run and session call, inside the phase
    faulted = faults_sessions_phase(g, device, max_items, part,
                                    runs[0]["census"],
                                    parted["async_wall_s"], session)
    records[0]["batch"]["fault_phase_launches"] = faulted["batch_launches"]
    records[0]["multidevice_session_launches"] = faulted["desc_launches"]
    phase_done("faults and multi-device sessions", t_start)

    # the temporal monitor and the example's scenario: counts from 0 just
    # before each monitor run, inside the phase
    monitor_cfg, example_cfg = dict(MONITOR), dict(EXAMPLE_MONITOR)
    if args.rehearse:
        monitor_cfg.update(n_servers=200, n_peers=800, backbone_arcs=1_500,
                           window=2_000, stride=100, slides=3)
        example_cfg.update(windows=10)
    monitored = monitor_phase(device, max_items, monitor_cfg, example_cfg)
    for record, name in zip(records, ("fused_census_desc_partials",
                                      "fused_census_partials",
                                      "tricode_histogram")):
        record["monitor_launches"] = monitored[name]
    phase_done("temporal monitor", t_start)

    # the pair_codes entry point, on the kernel phase's tiles
    q, k, kc, want = codes_case
    ops.reset_launch_counts()
    got = rt.pair_codes(q, k, kc)
    records[3]["launches"] = ops.pair_codes.launches
    require(torch.equal(got, want), "pair_codes entry point != plain")
    require(records[3]["launches"] == (1 if device.type == "cuda" else 0),
            f"pair_codes entry point launched {records[3]['launches']} "
            f"kernels")
    log(f"pair_codes entry point: {q.shape[0]} tiles, launches "
        f"{records[3]['launches']}, equal to the plain version")

    counts = oracle_phase(device)
    phase_done("pair_codes and oracle", t_start)
    records[1]["launches"] = counts["fused_census_partials"]
    records[2]["launches"] = counts["tricode_histogram"]

    # LM serving: no hand-written kernel on this path (plain torch)
    lm_serving_phase(device, args.rehearse)
    phase_done("LM serving", t_start)

    log(f"chip_smoke elapsed {time.perf_counter() - t_start:.3f} s")
    if args.rehearse:
        log("rehearsal complete: no device result")
        return 3
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
