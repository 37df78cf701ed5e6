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
   against 8 single launches, then at K = 1, 2, 4, 8 real rows of a
   cap-8 buffer and at shard 0's last window, each with a dispatch's
   time -- the upload of its real rows from pinned memory and the launch
   -- beside uploading and launching all 8 rows, and window 0 of the 4
   shards on their 4 streams against one stream);
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
    prompt 128, 16 new tokens;
12. serves the recurrent models the same way, at full width and depth
    with seeded random weights on the card: xlstm-1.3b (48 layers, 42
    mLSTM and 6 sLSTM; batch 8, prompt 512, 64 new tokens) and
    recurrentgemma-2b (26 layers, 18 RG-LRU and 8 local attention with a
    2,048-slot ring; batch 4, prompt 2,048, 64 new tokens, so every decode
    step wraps the ring), printing parameters, float32 bytes,
    initialisation seconds and the compute copy's bytes by dtype, prefill
    and decode times and rates, the decode step's bound from the bytes it
    moves (weights, every recurrent state read and written, the KV ring),
    launches per decode step and per prefill and the idle share of a
    traced greedy request, and holding (a) and (b) as above and (c) with
    the depth cut to every block kind once (sLSTM + mLSTM; RG-LRU, RG-LRU,
    local attention) -- for xlstm stepwise, since its sLSTM is chaotic at
    full width: its prefill logits card vs CPU are printed beside the CPU
    path's own deviation under one bfloat16 step of one input, and the
    mLSTM layer's prefill from the CPU's input to it and each decode step
    from the CPU's cache are held;
13. trains qwen2-0.5b at full width and depth through the port's train
    step, data pipeline, checkpoints and ``Coordinator`` (one injected
    failure), printing each step and the MFU, and holds (a) finite
    losses, (b)/(c) cut models' losses and gradients card against CPU,
    (d) a recovered run equal to an uninterrupted one and (e) the
    training example on the card;
14. drives the parallel layer over logical devices (streams on the one
    card): (a) the placements of every config's parameters, optimizer
    state and train_4k decode cache at (16, 16) and (2, 16, 16), on
    ``meta``: leaves sharded by each axis, parameter + optimizer bytes
    per device; (b) one granite-moe-3b-a800m MoE layer at full width in
    float32 on the hidden states of a 4 x 512 batch after layer 0's
    attention, through ``make_sharded_moe`` on (1, 4) (EP all-to-all)
    and (2, 2) (FSDP gather over ``data``), held at capacity 16 to
    ``apply_moe`` on the card and at 1.25 to the same path on the CPU,
    then the full-depth prefill through ``moe_fn`` printed beside the
    grouped path; (c) ``build_train_step(moe_impl="shard_map")`` on
    granite cut to 4 layers, 2 steps on (1, 4), losses held to the CPU
    and to ``moe_impl="gspmd"``; (d) qwen2-0.5b's 24 layers as 2 GPipe
    stages (``split_stages``, ``pipeline_apply``), 4 microbatches of 2 x
    512, outputs bit for bit and gradients held to the sequential
    ``run_stack``; (e) ``quantized_tree_psum`` of qwen2-0.5b's gradients
    from 4 micro-batches over 4 ``data`` shards at 8 and 16 bits, every
    shard's reduced values bit for bit to the CPU's ``quantized_psum``,
    each leaf's error within n · scale / (2 · qmax), residuals + reduced
    to the gradients' sum; each part's seconds and peak memory;
15. runs the analysis layer on the host (``meta`` traces, six records at
    once in spawned worker processes; nothing allocated on the card):
    ``run_cell`` of qwen2-0.5b's train_4k, prefill_32k and decode_32k and
    granite-moe-3b-a800m's train_4k at (16, 16), each record's memory,
    FLOPs and modelled collectives and its roofline row, the table; then
    one-card records of step 13's training cell and step 11's decode
    cell: the parameter + optimizer bytes held exactly to the trained
    state's, the predicted memory, FLOPs and roofline step printed beside
    the training phase's peak memory, model FLOPs and median step, and
    the decode roofline term beside the serving phase's bound and
    measured step, with the card's name and power limit; the phase is
    held under 60 s.

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

``--ab-tree DIR`` (alone, or after ``--ab``'s kernels) times the 1D
async orient-none cap-8 run of the main graph with the package of
``DIR/src`` -- another commit's checkout, as ``git archive`` unpacks it
into a gitignored directory -- against this checkout's, in turns, each
in a process of its own that builds its package's kernels::

    python3 chip_smoke.py --ab-tree build/ab/parent
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
#: the megastep's measured batches: K real rows of a buffer of
#: BATCH_CAP rows (the async runs' cap)
BATCH_CAP = 8
BATCH_KS = (1, 2, 4, 8)
#: untraced walls of each ``--ab-tree`` turn (one traced run follows)
AB_RUN_WALLS = 3


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
        log(card_label(device))  # the card's name and power limit
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


def anchor_record(cases, device, timings) -> dict:
    """The ``desc_anchors`` kernel at each measured window: its table bit
    for bit against the plain version and against the table the host
    built for the window; at the first window (the main path's) its ms
    beside the plain version's and ``torch.searchsorted``'s on a prebuilt
    grid.  Bound: the table's writes and one read of ``desc_cum``."""
    import torch
    from repro_torch.core.planner import DESC_ANCHOR_STRIDE
    from repro_torch.kernels import ops
    for case in cases:
        dc, host = case.window[2], case.window[4]
        got = ops.desc_anchors(dc, torch.empty_like(host))
        require(torch.equal(got, ops.desc_anchors_ref(dc, host.shape[0]))
                and torch.equal(got, host),
                f"desc_anchors != plain version or host table at "
                f"{case.label}")
    dc, host = cases[0].window[2], cases[0].window[4]
    num_anchors = host.shape[0]
    out = torch.empty_like(host)
    grid = torch.arange(num_anchors, dtype=torch.int32,
                        device=device) * DESC_ANCHOR_STRIDE
    nbytes = 4 * (num_anchors + dc.shape[0])
    b, by = bound_ms(nbytes, 0)
    rec = dict(
        windows=[c.label for c in cases], anchors=num_anchors,
        descs=dc.shape[0],
        **timings(lambda: ops.desc_anchors(dc, out),
                  lambda: ops.desc_anchors_ref(dc, num_anchors),
                  lambda: torch.searchsorted(dc, grid, right=True,
                                             out_int32=True)),
        bound_ms=b, bound_by=by, bound_bytes=nbytes)
    log(f"kernel desc_anchors at {cases[0].label}: anchors {num_anchors} "
        f"desc_shape {dc.shape[0]}: ms {rec['ms']:.4f} (L2 flushed) "
        f"warm_ms {rec['warm_ms']:.4f} plain_ms {rec['plain_ms']:.4f} "
        f"library_ms {rec['library_ms']:.4f} (torch.searchsorted on a "
        f"prebuilt grid) bound_ms {b:.4f} ({by}, {nbytes} bytes); equal "
        f"to the plain version and the host table at "
        f"{', '.join(rec['windows'])}")
    return rec


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
        anchors=anchor_record(cases, device, timings),
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
        calls += megastep_ab_calls(part, max_items, device)
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


def megastep_ab_calls(part, max_items: int, device) -> list:
    """The megastep's timed calls for ``--ab``: the first K = 1, 2, 4, 8
    windows of shard 0 in a cap-8 buffer and shard 0's last window, each
    launched on its real rows (``shard0-k<K>``, ``shard0-last``); the
    K < 8 buffers also launched on all 8 rows, their zero rows included
    (``-cap8``: the launch before the megastep took a real count); and
    dispatches, each an upload from pinned memory then the launch, of the
    real rows (``dispatch-k<K>-real``) and of every row
    (``dispatch-k<K>-cap8``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.census_fused import OUT_WORDS, _keep_mode
    batch, cases, sched = shard_batch_case(part, max_items, device,
                                           BATCH_CAP)
    case = cases[0]
    steps = sched.steps_for(0)
    last = torch.from_numpy(sched.descriptors(0, steps - 1).device_words()
                            ).to(device)
    ref_args = (*case.iters, "none", True)

    def split(o):
        o = o.reshape(-1, OUT_WORDS)
        return o[:, :64].reshape(-1), o[:, 64:].reshape(-1)

    def call(buf, rows, host=None):
        """``run(lib)``: (an upload of the first ``rows`` rows of ``host``
        into ``buf``, then) one launch on ``buf``'s first ``rows`` rows."""
        run = lib_launch("census_fused_desc_batch_launch",
                         (*case.graph, buf, case.idx, rows, buf.shape[1],
                          sched.desc_shape, sched.num_anchors,
                          case.idx.numel(), _keep_mode("none", True)),
                         OUT_WORDS * rows, device, split)
        if host is None:
            return run

        def dispatch(lib):
            buf[:rows].copy_(host[:rows], non_blocking=True)
            return run(lib)
        return dispatch

    calls = []
    for k in (*BATCH_KS, "last"):
        rows = last[None] if k == "last" else batch[:k]
        real = rows.shape[0]
        buf = torch.zeros_like(batch)
        buf[:real] = rows
        want = ops.fused_census_desc_partials_batch_ref(
            *case.graph, buf, case.idx, *ref_args)
        label = f"shard0-{k}" if k == "last" else f"shard0-k{k}"
        flat = [tuple(t[:n].reshape(-1) for t in want)
                for n in (real, buf.shape[0])]
        calls.append(("census_fused_desc_batch_launch", label, flat[0],
                      call(buf, real)))
        if k == "last":
            continue
        if real < buf.shape[0]:
            calls.append(("census_fused_desc_batch_launch", f"{label}-cap8",
                          flat[1], call(buf, buf.shape[0])))
        host = buf.cpu().pin_memory()
        calls.append(("census_fused_desc_batch_launch",
                      f"dispatch-k{k}-real", flat[0],
                      call(torch.empty_like(buf), real, host)))
        calls.append(("census_fused_desc_batch_launch",
                      f"dispatch-k{k}-cap8", flat[1],
                      call(torch.empty_like(buf), buf.shape[0], host)))
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
    desc kernel's launches and summed time, the ``desc_anchors`` kernel's
    launches, and the time any device activity (kernel, copy, memset) was
    running (ms, union of spans)."""
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
                 kernel_launches=0, kernel_ms=None, busy_ms=None,
                 anchor_launches=0)
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
                 anchor_launches=sum("desc_anchors" in e.name
                                     for e in activity),
                 kernel_ms=sum(e.time_range.elapsed_us()
                               for e in kernels) / 1e3,
                 busy_ms=busy_us / 1e3)
    return split


def held_run(label: str, g, device, orient: str, max_items: int,
             w0: int) -> dict:
    """Fused engine run, traced, held to the plain torch engine and to
    C(n, 3); its desc-kernel and ``desc_anchors`` launches must each equal
    its window count on the card, in the wrappers' counters and in the
    trace."""
    import torch
    from repro_torch.kernels import ops
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = ops.fused_census_desc_partials.launches
    tables = ops.desc_anchors.launches
    with torch.profiler.profile(activities=activities) as prof:
        census, st, wall = census_run(g, device, "fused", orient, max_items)
    launches = ops.fused_census_desc_partials.launches - before
    expect = st.chunks if device.type == "cuda" else 0
    require(launches == expect,
            f"{label}/{orient}: desc kernel launched {launches} times for "
            f"{st.chunks} windows")
    tables = ops.desc_anchors.launches - tables
    require(tables == expect,
            f"{label}/{orient}: desc_anchors launched {tables} times for "
            f"{st.chunks} windows")
    split = trace_split(prof, device)
    require(split["kernel_launches"] == expect,
            f"{label}/{orient}: the trace holds {split['kernel_launches']} "
            f"desc kernels for {st.chunks} windows")
    require(split["anchor_launches"] == expect,
            f"{label}/{orient}: the trace holds {split['anchor_launches']} "
            f"desc_anchors kernels for {st.chunks} windows")
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
        f"items/s) desc launches {launches}, desc_anchors launches "
        f"{tables}; torch engine wall "
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


def row_work(case: DescCase, want) -> dict:
    """One megastep row's share of a batch's bound: its valid count,
    the words it must read of its own (num_valid, the anchors and the
    descriptors its valid lanes use), its int32 operations and its
    pairs (whose graph words the batch reads once)."""
    import torch
    work = desc_work(case, want)
    pair, _, _, valid = work["items"]
    an = case.window[4]
    a = (case.idx // 16).clamp(0, an.shape[0] - 1)
    pairs = torch.unique(pair[valid])
    return dict(valid=int(case.window[0][0]), ops=work["bound_ops"],
                pairs=pairs,
                words=(1 + torch.unique(a[valid]).numel()
                       + 3 * pairs.numel()))


def batch_bound(graph, idx, works) -> tuple:
    """The bound of a batch of rows: the index array once, each row's own
    words, the graph words of the union of the rows' pairs and 67 output
    words a row; their operations.  Returns (ms, by, bytes)."""
    import torch
    indptr, _, pair_u, pair_v, _ = graph
    union = torch.unique(torch.cat([w["pairs"] for w in works]))
    nwords = (idx.numel() + sum(w["words"] for w in works)
              + graph_words_read(indptr, pair_u, pair_v, union)
              + 67 * len(works))
    b, by = bound_ms(4 * nwords, sum(w["ops"] for w in works))
    return b, by, 4 * nwords


def ptxas_usage(build_log: Path) -> dict:
    """Registers and static shared bytes of each census desc kernel, from
    ptxas' lines in a build log: the megastep, and the single-window
    kernel's main-path instance."""
    import re
    names = {"census_fused_desc_batch": "census_fused_desc_batch",
             "census_fused_descILb0E": "census_fused_desc"}
    usage, current = {}, None
    for line in build_log.read_text().splitlines():
        if "Compiling entry function" in line:
            current = next((v for k, v in names.items() if k in line), None)
        elif "Used" in line and current is not None:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            usage[current] = dict(registers=int(regs.group(1)),
                                  shared_bytes=int(smem.group(1))
                                  if smem else 0)
            current = None
    return usage


def batch_record(part, max_items: int, device, reps: int, flush,
                 timings) -> dict:
    """The megastep entry against its plain version and against one
    single-window launch per row of the same batch: one (8, words) launch
    vs 8 launches, L2 flushed and warm.  Then the measured batches: the
    first K = 1, 2, 4, 8 windows of shard 0, and shard 0's last window,
    each as the real rows of a cap-8 buffer, launched on those rows;
    each with its valid lanes, lanes a second and bound, and the time of
    a dispatch: the upload of its real rows from pinned memory and the
    launch, beside the upload of every row and a launch over every row
    (the feed before the megastep took a real count).  The bound counts
    each input once over the batch: the index array, each row's valid
    count, anchors and descriptors, and the graph words of the union of
    the rows' pairs.  Also ptxas' registers and shared bytes and the
    resident blocks per SM of the desc kernels."""
    import torch
    from repro_torch.core.planner import split_device_words
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.census_fused import desc_occupancy
    batch, cases, sched = shard_batch_case(part, max_items, device,
                                           BATCH_CAP)
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
    works = [row_work(case, (want[0][r], want[1][r]))
             for r, case in enumerate(cases)]
    b, by, nbytes = batch_bound(graph, idx, works)
    t = timings(kernel, plain)
    parallel, serial = shard_streams_ms(part, max_items, device, reps, flush)
    rec = dict(
        name="fused_census_desc_partials_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/census_fused.cu",
        replaces="src/repro/kernels/census_fused.py:187", launches=0,
        max_abs_err=max_abs_err(got, want), **t, bound_ms=b, bound_by=by,
        bound_bytes=nbytes, windows=len(cases),
        lanes=len(cases) * idx.numel(),
        valid_lanes=sum(w["valid"] for w in works),
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
        f"bound_ms {b:.4f} ({by}, {nbytes} bytes); equal to the plain "
        f"version and, row for row, to the single launches")
    log(f"kernel fused_census_desc_partials: window 0 of each of the 4 "
        f"shards, launched back to back on the 4 logical devices' streams "
        f"ms {parallel:.4f} (L2 flushed), on one stream ms {serial:.4f}: "
        f"the kernels of different shard streams "
        + ("overlap on the card" if parallel < 0.9 * serial
           else "do not overlap much on the card"))

    # the measured batches: K real rows of a cap-8 buffer, and the last
    # window alone
    steps = sched.steps_for(0)
    last = DescCase(f"shard0-w{steps - 1}", graph, split_device_words(
        torch.from_numpy(sched.descriptors(0, steps - 1).device_words()
                         ).to(device), sched.num_anchors), idx,
        cases[0].iters, "none")
    last_want = ops.fused_census_desc_partials_ref(*last.args())
    measured = [(f"k{k}", batch[:k], want[0][:k], want[1][:k], works[:k])
                for k in BATCH_KS]
    measured.append(("last", torch.cat(last.window).reshape(1, -1),
                     last_want[0][None], last_want[1][None],
                     [row_work(last, last_want)]))
    cuda = device.type == "cuda"
    rec["batches"] = []
    for label, rows, hist, inter, row_works in measured:
        k = rows.shape[0]
        buf = torch.zeros_like(batch)
        buf[:k] = rows
        host = buf.cpu().pin_memory() if cuda else buf.clone()
        dev = torch.empty_like(buf)

        def launch(buf=buf, k=k):
            return ops.fused_census_desc_partials_batch(*graph, buf, idx,
                                                        *args, real=k)

        def dispatch(host=host, dev=dev, k=k):
            dev[:k].copy_(host[:k], non_blocking=True)
            return ops.fused_census_desc_partials_batch(*graph, dev, idx,
                                                        *args, real=k)

        def dispatch_all(host=host, dev=dev):
            dev.copy_(host, non_blocking=True)
            return ops.fused_census_desc_partials_batch(*graph, dev, idx,
                                                        *args)

        for fn in (launch, dispatch, dispatch_all):
            out = fn()
            require(torch.equal(out[0][:k], hist)
                    and torch.equal(out[1][:k], inter)
                    and not bool(out[0][k:].any())
                    and not bool(out[1][k:].any()),
                    f"megastep at {label} ({fn.__name__}) != the plain "
                    f"version's rows")
        bb, bby, bbytes = batch_bound(graph, idx, row_works)
        valid = sum(w["valid"] for w in row_works)
        entry = dict(batch=label, real=k, cap=BATCH_CAP, valid_lanes=valid,
                     ms=timed_ms(launch, device, reps, flush),
                     warm_ms=timed_ms(launch, device, reps),
                     dispatch_ms=timed_ms(dispatch, device, reps, flush),
                     dispatch_all_rows_ms=timed_ms(dispatch_all, device,
                                                   reps, flush),
                     upload_bytes=4 * k * buf.shape[1],
                     upload_all_rows_bytes=4 * buf.numel(),
                     bound_ms=bb, bound_by=bby, bound_bytes=bbytes)
        entry["lanes_per_s"] = valid / (entry["ms"] / 1e3)
        rec["batches"].append(entry)
        log(f"kernel fused_census_desc_partials_batch at {label} ({k} real "
            f"rows of {BATCH_CAP}, valid lanes {valid}): ms "
            f"{entry['ms']:.4f} (L2 flushed) warm_ms {entry['warm_ms']:.4f}"
            f" lanes/s {entry['lanes_per_s']:.4e} bound_ms {bb:.4f} ({bby})"
            f" = {bb / entry['ms']:.2%}; dispatch (upload "
            f"{entry['upload_bytes']} B of its rows + launch) ms "
            f"{entry['dispatch_ms']:.4f}, with every row uploaded "
            f"({entry['upload_all_rows_bytes']} B) and launched ms "
            f"{entry['dispatch_all_rows_ms']:.4f}; equal to the plain "
            f"version")
    if cuda:
        usage = ptxas_usage(build.build().parent / "build.log")
        rec["ptxas"] = usage
        rec["occupancy"] = desc_occupancy(device)
        log(f"kernel census desc resources: ptxas {usage}; resident blocks "
            f"per SM {rec['occupancy']}")
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


def async_run(g, part, device, max_items: int) -> dict:
    """The partitioned phase's first run alone: the main graph's 1D async
    orient-none run over 4 logical devices at megastep cap 8, on the
    prebuilt partition ``part``, ``AB_RUN_WALLS`` times untraced (host
    clock after a synchronize), then once traced (device busy: the union
    of its kernel, copy and memset spans).  Every census must be equal
    and sum to C(n, 3).  Only names that every version of the package
    since the megastep has are used, so another commit's package can run
    it (``--ab-tree``)."""
    import torch
    from repro_torch import CensusEngine, default_devices
    from repro_torch.kernels import ops
    total = g.n * (g.n - 1) * (g.n - 2) // 6
    engine = CensusEngine(devices=default_devices(4), backend="fused",
                          partition=True, max_windows_per_dispatch=8)

    def run():
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        census = engine.run(g, max_items=max_items, orient="none", part=part)
        torch.cuda.synchronize()
        return census, time.perf_counter() - t0

    walls, censuses = [], []
    for _ in range(AB_RUN_WALLS):
        census, wall = run()
        walls.append(wall)
        censuses.append(census)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        census, traced = run()
    censuses.append(census)
    require(all((c == census).all() for c in censuses)
            and int(census.sum()) == total,
            "the async runs' censuses differ or miss C(n, 3)")
    split = trace_split(prof, device)
    st = engine.stats
    return dict(walls_s=walls, traced_wall_s=traced,
                busy_ms=split["busy_ms"], kernel_ms=split["kernel_ms"],
                idle=1 - split["busy_ms"] / 1e3 / traced,
                dispatches=st.dispatches_total,
                launches=ops.fused_census_desc_partials_batch.launches,
                census=census.tolist())


def ab_tree_phase(tree: Path) -> None:
    """``async_run`` with the package of ``tree/src`` (another commit's
    checkout) against this checkout's, in turns -- this, the other, the
    other, this -- each in a process of its own (``--async-run``), which
    builds its package's kernels and the main graph and partition
    anew.  Prints a line per turn and ``{"ab_tree": [...]}``."""
    srcs = {"package": ROOT / "src", str(tree): tree.resolve() / "src"}
    require(srcs[str(tree)].is_dir(), f"--ab-tree {tree}: no src/ there")
    turns = []
    for turn, name in enumerate(["package", str(tree), str(tree),
                                 "package"]):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--async-run",
             str(srcs[name])], capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0,
                f"--async-run with {name} failed:\n{proc.stdout[-3000:]}\n"
                f"{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])["async_run"]
        turns.append(dict(tree=name, turn=turn, **res))
        log(f"ab tree 1d async none cap 8 turn {turn} {name}: walls "
            f"{', '.join(f'{w:.4f}' for w in res['walls_s'])} s, traced "
            f"{res['traced_wall_s']:.4f} s, device busy {res['busy_ms']:.4f}"
            f" ms (megastep kernels {res['kernel_ms']:.4f} ms), idle "
            f"{res['idle']:.4%}, dispatches {res['dispatches']}, megastep "
            f"launches {res['launches']}")
    require(len({tuple(t["census"]) for t in turns}) == 1,
            "the trees' censuses differ")
    print(json.dumps({"ab_tree": [{k: v for k, v in t.items()
                                   if k != "census"} for t in turns]}))


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


def lm_cut_model(cfg, params, n: int):
    """(the config cut to its first ``n`` layers, a copy of ``params``'
    first ``n`` layers and top-level leaves on the CPU)."""
    import dataclasses
    from repro_torch.models import model
    cut_cfg = dataclasses.replace(cfg, num_layers=n)
    keep = {k: v for k, v in params.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}
    small = model.LanguageModel(cut_cfg, device="cpu")
    small.load_state_dict(keep)
    return cut_cfg, small


def lm_cut_hold(label, cfg, params, device, q_chunk: int, cut: dict
                ) -> dict:
    """Hold (c): ``params`` cut to ``cut["layers"]`` layers of the full
    width, on the card and on the CPU path: the prefill's and
    ``cut["steps"]`` teacher-forced decode steps' logits (tokens: the
    card's greedy ones)."""
    import torch
    from repro_torch.models import model
    from repro_torch.serve import engine
    cut_cfg, small = lm_cut_model(cfg, params, cut["layers"])
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


def lm_stepwise_hold(label, cfg, params, device, q_chunk: int, cut: dict
                     ) -> dict:
    """Hold (c) for a model whose recurrence is chaotic at this width
    (xLSTM: the reference's fan-in rule draws the sLSTM's recurrent
    weights at std 0.5, ROADMAP §3), where two paths that round apart
    part within ~20 positions, so that logits over a prompt cannot be
    held card against CPU.  ``params`` cut to ``cut["layers"]`` layers:

    * the prefill's logits, card against CPU, are printed beside the
      CPU path's own deviation when one element of a prompt token's
      embedding moves by one bfloat16 step;
    * each non-sLSTM layer's prefill, from the CPU path's input to it,
      and each of ``cut["steps"]`` teacher-forced decode steps (the
      card's greedy tokens), from the CPU path's cache at that step, are
      held card against CPU at ``LM_CORR`` / ``LM_REL`` (the sLSTM's
      prefill is the decode step's function over the prompt).
    """
    import torch
    from repro_torch.models import model
    from repro_torch.serve import engine
    cut_cfg, small = lm_cut_model(cfg, params, cut["layers"])
    cpu_w = model.compute_copy(small)
    card_w = model.compute_copy(small, device=device)
    req = lm_request(cut_cfg, cut["batch"], cut["prompt"], seed=7)
    p, v = cut["prompt"], cfg.vocab_size
    cap = p + cut["steps"] + 8
    eng = engine.ServeEngine(cut_cfg, small, max_seq_len=cap,
                             q_chunk=q_chunk, device=device)
    tokens = torch.as_tensor(
        lm_generate(eng, req, cut["steps"])[:, p:]).long()
    del eng

    def deviation(got, want):
        got = got[:, -1, :v].float().cpu().numpy().ravel()
        want = want[:, -1, :v].float().cpu().numpy().ravel()
        return (float(np.corrcoef(got, want)[0, 1]),
                float(np.abs(got - want).max() / np.abs(want).max()))

    worst = dict(corr=1.0, rel=0.0)

    def held(what, got, want):
        out = lm_hold(f"{label} (c) {what}", got, want)
        worst.update(corr=min(worst["corr"], out["corr"]),
                     rel=max(worst["rel"], out["rel"]))

    with torch.inference_mode():
        cpu_logits, cpu_caches = model.serve_prefill(
            cut_cfg, cpu_w, lm_batch(req, "cpu"), q_chunk=q_chunk)
        card_logits, _ = model.serve_prefill(
            cut_cfg, card_w, lm_batch(req, device), q_chunk=q_chunk)
        prefill = deviation(card_logits, cpu_logits)
        # the CPU path against itself, one bfloat16 step in one input
        row = int(req["tokens"][0, 0])
        old = cpu_w.embed[row, 0].clone()
        cpu_w.embed[row, 0] = torch.nextafter(
            old, torch.tensor(100.0, dtype=old.dtype))
        moved, _ = model.serve_prefill(cut_cfg, cpu_w, lm_batch(req, "cpu"),
                                       q_chunk=q_chunk)
        cpu_w.embed[row, 0] = old
        own = deviation(moved, cpu_logits)
        # each non-sLSTM layer's prefill from the CPU path's input
        batch = lm_batch(req, "cpu")
        x = model.embed_tokens(cut_cfg, cpu_w, batch)
        b, s_len, _ = x.shape
        ctx = dict(positions=torch.arange(
                       s_len, dtype=torch.int32).expand(b, s_len),
                   causal=True, q_chunk=q_chunk, rec_chunk=256,
                   want_cache=True, enc_out=None)
        card_ctx = dict(ctx, positions=ctx["positions"].to(device))
        sigs, carried, _ = model.carried_inputs(
            model.layer_groups(cut_cfg))
        s = None
        for i, (sig, carry) in enumerate(zip(sigs, carried)):
            s_in = None if carry else s
            nx, aux = model.apply_block(cut_cfg, sig, cpu_w.layers[i], x,
                                        ctx, s_in)
            if sig[0] != "slstm":
                gx, gaux = model.apply_block(
                    cut_cfg, sig, card_w.layers[i], x.to(device), card_ctx,
                    None if s_in is None else s_in.to(device))
                held(f"layer {i} ({sig[0]}) prefill output", gx, nx)
                for j, (g, w) in enumerate(zip(
                        gaux["cache"]["state"], aux["cache"]["state"])):
                    held(f"layer {i} prefill state {j}", g, w)
            x, s = nx, aux["sum"]
        # each decode step from the CPU path's cache
        cache = engine.prefill_to_decode_cache(cut_cfg, cpu_caches, p, cap)
        for t in range(tokens.shape[1]):
            card_cache = dict(cache, layers=[
                {k: a.to(device) for k, a in e.items()}
                for e in cache["layers"]])
            tok = tokens[:, t:t + 1]
            got, _ = model.decode_step(cut_cfg, card_w, tok.to(device),
                                       card_cache)
            want, cache = model.decode_step(cut_cfg, cpu_w, tok, cache)
            held(f"step {t} from the CPU's cache", got[:, -1, :v],
                 want[:, -1, :v])
    return dict(worst, prefill=prefill, own=own)


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
        return dict(kernels=None, busy_ms=None, wall_ms=None, idle=None,
                    top=[])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw events: building ``prof.events()``' tree takes ~50 µs an
    # event, minutes for a request of a few hundred thousand launches
    activity = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
                and not e.name().startswith("serve.")]
    kernels = [e for e in activity
               if not e.name().startswith(("Memcpy", "Memset"))]
    busy_ns, reach = 0, float("-inf")
    for lo, hi in sorted((e.start_ns(), e.end_ns()) for e in activity):
        busy_ns += max(0, hi - max(lo, reach))
        reach = max(reach, hi)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + (e.end_ns() - e.start_ns()) / 1e6, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(kernels=len(kernels), busy_ms=busy_ns / 1e6,
                wall_ms=wall_ms, idle=1.0 - busy_ns / 1e6 / wall_ms,
                top=top)


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
               params=n_params, cfg=cfg, batch=b, cache_slots=cap)
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


#: the recurrent part of the LM phase: both recurrent models at full width
#: and depth (batch, prompt, new tokens), and the depth hold (c) cuts them
#: to (every block kind once: sLSTM + mLSTM; RG-LRU, RG-LRU, local
#: attention); xlstm's sLSTM recurrence is chaotic at full width, so its
#: hold (c) is stepwise (``lm_stepwise_hold``)
LM_RECURRENT = (dict(arch="xlstm-1.3b", batch=8, prompt=512, new=64, cut=2,
                     stepwise=True),
                dict(arch="recurrentgemma-2b", batch=4, prompt=2048, new=64,
                     cut=3, stepwise=False))


def lm_decode_bytes(cfg, weights, batch: int, capacity: int) -> dict:
    """The bytes one decode step must move: every weight it reads once
    (the embedding gather's rows aside; the RG-LRU gate matrices' bfloat16
    twins, which only the prefill reads, aside), every recurrent state
    read and written, and each attention layer's KV cache (a local
    layer's ring) read, with its new slot written."""
    from repro_torch.models import model
    w = sum(t.numel() * t.element_size()
            for name, t in weights.named_parameters()
            if not name.endswith("_bf16")
            and (name != "embed" or cfg.tie_embeddings))
    cache = model.init_cache(cfg, batch, capacity, device="meta")
    states = kv = 0
    for (kind, _), entry in zip(model.layer_sigs(cfg), cache["layers"]):
        size = sum(t.numel() * t.element_size() for t in entry.values())
        if kind in model.STATE_KEYS:
            states += 2 * size
        else:
            kv += size + size // entry["k"].shape[1]
    return dict(weights=w, states=states, kv=kv, total=w + states + kv)


def lm_recurrent_phase(device, rehearse: bool) -> list:
    """xlstm-1.3b and recurrentgemma-2b served at full width and depth
    through ``ServeEngine``, each held as the module docstring says;
    returns each model's numbers."""
    import torch
    from repro_torch.models import model
    from repro_torch.serve import engine
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    q_chunk = LM_MAIN["q_chunk"]
    results = []
    for cell in LM_RECURRENT:
        cell, cut = dict(cell), dict(LM_CUT, layers=cell["cut"])
        if rehearse:
            cell.update(batch=2, prompt=24, new=4)
            cut.update(prompt=16, steps=3)
            q_chunk = 8
        cfg = lm_config(cell["arch"], None, rehearse)
        b, p, new = cell["batch"], cell["prompt"], cell["new"]
        cap = p + new + 8
        t0 = time.perf_counter()
        marks = [("start", t0)]

        params = model.make_params(cfg, seed=0, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in params.parameters())
        p_bytes = sum(t.numel() * t.element_size()
                      for t in params.parameters())
        eng = engine.ServeEngine(cfg, params, max_seq_len=cap,
                                 q_chunk=q_chunk, device=device)
        by_dtype = {}
        for t in eng.weights.parameters():
            key = str(t.dtype).split(".")[-1]
            by_dtype[key] = by_dtype.get(key, 0) + t.numel() * t.element_size()
        kinds = [kind for kind, _ in model.layer_sigs(cfg)]
        label = f"lm {cfg.name}"
        log(f"{label}: {cfg.num_layers} layers ("
            + ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(
                kinds))
            + f"), d_model {cfg.d_model}, {cfg.num_heads} heads, vocab "
            f"{cfg.vocab_size} (padded {model.pad_vocab(cfg.vocab_size)}): "
            f"{n_params} parameters, {p_bytes} bytes float32, initialised "
            f"in {init_s:.3f} s; compute copy "
            f"{sum(by_dtype.values())} bytes ("
            + ", ".join(f"{k} {v}" for k, v in sorted(by_dtype.items()))
            + ")")
        marks.append(("init", time.perf_counter()))
        req = lm_request(cfg, b, p, seed=0)
        _, timing = lm_hold_a(label, eng, cfg, req, new)
        marks.append(("(a)", time.perf_counter()))
        step_ms = timing["decode_ms"] / new
        moved = lm_decode_bytes(cfg, eng.weights, b, cap)
        bound = moved["total"] / HBM_BYTES_PER_S * 1e3
        traced = lm_trace(lambda: lm_generate(eng, req, new), device)
        prefill_only = lm_trace(lambda: lm_generate(eng, req, 0), device)
        marks.append(("traces", time.perf_counter()))
        per_step = (None if traced["kernels"] is None else
                    (traced["kernels"] - prefill_only["kernels"]) / new)
        out = dict(arch=cfg.name, params=n_params,
                   prefill_ms=timing["prefill_ms"], decode_step_ms=step_ms,
                   prefill_tok_s=b * p / timing["prefill_ms"] * 1e3,
                   decode_tok_s=b / step_ms * 1e3, bound_ms=bound,
                   launches_per_step=per_step,
                   launches_prefill=prefill_only["kernels"],
                   idle=traced["idle"])
        log(f"{label} serve: batch {b}, prompt {p}, {new} new tokens, 2 "
            f"greedy requests: prefill {timing['prefill_ms']:.4f} ms "
            f"({out['prefill_tok_s']:.1f} tokens/s), decode {step_ms:.4f} "
            f"ms/step ({out['decode_tok_s']:.1f} tokens/s); decode bound "
            f"{bound:.4f} ms ({moved['weights']} weight bytes + "
            f"{moved['states']} bytes of recurrent state read and written "
            f"+ {moved['kv']} bytes of KV ring = {moved['total']} bytes / "
            f"3.35 TB/s); greedy repeatable, prompt echoed, ids < vocab")
        untraced_ms = timing["prefill_ms"] + timing["decode_ms"]
        out["idle_untraced"] = (None if traced["busy_ms"] is None
                                else 1 - traced["busy_ms"] / untraced_ms)
        log(f"{label} trace: one greedy request {traced['wall_ms']} ms wall "
            f"under the profiler, device busy {traced['busy_ms']} ms, idle "
            f"share {traced['idle']} (of the untraced request's "
            f"{untraced_ms} ms on the card's clock: {out['idle_untraced']})"
            f"; kernels {traced['kernels']}, {prefill_only['kernels']} of "
            f"them in the prefill alone (prefill ms under the profiler "
            f"{prefill_only['wall_ms']}): {per_step} launches per decode "
            f"step")
        corr_b = lm_prefill_vs_decode(cfg, eng.weights, req, device, cap,
                                      q_chunk)
        require(corr_b >= 0.999, f"{label} (b): prefill vs decode corr "
                f"{corr_b} < 0.999")
        out["corr_b"] = corr_b
        marks.append(("(b)", time.perf_counter()))
        del eng
        cut_kinds = ", ".join(kinds[:cut["layers"]])
        if cell["stepwise"]:
            held_c = lm_stepwise_hold(label, cfg, params, device, q_chunk,
                                      cut)
            what = (f"(c) {cut['layers']} layers ({cut_kinds}) card vs cpu:"
                    f" prefill logits corr {held_c['prefill'][0]:.7f}, max "
                    f"diff / max {held_c['prefill'][1]:.5f} (not held: the "
                    f"cpu path's own deviation under one bfloat16 step of "
                    f"one embedding element is corr {held_c['own'][0]:.7f},"
                    f" max diff / max {held_c['own'][1]:.5f}); the mLSTM "
                    f"layer's prefill from the cpu's input and "
                    f"{cut['steps']} teacher-forced steps each from the "
                    f"cpu's cache")
        else:
            held_c = lm_cut_hold(label, cfg, params, device, q_chunk, cut)
            what = (f"(c) {cut['layers']} layers ({cut_kinds}) card vs cpu,"
                    f" prefill + {cut['steps']} teacher-forced steps")
        out["held_c"] = held_c
        marks.append(("(c)", time.perf_counter()))
        log(f"{label} holds: (a) yes; (b) prefill(P) vs prefill(P-1) + "
            f"decode corr {corr_b:.6f} (>= 0.999); {what}: min corr "
            f"{held_c['corr']:.7f} (>= {LM_CORR}), max diff / max "
            f"{held_c['rel']:.5f} (<= {LM_REL}); seconds: "
            + ", ".join(f"{name} {t - marks[i][1]:.3f}"
                        for i, (name, t) in enumerate(marks[1:]))
            + f"; phase at {time.perf_counter() - t_phase:.3f} s")
        del params
        results.append(out)
    return results


#: the LM training phase: qwen2-0.5b at full width and depth on
#: train_4k's sequence length (micro-batch, accumulation, steps,
#: checkpoint interval, the step whose first attempt fails), with remat
LM_TRAIN = dict(arch="qwen2-0.5b", seq=4096, micro=2, grad_accum=4, steps=8,
                ckpt_every=4, fail_at=4, q_chunk=512)
#: the card's dense bfloat16 peak (NVIDIA's H100 SXM data sheet)
BF16_FLOPS_PER_S = 989e12
#: holds (b)/(c): each config cut at full width (arch, changes), one
#: batch of (rows, positions), card against the CPU path
LM_TRAIN_CUTS = (("qwen2-0.5b", dict(num_layers=2)),
                 ("granite-moe-3b-a800m", dict(num_layers=2)),
                 ("recurrentgemma-2b", dict(num_layers=3)),
                 ("xlstm-1.3b", dict(num_layers=2, block_pattern=("mlstm",))))
LM_TRAIN_CUT_SHAPE = (1, 512)
#: hold (b) for the attention biases (``bq``/``bk``/``bv``): each is added
#: in bfloat16, so its gradient is a bfloat16 sum over the positions
LM_TRAIN_BIAS_CORR = 0.9998
#: hold (d): the replay checked on qwen2-0.5b cut to 2 layers (steps,
#: checkpoint interval, failing step, rows, positions)
LM_TRAIN_REPLAY = dict(steps=4, ckpt_every=2, fail_at=3, rows=2, seq=512)


def lm_train_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 · parameters · tokens for the
    matrices (the tied embedding counted once, as the head), plus
    attention's 12 · layers · heads · head_dim · seq per token (scores
    and values, forward and backward, the causal mask not subtracted);
    remat's recomputation not counted."""
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq
    return float(tokens) * (6 * n_params + attn)


def lm_corr_rel(got, want) -> tuple[float, float]:
    """(correlation, max |got - want| / max |want|) of two tensors on one
    device, in float64 there (a 655M-element leaf in seconds)."""
    g, w = got.double().ravel(), want.double().ravel()
    scale = float(w.abs().max())
    if scale == 0:
        return float(not bool(g.abs().any())), 0.0
    gc, wc = g - g.mean(), w - w.mean()
    corr = float((gc @ wc) / ((gc @ gc) * (wc @ wc)).sqrt())
    return corr, float((g - w).abs().max()) / scale


def lm_grad_hold(label, cfg, changes, device, shape, q_chunk) -> str:
    """Holds (b)/(c): ``cfg`` cut by ``changes`` at full width, seeded
    weights made on the card and copied to the CPU; one batch's loss and
    every leaf's gradient, card against the CPU path, at ``LM_CORR``
    (``LM_TRAIN_BIAS_CORR`` for the attention biases).  An MoE config's
    router reads bfloat16 activations that the two paths round apart, so
    a token near a tie routes to another expert on each: its gradients
    are printed, not held, and its loss, ``moe_aux_loss`` and
    ``dropped_tokens`` are held instead."""
    import dataclasses
    import torch
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.models import model
    cut = dataclasses.replace(cfg, **changes)
    rows, seq = shape
    card_m = model.make_params(cut, seed=0, device=device, trainable=True)
    cpu_m = model.LanguageModel(cut, device="cpu").requires_grad_()
    cpu_m.load_state_dict(card_m.state_dict())
    batch = TokenPipeline(DataConfig(vocab_size=cut.vocab_size, batch=rows,
                                     seq_len=seq)).batch_at(0)
    out = {}
    for where, m in (("cpu", cpu_m), ("card", card_m)):
        t0 = time.perf_counter()
        loss, metrics = model.loss_fn(
            cut, m, device_batch(batch, m.embed.device), q_chunk=q_chunk,
            rec_chunk=256)
        names, leaves = zip(*m.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        out[where] = (loss.item(), {k: v.detach().cpu() for k, v in
                                    metrics.items()},
                      dict(zip(names, grads)), time.perf_counter() - t0)
    (l_cpu, m_cpu, g_cpu, s_cpu), (l_card, m_card, g_card, s_card) = (
        out["cpu"], out["card"])
    require(np.isfinite(l_card) and all(bool(torch.isfinite(g).all())
                                        for g in g_card.values()),
            f"{label}: loss or gradients not finite on the card")
    d_loss = abs(l_card - l_cpu) / abs(l_cpu)
    require(d_loss <= 1e-3, f"{label}: loss card {l_card} vs cpu {l_cpu}")
    worst, worst_rel, worst_name = float("inf"), 0.0, ""
    for name, want in g_cpu.items():
        corr, rel = lm_corr_rel(g_card[name], want.to(device))
        bound = (LM_TRAIN_BIAS_CORR if name.rsplit(".", 1)[-1] in (
            "bq", "bk", "bv") else LM_CORR)
        require(cut.is_moe or corr >= bound, f"{label}: gradient of {name} "
                f"card vs cpu corr {corr} < {bound}")
        if corr < worst:
            worst, worst_name = corr, name
        worst_rel = max(worst_rel, rel)
    held = (f"min corr {worst:.7f} ({worst_name}; >= {LM_CORR}, the "
            f"attention biases >= {LM_TRAIN_BIAS_CORR})")
    if cut.is_moe:
        held = (f"min corr {worst:.7f} ({worst_name}), "
                + ", ".join(f"{key} card {float(m_card[key])} cpu "
                            f"{float(m_cpu[key])}" for key in (
                                "moe_aux_loss", "dropped_tokens"))
                + " (not held: bfloat16 router logits round apart, so "
                  "tokens near a tie route differently)")
    kinds = ", ".join(k for k, _ in model.layer_sigs(cut))
    return (f"{label} {cut.num_layers} layers ({kinds}), batch {rows} x "
            f"{seq}: loss card {l_card:.6f} cpu {l_cpu:.6f} (|d| / loss "
            f"{d_loss:.2e} <= 1e-3); {len(g_cpu)} leaves' gradients {held},"
            f" max diff / max {worst_rel:.5f}; seconds card {s_card:.3f} "
            f"cpu {s_cpu:.3f}")


def lm_train_run(cfg, device, steps, ckpt_every, fail_at, rows, seq,
                 grad_accum, q_chunk, ckpt_dir: Path, on_step=None):
    """``steps`` AdamW steps of ``cfg`` (seeded weights, remat) under the
    port's ``Coordinator``, checkpoints every ``ckpt_every`` steps into
    ``ckpt_dir``, the first attempt of step ``fail_at`` (None: none)
    failing after its update -> (final state, history, coordinator)."""
    import shutil
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.models import model
    from repro_torch.train import (
        CheckpointManager, Coordinator, OptConfig, build_train_step,
        init_state)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    params = model.make_params(cfg, seed=0, device=device, trainable=True)
    from repro_torch.configs.base import ShapeSpec
    step_fn, _, _ = build_train_step(
        cfg, None, ShapeSpec("smoke", "train", seq, rows * grad_accum),
        OptConfig(lr=3e-4, warmup_steps=2, total_steps=steps),
        q_chunk=q_chunk, remat=True, grad_accum=grad_accum)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=rows * grad_accum, seq_len=seq,
                                    seed=0))
    injected = {"done": fail_at is None}

    def step(st, batch):
        t0 = time.perf_counter()
        p, o, m = step_fn(st["params"], st["opt"], batch)
        if not injected["done"] and int(st["step"]) == fail_at:
            injected["done"] = True    # after the in-place update
            raise RuntimeError("injected failure after the update")
        m = {k: float(v) for k, v in m.items()}
        if device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        if on_step is not None:
            on_step(int(st["step"]), m, time.perf_counter() - t0)
        return {"params": p, "opt": o, "step": st["step"] + 1}, m

    coord = Coordinator(step, lambda s: device_batch(pipe.batch_at(s),
                                                     device),
                        CheckpointManager(ckpt_dir, keep=2),
                        ckpt_every=ckpt_every)
    state = {"params": params, "opt": init_state(params), "step": 0}
    state, last, hist = coord.run(state, 0, steps)
    require(last == steps, f"training stopped at step {last}")
    return state, hist, coord, step_fn, pipe


def lm_training_phase(device, rehearse: bool) -> dict:
    """qwen2-0.5b trained at full width and depth through the port's
    train step, data pipeline, checkpoints and ``Coordinator`` (one
    injected failure), then holds (a)-(e) as the module docstring says;
    returns the main cell's numbers."""
    import dataclasses
    import os
    import torch
    from repro_torch.data import device_batch
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    run, cut_shape = dict(LM_TRAIN), LM_TRAIN_CUT_SHAPE
    replay = dict(LM_TRAIN_REPLAY)
    if rehearse:
        run.update(seq=32, micro=2, grad_accum=2, steps=6, ckpt_every=2,
                   fail_at=3, q_chunk=16)
        cut_shape = (1, 32)
        replay.update(seq=32)
    cfg = lm_config(run["arch"], None, rehearse)
    rows, seq, accum = run["micro"], run["seq"], run["grad_accum"]
    tokens = rows * accum * seq
    n_params = model.count_params(cfg)
    flops = lm_train_flops(cfg, n_params, tokens, seq)
    ckpt_dir = ROOT / "build" / "lm_train_ckpt"
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = {}

    on_card = device.type == "cuda"

    def on_step(i, m, seconds):
        steps.setdefault(i, []).append((m, seconds))
        mfu = (f"{flops / seconds / BF16_FLOPS_PER_S:.4f}" if on_card
               else "not measured (cpu)")
        log(f"lm train {cfg.name} step {i}: loss {m['loss']:.5f} grad_norm "
            f"{m['grad_norm']:.5f} lr {m['lr']:.3e}; {seconds * 1e3:.3f} ms,"
            f" {tokens / seconds:.1f} tokens/s, MFU {mfu}")

    t0 = time.perf_counter()
    state, hist, coord, step_fn, pipe = lm_train_run(
        cfg, device, run["steps"], run["ckpt_every"], run["fail_at"], rows,
        seq, accum, run["q_chunk"], ckpt_dir, on_step)
    train_s = time.perf_counter() - t0
    peak_b = torch.cuda.max_memory_allocated() if on_card else None
    peak = f"{peak_b} bytes" if on_card else "not measured (cpu)"
    # (a) every loss and gradient norm finite
    losses = [h["loss"] for h in hist]
    require(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                for h in hist), f"lm train {cfg.name} (a): not finite")
    require(len(coord.restarts) == 1, f"lm train {cfg.name}: "
            f"{len(coord.restarts)} recoveries, not 1")
    # steady steps: the first attempt of each step after the first two
    warm = [s for i in sorted(steps) if i >= 2 for _, s in steps[i][:1]]
    step_s = float(np.median(warm))
    mfu = flops / step_s / BF16_FLOPS_PER_S if on_card else None
    resumed = run["fail_at"] // run["ckpt_every"] * run["ckpt_every"]
    log(f"lm train {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters; batch {rows * accum} x "
        f"{seq} ({rows} x {accum} accumulated, remat), {tokens} tokens/step;"
        f" {run['steps']} steps and {len(coord.restarts)} failed attempt in "
        f"{train_s:.3f} s (checkpoints every {run['ckpt_every']} under "
        f"build/, failure injected at step {coord.restarts[0]['step']} "
        f"after its update, resumed from the step-{resumed} checkpoint): "
        f"median step {step_s * 1e3:.3f} ms, {tokens / step_s:.1f} "
        f"tokens/s; model FLOPs/step {flops:.4e} (6 N tokens + attention), "
        f"MFU {'not measured (cpu)' if mfu is None else f'{mfu:.4f}'} of "
        f"{BF16_FLOPS_PER_S:.3e} bf16 FLOP/s (H100 SXM data sheet); peak "
        f"memory {peak}; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; phase at {time.perf_counter() - t_phase:.3f} s")

    # one traced step: launches and the idle share
    batch = device_batch(pipe.batch_at(run["steps"]), device)
    traced = lm_trace(lambda: step_fn(state["params"], state["opt"], batch),
                      device)
    idle_untraced = (None if traced["busy_ms"] is None else
                     1 - traced["busy_ms"] / (step_s * 1e3))
    log(f"lm train {cfg.name} trace: one step {traced['wall_ms']} ms wall "
        f"under the profiler, device busy {traced['busy_ms']} ms, idle share"
        f" {traced['idle']} (of the untraced median step's "
        f"{step_s * 1e3:.3f} ms: {idle_untraced}); {traced['kernels']} "
        f"kernel launches per step; device ms by kernel (launches): "
        + "; ".join(f"{name[:70]} {ms:.3f} ({n})"
                    for name, (ms, n) in traced["top"])
        + f"; phase at {time.perf_counter() - t_phase:.3f} s")
    state_bytes = sum(t.numel() * t.element_size() for t in [
        *state["params"].parameters(), *state["opt"]["mu"].values(),
        *state["opt"]["nu"].values(), state["opt"]["step"]])
    out = dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s, mfu=mfu,
               peak_bytes=peak, launches=traced["kernels"],
               idle=traced["idle"], idle_untraced=idle_untraced,
               losses=losses, cfg=cfg, seq=seq, batch=rows * accum,
               grad_accum=accum, q_chunk=run["q_chunk"], flops=flops,
               state_bytes=state_bytes, peak=peak_b)
    del state, step_fn
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (b), (c): cut models, card against the CPU path
    for arch, changes in LM_TRAIN_CUTS:
        base = lm_config(arch, None, rehearse)
        log(lm_grad_hold(f"lm train hold (b) {arch}", base, changes, device,
                         cut_shape, run["q_chunk"])
            + f"; phase at {time.perf_counter() - t_phase:.3f} s")

    # (d) the failure-injected run's final state against an uninterrupted
    # run's, under deterministic algorithms
    cut = dataclasses.replace(cfg, num_layers=2)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        finals = []
        for fail_at in (replay["fail_at"], None):
            st, _, co, _, _ = lm_train_run(
                cut, device, replay["steps"], replay["ckpt_every"], fail_at,
                replay["rows"], replay["seq"], 1, run["q_chunk"],
                ROOT / "build" / "lm_train_replay")
            finals.append((st, len(co.restarts)))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, fa), (b, fb) = finals
    require(fa == 1 and fb == 0, "lm train (d): recoveries")
    same = all(torch.equal(p, q) for p, q in zip(
        a["params"].parameters(), b["params"].parameters())) and all(
        torch.equal(a["opt"][k][n], b["opt"][k][n])
        for k in ("mu", "nu") for n in a["opt"][k])
    require(same and int(a["opt"]["step"]) == int(b["opt"]["step"]),
            "lm train (d): the recovered run's final state differs")
    log(f"lm train hold (d) {cut.name} {cut.num_layers} layers, "
        f"{replay['steps']} steps of {replay['rows']} x {replay['seq']}: "
        f"failure at step {replay['fail_at']} after its update, restored "
        f"from the step-{replay['ckpt_every']} checkpoint; final params, mu,"
        f" nu and step equal to an uninterrupted run's, bit for bit, under "
        f"torch.use_deterministic_algorithms; phase at "
        f"{time.perf_counter() - t_phase:.3f} s")
    del a, b, finals

    # (e) the example on the card
    example = load_example("train_lm_torch")
    res = example.main(["--steps", "40" if rehearse else "100",
                        "--device", str(device)])
    require(res["recoveries"] == 1 and res["final"] < res["first"],
            "lm train (e): the example did not recover once and learn")
    log(f"lm train hold (e) examples/train_lm_torch.py: {res['steps']} "
        f"steps in {res['seconds']:.3f} s, loss {res['first']:.4f} -> "
        f"{res['final']:.4f}, {res['recoveries']} recovery; phase at "
        f"{time.perf_counter() - t_phase:.3f} s")
    return out


#: the LM parallel phase: the parallel layer over logical devices (each a
#: stream on the one card).  (b) one granite-moe-3b-a800m MoE layer in
#: float32 on the hidden states of a (rows, positions) batch after layer
#: 0's attention, sharded on each mesh; the full-depth prefill through
#: ``moe_fn`` on the first; (c) granite cut to ``layers`` at full width,
#: ``steps`` train steps on ``mesh``; (d) qwen2-0.5b's 24 layers in
#: ``stages`` stages, ``micro`` microbatches of (rows, positions); (e)
#: qwen2-0.5b's gradients of ``shards`` micro-batches of (rows,
#: positions) all-reduced at each width of ``bits``
LM_PAR_MOE = dict(arch="granite-moe-3b-a800m", rows=4, seq=512,
                  meshes=((1, 4), (2, 2)), q_chunk=512)
LM_PAR_STEP = dict(arch="granite-moe-3b-a800m", layers=4, rows=1, seq=512,
                   steps=2, mesh=(1, 4), q_chunk=512, floor=1e-3)
LM_PAR_PIPE = dict(arch="qwen2-0.5b", stages=2, micro=4, rows=2, seq=512,
                   q_chunk=512)
LM_PAR_QUANT = dict(arch="qwen2-0.5b", shards=4, rows=1, seq=512,
                    bits=(8, 16), q_chunk=512)
#: (b)'s bound on the sharded layer against ``apply_moe`` on the card,
#: relative to the output's largest magnitude (float32 sums over 1,536
#: and 512 terms in GEMMs of other shapes; TF32 off)
LM_PAR_MOE_REL = 1e-5
#: (b) at capacity 1.25, the card against the CPU: outputs within this
#: much of their largest magnitude (as the serving phase's MoE hold)
LM_PAR_MOE_CPU_REL = 1e-4
#: (d)'s bound on the pipeline's gradient against the sequential one,
#: relative to each leaf's largest magnitude
LM_PAR_PIPE_REL = 1e-5


def lm_peak(device):
    import torch
    return (f"{torch.cuda.max_memory_allocated()} bytes"
            if device.type == "cuda" else "not measured (cpu)")


def lm_sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lm_par_placements(rehearse: bool) -> list:
    """Part (a): for each config at (16, 16) and (2, 16, 16), the
    placements of its parameters, optimizer state and a train_4k decode
    cache, all on ``meta``: the leaves each mesh axis shards, and the
    parameter + optimizer bytes each device holds."""
    from repro_torch.configs import SHAPES, all_configs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.inputs import decode_inputs
    from repro_torch.train import build_train_step
    lines = []
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in sorted(all_configs()):
            cfg = lm_config(arch, None, rehearse)
            _, shardings, abstract = build_train_step(
                cfg, mesh, SHAPES["train_4k"])
            _, cache, cache_sh = decode_inputs(cfg, SHAPES["train_4k"],
                                               mesh)
            counts = {}
            per_device = total = 0
            for part, place_tree, leaf_tree in (
                    ("params", shardings["params"], abstract["params"]),
                    ("opt", shardings["opt"], abstract["opt"]),
                    ("cache", cache_sh["cache"], cache)):
                leaf_of = lm_flat(leaf_tree)
                for path, place in lm_flat(place_tree).items():
                    leaf = leaf_of[path]
                    axes = {a for d in range(len(place.spec))
                            for a in place.parts(d)}
                    row = counts.setdefault(part, {"leaves": 0})
                    row["leaves"] += 1
                    for a in axes:
                        row[a] = row.get(a, 0) + 1
                    if part == "cache":
                        continue
                    nbytes = leaf.numel() * leaf.element_size()
                    total += nbytes
                    per_device += nbytes // int(np.prod(
                        [place.blocks(d) for d in range(len(place.spec))]))
            lines.append(
                f"lm parallel placements {arch} {mesh}: " + "; ".join(
                    f"{part} {row['leaves']} leaves, sharded over "
                    + ", ".join(f"{a} {row.get(a, 0)}"
                                for a in mesh.axis_names)
                    for part, row in counts.items())
                + f"; params + opt bytes per device {per_device} of "
                f"{total}")
    return lines


def lm_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(lm_flat(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(lm_flat(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def lm_par_moe(device, rehearse: bool) -> list:
    """Part (b): the sharded MoE at full width.  Held: one layer in
    float32 on real hidden states, capacity 16 against ``apply_moe`` on
    the card (``LM_PAR_MOE_REL``, equal ``expert_load``, no drops),
    capacity 1.25 against the same sharded path on the CPU.  Printed: the
    full-depth prefill through ``moe_fn`` on the first mesh against the
    grouped path."""
    import dataclasses
    import torch
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model, moe
    from repro_torch.models.moe_shard import make_sharded_moe
    from repro_torch.parallel.sharding import (
        batch_axes, moe_dispatch_plan, spec_for_axes)
    run = dict(LM_PAR_MOE)
    if rehearse:
        run.update(rows=2, seq=16, q_chunk=8)
    base = lm_config(run["arch"], None, rehearse)
    one = dataclasses.replace(base, num_layers=1)
    rows, seq = run["rows"], run["seq"]
    batch = device_batch(TokenPipeline(DataConfig(
        vocab_size=base.vocab_size, batch=rows, seq_len=seq,
        seed=1)).batch_at(0), device)
    params = model.make_params(one, seed=0, device=device)
    seen = {}

    def capture(p, h):             # layer 0's MoE input, then nothing
        seen["h"] = h
        return torch.zeros_like(h), {}
    with torch.no_grad():
        model.forward(one, params, batch, q_chunk=run["q_chunk"],
                      moe_fn=capture)
    h = seen["h"].float()
    p = {k: params.layers[0]["moe"][k].detach() for k in
         params.layers[0]["moe"].inits}
    p_cpu = {k: v.cpu() for k, v in p.items()}
    lines = []
    with torch.no_grad():
        want, want_m = moe.apply_moe(base, p, h, capacity_factor=16.0)
        for shape in run["meshes"]:
            mesh = make_host_mesh(shape, ("data", "model"), device=device)
            cpu_mesh = make_host_mesh(shape, ("data", "model"),
                                      device="cpu")
            fns = {}
            for where, m, cf in (("card", mesh, 16.0),
                                 ("card", mesh, 1.25),
                                 ("cpu", cpu_mesh, 1.25)):
                specs = {k: spec_for_axes(d.axes, d.shape, m)
                         for k, d in moe.moe_schema(base).items()}
                fns[where, cf] = make_sharded_moe(
                    base, m, batch_axes(m, rows), specs, capacity_factor=cf)
            fns["card", 16.0](p, h)                        # warm
            lm_sync(device)
            t0 = time.perf_counter()
            y16, m16 = fns["card", 16.0](p, h)
            lm_sync(device)
            ms16 = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            moe.apply_moe(base, p, h, capacity_factor=16.0)
            lm_sync(device)
            ms_grouped = (time.perf_counter() - t0) * 1e3
            err = float((y16 - want).abs().max() / want.abs().max())
            require(torch.equal(m16["expert_load"], want_m["expert_load"]),
                    f"lm parallel (b) {shape}: expert_load != apply_moe's")
            require(int(m16["dropped_tokens"]) == 0,
                    f"lm parallel (b) {shape}: tokens dropped at cf 16")
            require(err <= LM_PAR_MOE_REL, f"lm parallel (b) {shape}: "
                    f"max err / max {err} > {LM_PAR_MOE_REL}")
            y125, m125 = fns["card", 1.25](p, h)
            yc, mc = fns["cpu", 1.25](p_cpu, h.cpu())
            err_cpu = float((y125.cpu() - yc).abs().max() / yc.abs().max())
            for key in ("expert_load", "dropped_tokens"):
                require(torch.equal(m125[key].cpu(), mc[key]),
                        f"lm parallel (b) {shape} cf 1.25: {key} card != "
                        f"cpu")
            require(err_cpu <= LM_PAR_MOE_CPU_REL, f"lm parallel (b) "
                    f"{shape} cf 1.25: card vs cpu {err_cpu}")
            ep = base.num_experts % mesh.axis_size("model") == 0
            lines.append(
                f"lm parallel (b) {base.name} MoE layer f32, {rows} x {seq}"
                f" tokens after layer 0's attention, mesh {mesh} "
                f"({'EP all_to_all over model' if ep else 'no EP'}, FSDP "
                f"gather over data {mesh.axis_size('data')}-way): cf 16 "
                f"vs apply_moe on the card max err / max {err:.3e} (<= "
                f"{LM_PAR_MOE_REL}), expert_load equal, dropped 0, "
                f"{ms16:.3f} ms sharded, {ms_grouped:.3f} ms apply_moe "
                f"(host clock, synchronized); cf 1.25 card vs cpu max err / "
                f"max {err_cpu:.3e} (<= {LM_PAR_MOE_CPU_REL}), expert_load"
                f" and dropped_tokens ({int(mc['dropped_tokens'])}) equal")
    del params, p, p_cpu, want, y16, y125
    # printed, not held: the full-depth prefill through ``moe_fn``
    shape = run["meshes"][0]
    mesh = make_host_mesh(shape, ("data", "model"), device=device)
    full = model.make_params(base, seed=0, device=device)
    weights = model.compute_copy(full)
    del full
    if device.type == "cuda":
        torch.cuda.empty_cache()
    specs = {k: spec_for_axes(d.axes, d.shape, mesh)
             for k, d in moe.moe_schema(base).items()}
    fn = make_sharded_moe(base, mesh, batch_axes(mesh, rows), specs)
    drops = []

    def counted(p, x):
        y, m = fn(p, x)
        drops.append(m["dropped_tokens"])
        return y, m
    groups, _, _ = moe_dispatch_plan(base, mesh, rows, seq)
    with torch.inference_mode():
        want, _ = model.serve_prefill(base, weights, batch,
                                      q_chunk=run["q_chunk"],
                                      moe_groups=groups)
        model.serve_prefill(base, weights, batch, q_chunk=run["q_chunk"],
                            moe_fn=counted)               # warm
        drops.clear()
        lm_sync(device)
        t0 = time.perf_counter()
        got, _ = model.serve_prefill(base, weights, batch,
                                     q_chunk=run["q_chunk"], moe_fn=counted)
        lm_sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        dropped = sum(int(d) for d in drops)
        one_group, _ = model.serve_prefill(base, weights, batch,
                                           q_chunk=run["q_chunk"])
        traced = lm_trace(lambda: model.serve_prefill(
            base, weights, batch, q_chunk=run["q_chunk"], moe_fn=fn),
            device)
    vocab = slice(0, base.vocab_size)             # the padding is -inf
    corr, rel = lm_corr_rel(got[..., vocab].float(), want[..., vocab].float())
    corr1, rel1 = lm_corr_rel(one_group[..., vocab].float(),
                              want[..., vocab].float())
    n_moe = base.num_layers - int(base.first_layer_dense)
    lines.append(
        f"lm parallel (b) {base.name} full-depth prefill ({base.num_layers}"
        f" layers, bf16 compute copy) through moe_fn on mesh {mesh}, "
        f"{rows} x {seq}: {ms:.3f} ms, dropped_tokens {dropped} of "
        f"{rows * seq * base.top_k * n_moe} items, {traced['kernels']} "
        f"kernel launches; last-position logits against the grouped path "
        f"({groups} groups): corr {corr:.7f}, max diff / max {rel:.5f}; "
        f"the grouped path with 1 group against {groups}: corr "
        f"{corr1:.7f}, max diff / max {rel1:.5f} (printed, not held: "
        f"other token groups drop other items, and near-tie tokens "
        f"reroute, ROADMAP §3)")
    return lines


def lm_par_step(device, rehearse: bool) -> list:
    """Part (c): ``build_train_step(moe_impl="shard_map")`` on granite cut
    to ``layers`` at full width, ``steps`` steps on ``mesh``:

    * on the card's logical devices and on the same mesh of devices
      without streams, bit for bit (losses, drops, parameters, moments):
      the streams change nothing;
    * the first step's loss against the same step on the CPU, and
      against ``moe_impl="gspmd"`` on the card, within ``floor`` (1e-3)
      plus twice the gspmd path's own card/CPU gap.  granite's router
      reads bfloat16 activations whose logits reach the hundreds, so the
      card and the CPU route a few near-tie tokens apart on either path
      (ROADMAP §3); the gspmd path's gap measures that in this run.
      With one row, each shard's tokens are one of the grouped path's
      groups at the same capacity, but the grouped path rounds its
      router logits and sums its items in bfloat16, as the reference's
      grouped program does, the sharded path in float32, as its
      ``shard_map`` program does.  The later steps' losses are printed:
      each update moves the rerouted tokens' weights apart.

    The first step's gradient, card (``mu``, a tenth of it) against CPU,
    is printed."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.engine import LogicalDevice
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models import model
    from repro_torch.models.moe import moe_schema
    from repro_torch.models.moe_shard import make_sharded_moe
    from repro_torch.parallel.sharding import (
        batch_axes, moe_dispatch_plan, spec_for_axes)
    from repro_torch.train import OptConfig, build_train_step, init_state
    run = dict(LM_PAR_STEP)
    if rehearse:
        # the reduced config's router is ill-conditioned: its loss moves
        # by 0.011 between two roundings (tests/torch_lm_train_cases.py)
        run.update(seq=16, q_chunk=8, floor=2e-2)
    cut = dataclasses.replace(lm_config(run["arch"], None, rehearse),
                              num_layers=run["layers"])
    rows, seq, axes = run["rows"], run["seq"], ("data", "model")
    shape = ShapeSpec("smoke", "train", seq, rows)
    pipe = TokenPipeline(DataConfig(vocab_size=cut.vocab_size, batch=rows,
                                    seq_len=seq, seed=2))
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=run["steps"])
    state = {k: v.detach().cpu() for k, v in model.make_params(
        cut, seed=0, device=device).state_dict().items()}
    plain = Mesh(run["mesh"], axes, [
        LogicalDevice(i, device, None)
        for i in range(int(np.prod(run["mesh"])))])
    cpu_mesh = make_host_mesh(run["mesh"], axes, device="cpu")
    out = {}
    for label, mesh, impl in (
            ("card", make_host_mesh(run["mesh"], axes, device=device),
             "shard_map"),
            ("card without streams", plain, "shard_map"),
            ("card gspmd", plain, "gspmd")):
        where = mesh.flat_devices[0].device
        step, _, _ = build_train_step(cut, mesh, shape, opt_cfg,
                                      q_chunk=run["q_chunk"], remat=False,
                                      moe_impl=impl)
        m = model.LanguageModel(cut, device=where).requires_grad_()
        m.load_state_dict(state)
        opt = init_state(m)
        losses, drops, mu = [], [], None
        t0 = time.perf_counter()
        for i in range(run["steps"]):
            m, opt, met = step(m, opt, device_batch(pipe.batch_at(i),
                                                    where))
            losses.append(float(met["loss"]))
            drops.append(int(met["dropped_tokens"]))
            if i == 0:
                mu = {k: v.detach().cpu().clone()
                      for k, v in opt["mu"].items()}
        lm_sync(device)
        out[label] = dict(losses=losses, drops=drops, mu=mu,
                          seconds=time.perf_counter() - t0,
                          final=(m, opt) if impl == "shard_map" else None)
        del m, opt
    # the first step's loss and gradient on the CPU, through the sharded
    # MoE over CPU devices; the gspmd path's first loss there
    m = model.LanguageModel(cut, device="cpu").requires_grad_()
    m.load_state_dict(state)
    cpu_batch = device_batch(pipe.batch_at(0), "cpu")
    t0 = time.perf_counter()
    loss, met = model.loss_fn(cut, m, cpu_batch, q_chunk=run["q_chunk"],
                              moe_fn=make_sharded_moe(
                                  cut, cpu_mesh, batch_axes(cpu_mesh, rows),
                                  {k: spec_for_axes(d.axes, d.shape,
                                                    cpu_mesh)
                                   for k, d in moe_schema(cut).items()}))
    names, leaves = zip(*m.named_parameters())
    cpu = dict(losses=[float(loss.detach())],
               drops=[int(met["dropped_tokens"])],
               mu=dict(zip(names, torch.autograd.grad(loss, leaves))),
               seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_gspmd, _ = model.loss_fn(
            cut, m, cpu_batch, q_chunk=run["q_chunk"],
            moe_groups=moe_dispatch_plan(cut, cpu_mesh, rows, seq)[0])
    cpu_gspmd, cpu_gspmd_s = float(cpu_gspmd), time.perf_counter() - t0
    del m, loss, leaves
    card, bare = out["card"], out["card without streams"]
    gspmd = out["card gspmd"]
    (m_a, o_a), (m_b, o_b) = card["final"], bare["final"]
    same = (card["losses"] == bare["losses"]
            and card["drops"] == bare["drops"]
            and all(torch.equal(p, q) for p, q in zip(m_a.parameters(),
                                                      m_b.parameters()))
            and all(torch.equal(o_a[k][n], o_b[k][n])
                    for k in ("mu", "nu") for n in o_a[k]))
    require(same, "lm parallel (c): the step on the card's streams differs "
            "from the step without them")
    for r in out.values():
        r.pop("final")
    del m_a, o_a, m_b, o_b
    # mu after the first step is a tenth of its gradient: the correlation
    # compares the two gradients
    require(all(np.isfinite(card["losses"] + gspmd["losses"])),
            "lm parallel (c): loss not finite")
    first = card["losses"][0]
    gap = abs(gspmd["losses"][0] - cpu_gspmd) / abs(cpu_gspmd)
    bound = run["floor"] + 2 * gap
    d_cpu = abs(first - cpu["losses"][0]) / abs(cpu["losses"][0])
    d_gs = abs(first - gspmd["losses"][0]) / abs(gspmd["losses"][0])
    for what, d in (("card vs cpu", d_cpu), ("shard_map vs gspmd", d_gs)):
        require(d <= bound, f"lm parallel (c) {what}: first loss |d| / "
                f"loss {d} over {bound}")
    worst, worst_name = float("inf"), ""
    for name, want in cpu["mu"].items():
        corr, _ = lm_corr_rel(card["mu"][name].to(device), want.to(device))
        if corr < worst:
            worst, worst_name = corr, name

    def fmt(xs):
        return ", ".join(f"{x:.6f}" for x in xs)
    return [f"lm parallel (c) train step moe_impl=shard_map, {cut.name} "
            f"{cut.num_layers} layers at full width, mesh {run['mesh']}, "
            f"batch {rows} x {seq}, {run['steps']} steps: on the card's "
            f"streams equal to the same without streams bit for bit "
            f"(losses, drops, parameters, moments); losses card "
            f"{fmt(card['losses'])}, gspmd card {fmt(gspmd['losses'])}; "
            f"first loss cpu {cpu['losses'][0]:.6f} (card vs cpu |d| / loss "
            f"{d_cpu:.2e}), card vs gspmd {d_gs:.2e}, held to {bound:.2e} "
            f"({run['floor']} + twice the gspmd path's own card/cpu gap "
            f"{gap:.2e}: cpu {cpu_gspmd:.6f}); dropped_tokens card "
            f"{card['drops']} gspmd {gspmd['drops']} cpu {cpu['drops']}; "
            f"step 0 gradients card (its mu) vs cpu min corr {worst:.7f} "
            f"({worst_name}; printed, not held: near-tie tokens reroute); "
            f"seconds card {card['seconds']:.3f}, without streams "
            f"{bare['seconds']:.3f}, gspmd {gspmd['seconds']:.3f}, cpu loss "
            f"and gradient {cpu['seconds']:.3f}, cpu gspmd loss "
            f"{cpu_gspmd_s:.3f}"]


def lm_layer_tree(tree) -> dict:
    """A ``ParamTree`` as nested dicts of its tensors."""
    out = {k: v for k, v in tree._parameters.items()}
    out.update({k: lm_layer_tree(v) for k, v in tree._modules.items()})
    return out


def lm_par_pipeline(device, rehearse: bool) -> list:
    """Part (d): qwen2-0.5b's layers in GPipe stages over logical devices
    (``split_stages``, ``pipeline_apply``) against the sequential
    ``run_stack`` of each microbatch, the same ops in the same order:
    outputs bit for bit; the gradient of Σ outputs with respect to the
    stacked weights, held to ``LM_PAR_PIPE_REL``."""
    import torch
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    run = dict(LM_PAR_PIPE)
    if rehearse:
        run.update(seq=16, q_chunk=8)
    cfg = lm_config(run["arch"], None, rehearse)
    n_stages, micro, rows, seq = (run["stages"], run["micro"], run["rows"],
                                  run["seq"])
    params = model.make_params(cfg, seed=0, device=device)

    def as_leaves(tree):
        return {k: as_leaves(v) if isinstance(v, dict)
                else v.detach().requires_grad_() for k, v in tree.items()}
    stacked = as_leaves(split_stages(
        [lm_layer_tree(l) for l in params.layers], n_stages))
    leaves = lm_flat(stacked)
    per = cfg.num_layers // n_stages
    sig = model.layer_sigs(cfg)[0]
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=rows * micro, seq_len=seq, seed=3))
    with torch.no_grad():
        emb = model.embed_tokens(cfg, params, device_batch(
            pipe.batch_at(0), device))
    mbs = emb.reshape(micro, rows, seq, cfg.d_model)
    ctx = dict(positions=model._positions_for(cfg, {}, rows, seq, device),
               causal=True, q_chunk=run["q_chunk"], rec_chunk=256,
               want_cache=False, enc_out=None)

    def layer(p, i):
        return {k: (layer(v, i) if isinstance(v, dict) else v[i])
                for k, v in p.items()}

    def stage_fn(p, x):
        return model.run_stack(cfg, [layer(p, i) for i in range(per)],
                               [([sig], per)], x, ctx)[0]
    mesh = make_host_mesh((n_stages,), ("pod",), device=device)
    lm_sync(device)
    t0 = time.perf_counter()
    out = pipeline_apply(stage_fn, mesh)(stacked, mbs)
    piped = torch.autograd.grad(out.float().sum(), list(leaves.values()))
    lm_sync(device)
    pipe_s = time.perf_counter() - t0
    all_layers = [layer(layer(stacked, s), i) for s in range(n_stages)
                  for i in range(per)]
    t0 = time.perf_counter()
    seq_out = torch.stack([model.run_stack(
        cfg, all_layers, model.layer_groups(cfg), mbs[j], ctx)[0]
        for j in range(micro)])
    seq_g = torch.autograd.grad(seq_out.float().sum(),
                                list(leaves.values()))
    lm_sync(device)
    seq_s = time.perf_counter() - t0
    require(torch.equal(out, seq_out), "lm parallel (d): pipeline outputs "
            "!= the sequential stack's")
    worst, n_equal = 0.0, 0
    for name, a, b in zip(leaves, piped, seq_g):
        require(bool(torch.isfinite(a).all()), f"lm parallel (d): {name}")
        n_equal += bool(torch.equal(a, b))
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    require(worst <= LM_PAR_PIPE_REL, f"lm parallel (d): gradient max err"
            f" / max {worst} > {LM_PAR_PIPE_REL}")
    return [f"lm parallel (d) pipeline {cfg.name} {cfg.num_layers} layers "
            f"in {n_stages} stages of {per} over {mesh}, {micro} "
            f"microbatches of {rows} x {seq}: {micro + n_stages - 1} ticks; "
            f"outputs equal to the sequential run_stack bit for bit; "
            f"gradient of the summed outputs over {len(leaves)} stacked "
            f"leaves: {n_equal} bit for bit, max err / max {worst:.3e} "
            f"(<= {LM_PAR_PIPE_REL}: the four microbatches' contributions "
            f"are added in another order); forward + backward seconds "
            f"pipeline {pipe_s:.3f} sequential {seq_s:.3f}"]


def lm_par_quant(device, rehearse: bool) -> list:
    """Part (e): qwen2-0.5b's gradients of ``shards`` micro-batches, one
    per logical ``data`` shard, through ``quantized_tree_psum`` at each
    width: every shard's reduced values bit for bit to the CPU path's
    ``quantized_psum`` (hence the int32 sums: the same scale times an
    integer);
    each leaf's error to the exact sum within n · scale / (2 · qmax) (+
    float32 rounding of the scaled and dequantized values, n · scale ·
    2⁻²¹); Σ
    residuals + reduced to Σ gradients within n · scale · 2⁻¹⁹; and the
    bytes a shard would send."""
    import torch
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    from repro_torch.parallel.compression import (
        quantized_psum, quantized_tree_psum)
    run = dict(LM_PAR_QUANT)
    if rehearse:
        run.update(seq=16, q_chunk=8)
    cfg = lm_config(run["arch"], None, rehearse)
    n = run["shards"]
    m = model.make_params(cfg, seed=0, device=device, trainable=True)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=run["rows"], seq_len=run["seq"],
                                    seed=4))
    names, leaves = zip(*m.named_parameters())
    trees = []
    for i in range(n):
        loss, _ = model.loss_fn(cfg, m, device_batch(pipe.batch_at(i),
                                                     device),
                                q_chunk=run["q_chunk"])
        trees.append(dict(zip(names, torch.autograd.grad(loss, leaves))))
    del m, leaves
    n_values = sum(t.numel() for t in trees[0].values())
    mesh = make_host_mesh((n,), ("data",), device=device)
    cpu_mesh = make_host_mesh((n,), ("data",), device="cpu")
    cpu_trees = [{k: v.cpu() for k, v in t.items()} for t in trees]
    lines = []
    for bits in run["bits"]:
        qmax = 2 ** (bits - 1) - 1
        lm_sync(device)
        t0 = time.perf_counter()
        red, res = quantized_tree_psum(trees, mesh, "data", bits=bits)
        lm_sync(device)
        card_ms = (time.perf_counter() - t0) * 1e3
        worst_err = worst_sum = cpu_s = 0.0
        for k in names:
            t0 = time.perf_counter()
            cpu_red = quantized_psum([t[k] for t in cpu_trees], cpu_mesh,
                                     "data", bits=bits)
            cpu_s += time.perf_counter() - t0
            require(torch.equal(red[0][k].cpu(), cpu_red[0]) and all(
                torch.equal(r[k], red[0][k]) for r in red) and all(
                torch.equal(r, cpu_red[0]) for r in cpu_red),
                f"lm parallel (e) {bits} bits: {k} card != cpu")
            scale = max(float(t[k].abs().max()) for t in trees)
            exact = sum(t[k].double() for t in trees)
            err = float((red[0][k].double() - exact).abs().max())
            require(err <= n * scale / (2 * qmax) + n * scale * 2 ** -21,
                    f"lm parallel (e) {bits} bits: {k} error {err}")
            back, gsum = red[0][k], trees[0][k]
            for r in res:
                back = back + r[k]
            for t in trees[1:]:
                gsum = gsum + t[k]
            off = float((back - gsum).abs().max())
            require(off <= n * scale * 2 ** -19, f"lm parallel (e) {bits} "
                    f"bits: {k} residuals + reduced off by {off}")
            if scale > 0:
                worst_err = max(worst_err, err / (n * scale / (2 * qmax)))
                worst_sum = max(worst_sum, off / (n * scale))
        wire = n_values * bits // 8
        lines.append(
            f"lm parallel (e) quantized_tree_psum {bits} bits, {cfg.name} "
            f"gradients of {n} micro-batches of {run['rows']} x "
            f"{run['seq']} over {mesh} ({len(names)} leaves, {n_values} "
            f"float32 values a shard): every shard's reduced values equal "
            f"to the cpu path's bit for bit (so are the int32 sums); worst "
            f"leaf error {worst_err:.4f} of "
            f"n scale / (2 qmax); residuals + reduced vs the gradients' "
            f"sum worst {worst_sum:.3e} x n scale; bytes a shard sends "
            f"{wire} at {bits} bits vs {n_values * 4} in float32 "
            f"({n_values * 4 / wire:.1f}x less); {card_ms:.3f} ms on the "
            f"card with the residuals, {cpu_s:.3f} s on the cpu without")
        del red, res, cpu_red
    return lines


def lm_parallel_phase(device, rehearse: bool) -> None:
    """The parallel layer over logical devices on the card: parts (a)-(e)
    as the module docstring says, each with its seconds and peak memory."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    for name, part in (("(a) placements", lambda: lm_par_placements(
                            rehearse)),
                       ("(b) sharded MoE", lambda: lm_par_moe(
                           device, rehearse)),
                       ("(c) shard_map train step", lambda: lm_par_step(
                           device, rehearse)),
                       ("(d) pipeline", lambda: lm_par_pipeline(
                           device, rehearse)),
                       ("(e) quantized all-reduce", lambda: lm_par_quant(
                           device, rehearse))):
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for line in part():
            log(line)
        lm_sync(device)
        log(f"lm parallel part {name}: {time.perf_counter() - t0:.3f} s, "
            f"peak memory {lm_peak(device)}; phase at "
            f"{time.perf_counter() - t_phase:.3f} s")


#: the LM dry-run phase: ``run_cell`` at (16, 16) for these cells, and
#: their toy sizes under ``--rehearse`` (reduced configs; positions,
#: global batch)
LM_DRYRUN = (("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "prefill_32k"),
             ("qwen2-0.5b", "decode_32k"), ("granite-moe-3b-a800m",
                                            "train_4k"))
LM_DRYRUN_TOY = (64, 64)


def card_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (rehearsal: no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def lm_dryrun_line(label: str, rec: dict) -> str:
    mem, coll = rec["memory"], rec["collectives"]
    return (f"lm dry run {label}: {rec['params']} parameters "
            f"({rec['active_params']} active), args/dev "
            f"{mem['argument_bytes']} B, temp/dev {mem['temp_bytes']} B, "
            f"output/dev {mem['output_bytes']} B; FLOPs "
            f"{rec['cost_corrected']['flops']:.6e} global (per-device trace"
            f" {rec['cost_raw']['flops']:.6e}); collective bytes/dev by "
            f"kind {coll['bytes_by_kind']} (total {coll['total_bytes']}, "
            f"{coll['total_count']} ops); traced in "
            f"{rec['compile_seconds']} s + {rec['lower_seconds_cost']} s")


def lm_dryrun_job(job: tuple) -> dict:
    """One dry-run record, in a worker process of the dry-run phase:
    ``("run_cell", arch, shape name)`` at (16, 16), or ``("record", cfg,
    shape, mesh shape, overrides)`` for any config and shape (the
    rehearsal's toy cells, the one-card calibration cells); a one-card
    train record also carries ``state_bytes``, the parameter + optimizer
    bytes of its arguments."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if job[0] == "run_cell":
        rec = dryrun.run_cell(job[1], job[2], False)
    else:
        _, cfg, shape, mesh_shape, overrides = job
        mesh = Mesh(mesh_shape, ("data", "model"))
        rec = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
               "mesh": "x".join(map(str, mesh_shape)),
               "devices": mesh.size, "variant": "baseline",
               "params": dryrun.count_params(cfg),
               "active_params": dryrun.count_params(cfg, active_only=True)}
        dryrun._cell_record(cfg, shape, mesh, rec, overrides=overrides)
        if shape.kind == "train" and mesh.size == 1:
            parts = dryrun._train_parts(
                cfg, shape, mesh, grad_accum=overrides["grad_accum"])
            rec["state_bytes"] = parts["params"] + parts["opt"]
    rec["status"] = "ok"
    rec["wall_seconds"] = time.perf_counter() - t0
    return rec


def lm_dryrun_phase(device, rehearse: bool, served: dict,
                    trained: dict) -> None:
    """The analysis layer on the host (``meta`` traces; nothing is
    allocated on the card), its six records traced at once in worker
    processes: (a) ``run_cell`` of qwen2-0.5b's three shapes and
    granite-moe-3b-a800m's train_4k on (16, 16); (b) their roofline rows
    and table; (c) one-card records of the training and serving phases'
    own qwen2-0.5b cells, held and printed against what those phases
    measured."""
    import multiprocessing
    import os
    from repro_torch.analysis import roofline
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
    t_phase = time.perf_counter()
    card = card_label(device)
    cells = []
    for arch, name in LM_DRYRUN:
        if rehearse:
            seq, batch = LM_DRYRUN_TOY
            shape = ShapeSpec(name, SHAPES[name].kind, seq, batch)
            cells.append(("record", lm_config(arch, None, True), shape,
                          (16, 16), None))
        else:
            cells.append(("run_cell", arch, name))
    train_cfg = trained["cfg"]
    train_shape = ShapeSpec("card_train", "train", trained["seq"],
                            trained["batch"])
    decode_cfg = served["cfg"]
    decode_shape = ShapeSpec("card_decode", "decode",
                             served["cache_slots"], served["batch"])
    jobs = cells + [
        ("record", train_cfg, train_shape, (1, 1),
         {"grad_accum": trained["grad_accum"],
          "q_chunk": trained["q_chunk"]}),
        ("record", decode_cfg, decode_shape, (1, 1), None)]
    spawn = multiprocessing.get_context("spawn")
    with spawn.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
        recs = pool.map(lm_dryrun_job, jobs, chunksize=1)
    log(f"lm dry run: {len(jobs)} records traced in "
        f"{min(len(jobs), os.cpu_count() or 1)} worker processes in "
        f"{time.perf_counter() - t_phase:.3f} s")

    rows = []
    for (arch, name), rec in zip(LM_DRYRUN, recs):
        cfg = lm_config(arch, None, rehearse)
        shape = (ShapeSpec(name, SHAPES[name].kind, *LM_DRYRUN_TOY)
                 if rehearse else SHAPES[name])
        rows.append(roofline._analyze(rec, cfg, shape))
        log(lm_dryrun_line(f"{arch} {name} 16x16", rec)
            + f"; {rec['wall_seconds']:.3f} s in its worker")
    for row in rows:
        log(f"lm dry run roofline {row.arch} {row.shape}: compute "
            f"{row.compute_s:.6e} s, memory {row.memory_s:.6e} s, "
            f"collective {row.collective_s:.6e} s -> {row.dominant}; "
            f"MF/HLO {row.useful_ratio:.4f}, roofline frac "
            f"{row.roofline_frac:.4f}, fits {row.fits} (data sheet: "
            f"{roofline.PEAK_FLOPS:.3e} FLOP/s, {roofline.HBM_BW:.3e} B/s, "
            f"links {roofline.IB_BW:.3e} B/s across nodes)")
    log("lm dry run roofline table (16x16):\n"
        + roofline.markdown_table(rows))

    # (c) one card: the training phase's cell
    rec = recs[len(cells)]
    state = rec["state_bytes"]
    require(state == trained["state_bytes"], f"lm dry run: parameter + "
            f"optimizer bytes {state} != the training phase's state "
            f"{trained['state_bytes']}")
    mem = rec["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"] + \
        mem["output_bytes"]
    row = roofline._analyze(rec, train_cfg, train_shape)
    flops = rec["cost_corrected"]["flops"]
    measured_s = trained["step_ms"] / 1e3
    on_card = device.type == "cuda"
    peak = trained["peak"]
    log(f"lm dry run calibration train {train_cfg.name} "
        f"{train_shape.global_batch} x {train_shape.seq_len} (grad_accum "
        f"{trained['grad_accum']}, remat) on one card [{card}]: parameter "
        f"+ optimizer bytes {state} = the training phase's state, exactly; "
        f"predicted args + temp + output {predicted} B (args "
        f"{mem['argument_bytes']}, temp {mem['temp_bytes']}) vs "
        f"torch.cuda.max_memory_allocated "
        + (f"{peak} B (predicted / measured {predicted / peak:.4f})"
           if peak else "not measured (cpu)")
        + f"; FLOPs {flops:.6e} (remat off; x4/3 {flops * 4 / 3:.6e}) vs "
        f"lm_train_flops {trained['flops']:.6e} (ratio "
        f"{flops / trained['flops']:.4f}); roofline step "
        f"{row.step_time_s:.6e} s ({row.dominant}; compute "
        f"{row.compute_s:.6e}, memory {row.memory_s:.6e}) vs measured "
        f"median step {measured_s:.6e} s: "
        + (f"measured / roofline {measured_s / row.step_time_s:.4f}, share "
           f"of the roofline {row.step_time_s / measured_s:.4f}"
           if on_card else "ratio not measured (cpu)")
        + f"; {rec['wall_seconds']:.3f} s in its worker")

    # (c) one card: the serving phase's decode cell
    rec = recs[len(cells) + 1]
    row = roofline._analyze(rec, decode_cfg, decode_shape)
    hbm = roofline._hbm_bytes(decode_cfg, decode_shape)
    step_ms = served["decode_step_ms"]
    log(f"lm dry run calibration decode {decode_cfg.name} batch "
        f"{decode_shape.global_batch}, {decode_shape.seq_len}-slot cache on "
        f"one card [{card}]: roofline memory term {row.memory_s * 1e3:.4f} "
        f"ms ({hbm:.6e} B analytic / {roofline.HBM_BW:.3e} B/s) vs the "
        f"serving phase's decode bound {served['bound_ms']:.4f} ms and "
        f"measured "
        + (f"{step_ms:.4f} ms/step (measured / roofline "
           f"{step_ms / (row.step_time_s * 1e3):.2f})" if on_card else
           "not measured (cpu)")
        + f"; args {rec['memory']['argument_bytes']} B, temp "
        f"{rec['memory']['temp_bytes']} B, FLOPs "
        f"{rec['cost_corrected']['flops']:.6e}; {rec['wall_seconds']:.3f} s "
        f"in its worker")
    elapsed = time.perf_counter() - t_phase
    log(f"lm dry run phase: {elapsed:.3f} s on the host, nothing allocated "
        f"on the card")
    if not rehearse:
        require(elapsed < 60.0, f"lm dry run phase took {elapsed:.3f} s")


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
    parser.add_argument("--ab-tree", type=Path, metavar="DIR",
                        help="time the 1D async orient-none cap-8 run of "
                             "the main graph with the package of DIR/src "
                             "(another commit's checkout) against this "
                             "checkout's, in turns, each in a process of "
                             "its own (on the card, after --ab's kernels "
                             "when both are given); prints no result")
    parser.add_argument("--async-run", type=Path, metavar="SRC",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if (args.ab or args.ab_tree or args.async_run) and args.rehearse:
        parser.error("--ab, --ab-tree and --async-run run on the card only")
    if args.async_run is not None:
        # one --ab-tree turn: the package of SRC, not this checkout's
        sys.path.insert(0, str(args.async_run.resolve()))
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
    if args.ab_tree is not None and not args.ab:
        ab_tree_phase(args.ab_tree)
        return 0
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
    if args.async_run is not None:
        print(json.dumps({"async_run": async_run(g, part, device,
                                                 max_items)}))
        return 0
    if args.ab:
        ab_phase(g, hub, part, device, max_items, session_ks[1], args.ab,
                 reps)
        if args.ab_tree is not None:
            ab_tree_phase(args.ab_tree)
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
    served = lm_serving_phase(device, args.rehearse)
    phase_done("LM serving", t_start)
    lm_recurrent_phase(device, args.rehearse)
    phase_done("LM recurrent serving", t_start)
    trained = lm_training_phase(device, args.rehearse)
    phase_done("LM training", t_start)
    lm_parallel_phase(device, args.rehearse)
    phase_done("LM parallel", t_start)
    lm_dryrun_phase(device, args.rehearse, served, trained)
    phase_done("LM dry run", t_start)

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
