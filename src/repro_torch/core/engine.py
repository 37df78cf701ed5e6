"""Streaming census engine on one device: monolithic and streamed runs.

:class:`CensusEngine` owns device dispatch for the triad census:

* **Monolithic** (``max_items=None``): one plan, one dispatch.
* **Streamed** (``max_items=N``): the plan is never materialized whole.
  :class:`repro_torch.core.plan_stream.PlanChunker` slices the pre-prune
  item space into bounded chunks; the engine uploads the chunk-invariant
  graph and pair arrays once, runs one partials step per chunk and
  accumulates the int32 ``hist64``/``inter`` partials in int64 on the
  host.  Peak plan memory is O(max_items) instead of O(W).

``emit`` picks how chunks reach the device:

* ``emit="device"`` (default): the host ships each chunk as ONE packed
  buffer of O(pairs) descriptors + anchors
  (:class:`repro_torch.core.planner.DescriptorWindow`); the device maps
  every flat item index back to its pair, derives slot/side against the
  resident CSR and applies the pruning predicate in place.
* ``emit="host"``: emit, prune, pack and upload the O(W) item words in
  numpy — the oracle, and the path of prebuilt plans (:meth:`run_plan`).

On CUDA the streamed loop overlaps host and device work: window k+1 is
built on the host and uploaded from pinned memory on a copy stream while
window k runs, and window k-1's partials land (pinned, non-blocking
copy, waited on by event) only after window k has been dispatched.

Partials are integer sums and the closed-form bases are additive, so any
chunking is bit-identical to the monolithic dispatch, for every backend,
both orient modes and both emit modes.

:meth:`CensusEngine.session` opens an :class:`EngineSession`: the graph
stays resident on the device and :meth:`EngineSession.update` recounts
only the pairs an edge delta touches (:mod:`repro_torch.core.incremental`),
bit-identical to a from-scratch census of the edited graph.

Host phases are marked as ``torch.profiler`` ranges, read from a trace of
a run (``chip_smoke.py`` does): ``census.plan`` (pair space, bases and
window shapes) and ``census.window`` (one window's descriptors or item
words).  Outside a profiler a range costs a few microseconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.census import (
    BACKENDS, assemble_census, assemble_counts, desc_partials_fn,
    partials_fn)
from repro_torch.core.digraph import CompactDigraph, GraphDelta, apply_delta
from repro_torch.core.incremental import (
    affected_pair_ids, combine, contribution_counts,
    subset_descriptor_windows)
from repro_torch.core.pair_index import PairSpaceIndex
from repro_torch.core.plan_stream import PlanChunker
from repro_torch.core.planner import (
    DESC_BYTES, DESC_SEARCH_ITERS, CensusPlan, PairSpace,
    PlanOverflowError, base_for_pairs, build_plan, emit_items,
    emit_items_for_pairs, global_bases, iter_descriptor_windows,
    max_pairs_per_window, num_desc_anchors, pad_and_pack, pair_space,
    split_device_words)

#: work-item emission modes: ``device`` streams O(pairs) descriptors and
#: expands pairs→items on the device (the default); ``host`` materializes
#: and uploads every packed item in numpy (the oracle)
EMIT_MODES = ("device", "host")

#: bytes per packed work item (two int32 words)
ITEM_BYTES = 8


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names the CPU.

    ``None`` means the current CUDA device and raises when there is none
    — a census meant for the card never drops to the host silently.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; CensusEngine runs on the GPU "
                "unless given device='cpu' (the plain torch path)")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               f"device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device


def graph_bytes(indptr_len: int, entries: int, pairs: int) -> int:
    """Device bytes of the 5 int32 resident graph + pair arrays
    (indptr, packed, pair_u, pair_v, pair_code)."""
    return 4 * (int(indptr_len) + int(entries) + 3 * int(pairs))


def replicated_graph_bytes(space: PairSpace) -> int:
    """Resident graph bytes of one device holding the whole graph (the
    JAX package's un-partitioned footprint)."""
    return graph_bytes(space.indptr.shape[0], space.packed.shape[0],
                       space.num_pairs)


def _desc_capacity(chunk_shape: int, need: int) -> int:
    """Session descriptor capacity for a ``chunk_shape``-lane dispatch:
    2x headroom over the densest full-stream window (sparser
    affected-pair subsets span more pairs per item), capped at
    ``chunk_shape // 2 + 1``.  The cap rests on every pair spanning >= 2
    items, which holds for a whole graph's pre-prune space but not after
    pruning (a pair of degrees 1 and 2 keeps one item) nor in
    vertex-sliced tiles; what keeps every window inside the capacity is
    :func:`repro_torch.core.planner.iter_descriptor_windows`, which stops
    a window at ``desc_shape`` pairs.  Nothing else is sized from it."""
    return min(chunk_shape // 2 + 1, max(64, 2 * need))


def _guard_chunk_shape(chunk_shape: int) -> int:
    if chunk_shape >= 2**31:
        raise PlanOverflowError(
            f"chunk_shape {chunk_shape} exceeds int32 item indexing and "
            f"would silently wrap the per-window int32 accumulator "
            f"lanes; pass a smaller max_items budget (< 2**31)")
    return chunk_shape


@dataclass
class EngineStats:
    """Execution stats of the last :class:`CensusEngine` run.

    Field by field as the JAX package's ``EngineStats`` for a
    single-device run.  ``peak_plan_bytes`` is the per-dispatch item-lane
    footprint at packed-item width (``ITEM_BYTES * chunk_shape``);
    ``monolithic_plan_bytes`` is what one dispatch of the same work would
    have shipped; ``plan_upload_bytes`` is what each dispatch actually
    uploads (packed items under host emission, the descriptor window
    under device emission).  ``step_compiles`` and
    ``capacity_recompiles`` count jit compilations in the JAX package;
    eager torch compiles nothing per step, so both are always 0.
    """

    backend: str
    orient: str
    streamed: bool
    max_items: int | None
    chunks: int
    chunk_shape: int           #: padded items per dispatch
    items: int                 #: total valid work items processed
    chunk_items: list[int] = field(default_factory=list)
    peak_plan_bytes: int = 0
    monolithic_plan_bytes: int = 0
    step_compiles: int = 0
    capacity_recompiles: int = 0
    #: work-item emission mode of the run ("host" or "device")
    emit: str = "host"
    #: fixed per-dispatch descriptor-array length (device emission only)
    desc_shape: int = 0
    plan_upload_bytes: int = 0
    #: session extras: valid items a full recompute of the current graph
    #: would process, and the affected pairs an update re-counted
    full_items: int = 0
    affected_pairs: int = 0
    #: resident int32 graph + pair bytes on the device (the whole graph:
    #: the port runs on one device)
    graph_resident_bytes: int = 0
    graph_replicated_bytes: int = 0
    #: session host walltime by phase: pair-space maintenance (rebuild,
    #: or index edit + affected-pair discovery when ``indexed``), the
    #: ``apply_delta`` CSR edit, and work emission (items or descriptor
    #: windows, measured inside the dispatch loop, device waits excluded)
    host_pair_seconds: float = 0.0
    host_merge_seconds: float = 0.0
    host_emit_seconds: float = 0.0
    #: True when the pair space came from the session's persistent
    #: :class:`~repro_torch.core.pair_index.PairSpaceIndex`
    indexed: bool = False

    @property
    def plan_host_seconds(self) -> float:
        """Total host planning walltime (sum of the three phase buckets)."""
        return (self.host_pair_seconds + self.host_merge_seconds
                + self.host_emit_seconds)


class _Pipeline:
    """Double-buffered host↔device traffic of one streamed run.

    On CUDA, uploads go from two pinned host buffers to two device
    buffers on a copy stream that the compute stream waits on, and each
    dispatch's partials come back by a non-blocking copy into pinned
    memory, waited on by an event only when they are landed.  Slot ``k %
    2`` is reused two dispatches later, after dispatch k has landed, so
    no buffer is overwritten while a copy or kernel still reads it.  On
    the CPU everything is synchronous.
    """

    def __init__(self, device: torch.device, words: int):
        self.device = device
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.copy_stream = torch.cuda.Stream(device)
        self.host_in = [torch.empty(words, dtype=torch.int32,
                                    pin_memory=True) for _ in range(2)]
        self.dev_in = [torch.empty(words, dtype=torch.int32, device=device)
                       for _ in range(2)]
        self.host_out = [torch.empty(67, dtype=torch.int32,
                                     pin_memory=True) for _ in range(2)]
        self.done: list = [None, None]

    def upload(self, k: int, words: np.ndarray) -> torch.Tensor:
        """Ship dispatch ``k``'s int32 buffer; returns its device copy,
        ordered before any work enqueued after this call."""
        if not self.cuda:
            return torch.from_numpy(words)
        slot = k % 2
        self.host_in[slot].numpy()[:] = words
        with torch.cuda.stream(self.copy_stream):
            self.dev_in[slot].copy_(self.host_in[slot], non_blocking=True)
        torch.cuda.current_stream(self.device).wait_stream(self.copy_stream)
        return self.dev_in[slot]

    def fetch(self, k: int, hist: torch.Tensor, inter: torch.Tensor):
        """Start bringing dispatch ``k``'s partials back; returns a ticket
        for :meth:`land`."""
        if not self.cuda:
            return hist, inter
        slot = k % 2
        out = self.host_out[slot]
        out[:64].copy_(hist, non_blocking=True)
        out[64:64 + inter.shape[0]].copy_(inter, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.done[slot] = done
        return slot, inter.shape[0]

    def land(self, ticket) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a fetched dispatch; its partials as int64 arrays."""
        if not self.cuda:
            hist, inter = ticket
            return (hist.numpy().astype(np.int64),
                    inter.numpy().astype(np.int64))
        slot, lanes = ticket
        self.done[slot].synchronize()
        out = self.host_out[slot].numpy().astype(np.int64)
        return out[:64], out[64:64 + lanes]


def _dispatch(pipe: _Pipeline, launch, words, landed=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Run ``launch`` on each int32 host buffer that ``words`` yields,
    one dispatch in flight: buffer k+1 is built and uploaded while
    dispatch k runs, and dispatch k lands only after k+1 is dispatched.
    Every dispatch has landed when it returns.

    ``launch(device_words) -> (hist, inter)`` enqueues one partials step;
    ``landed(k, inter)`` is called with each dispatch's int64 ``inter``
    lanes as it lands, in order.  Returns the int64 sums of ``hist`` and
    of ``inter``'s two census lanes."""
    hist_acc = np.zeros(64, np.int64)
    inter_acc = np.zeros(2, np.int64)
    pending = None

    def land(k, ticket):
        hist, inter = pipe.land(ticket)
        hist_acc[:] += hist
        inter_acc[:] += inter[:2]
        if landed is not None:
            landed(k, inter)

    for k, host_words in enumerate(words):
        ticket = pipe.fetch(k, *launch(pipe.upload(k, host_words)))
        if pending is not None:
            land(k - 1, pending)
        pending = ticket
    if pending is not None:
        land(k, pending)
    return hist_acc, inter_acc


def _item_launcher(step, graph, chunk_shape: int):
    """``launch`` for :func:`_dispatch` over ``[item_sp…, item_pv…]``
    buffers (host emission)."""
    return lambda words: step(*graph, words[:chunk_shape],
                              words[chunk_shape:])


def _desc_launcher(step, graph, idx: torch.Tensor, num_anchors: int):
    """``launch`` for :func:`_dispatch` over descriptor-window buffers
    (device emission)."""
    def launch(words):
        nv, dp, dc, dw, an = split_device_words(words, num_anchors)
        return step(*graph, dp, dc, dw, an, nv, idx)
    return launch


class CensusEngine:
    """Single-device census engine: monolithic and streamed runs.

    ``device=None`` runs on the CUDA device and raises when there is
    none; ``device="cpu"`` runs every backend's plain torch version on
    the host (the kernel wrappers take their plain versions for CPU
    tensors).  ``backend`` is ``"fused"`` (the default: one CUDA kernel
    per dispatch), ``"hist"`` (torch classification + the histogram
    kernel) or ``"torch"`` (plain torch, the oracle).  After each
    :meth:`run` / :meth:`run_plan` the execution record is
    :attr:`stats`.
    """

    def __init__(self, device=None, backend: str = "fused",
                 emit: str = "device"):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; one of {BACKENDS}")
        if emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        self.device = resolve_device(device)
        self.backend = backend
        self.emit = emit
        self.stats: EngineStats | None = None

    def _upload_graph(self, arrays) -> tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in arrays)

    # ------------------------------------------------------------- running
    def run_plan(self, plan: CensusPlan) -> np.ndarray:
        """Exact 16-type census from a prebuilt (monolithic) plan."""
        wp = int(plan.item_sp.shape[0])
        gbytes = graph_bytes(plan.indptr.shape[0], plan.packed.shape[0],
                             plan.num_pairs)
        self.stats = EngineStats(
            backend=self.backend, orient=plan.orient, streamed=False,
            max_items=None, chunks=1 if plan.num_items else 0,
            chunk_shape=wp, items=plan.num_items,
            chunk_items=[plan.num_items] if plan.num_items else [],
            peak_plan_bytes=ITEM_BYTES * wp,
            monolithic_plan_bytes=ITEM_BYTES * wp, emit="host",
            plan_upload_bytes=ITEM_BYTES * wp,
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if plan.num_pairs == 0 or plan.num_items == 0:
            # zero-work plans resolve entirely from the host closed forms
            return assemble_census(plan, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        arrays = self._upload_graph((plan.indptr, plan.packed, plan.pair_u,
                                     plan.pair_v, plan.pair_code,
                                     plan.item_sp, plan.item_pv))
        step = partials_fn(self.backend, plan.search_iters)
        hist64, inter = step(*arrays)
        return assemble_census(plan, hist64.cpu().numpy(),
                               inter.cpu().numpy())

    def run(self, g: CompactDigraph, *, max_items: int | None = None,
            orient: str = "none", prune_self: bool = True,
            progress=None, emit: str | None = None) -> np.ndarray:
        """Plan + count ``g`` end to end.

        ``max_items=None`` covers the whole item space in one dispatch;
        an integer budget streams bounded chunks instead.  ``emit``
        (default: the engine's mode) picks the work-item path.
        ``progress(chunk_index, num_chunks, chunk_valid_items)`` is called
        per chunk — at dispatch under host emission, when the chunk's
        device-counted valid items land under device emission.
        """
        emit = self.emit if emit is None else emit
        if emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        with record_function("census.plan"):
            if emit == "host" and max_items is None:
                plan = build_plan(g, orient=orient, prune_self=prune_self)
            else:
                chunker = PlanChunker(g, max_items, orient=orient,
                                      prune_self=prune_self)
        if emit == "device":
            return self._run_stream_desc(chunker, progress,
                                         max_items=max_items)
        if max_items is None:
            return self.run_plan(plan)
        return self._run_stream(chunker, progress)

    def session(self, g: CompactDigraph, *, orient: str = "none",
                prune_self: bool = True, max_items: int | None = None,
                emit: str | None = None,
                auto_rebalance_threshold: float | None = None,
                index: bool = True) -> "EngineSession":
        """Open a resident-graph session on ``g`` for repeated / sliding-
        window censuses (see :class:`EngineSession`).  ``index`` keeps a
        persistent :class:`~repro_torch.core.pair_index.PairSpaceIndex`
        so warm ``update()`` calls edit the pair space in O(delta · log P)
        instead of rebuilding it in O(P); ``index=False`` is the
        rebuild-from-scratch oracle path (bit-identical either way).
        ``auto_rebalance_threshold`` belongs to partitioned sessions,
        which the port does not have yet: passing it raises."""
        if auto_rebalance_threshold is not None:
            raise ValueError(
                "auto_rebalance_threshold requires partition=True")
        return EngineSession(self, g, orient=orient, prune_self=prune_self,
                             max_items=max_items, emit=emit, index=index)

    def _run_stream(self, chunker: PlanChunker, progress) -> np.ndarray:
        """Host-emission stream: per chunk the host emits, packs and
        uploads the chunk's item words (one buffer, ``[item_sp…,
        item_pv…]``); fully pruned chunks are not dispatched."""
        space = chunker.space
        shape = chunker.chunk_shape
        gbytes = replicated_graph_bytes(space)
        self.stats = EngineStats(
            backend=self.backend, orient=space.orient, streamed=True,
            max_items=chunker.max_items, chunks=chunker.num_chunks,
            chunk_shape=shape, items=0,
            peak_plan_bytes=ITEM_BYTES * shape, emit="host",
            plan_upload_bytes=ITEM_BYTES * shape,
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if chunker.num_chunks == 0:
            return assemble_counts(space.n, 0, 0, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        graph = self._upload_graph(chunker.device_arrays())
        step = partials_fn(self.backend, space.search_iters)
        pipe = _Pipeline(self.device, 2 * shape)
        base_asym = base_mut = 0
        chunk_items: list[int] = []

        def words():
            nonlocal base_asym, base_mut
            for k in range(chunker.num_chunks):
                with record_function("census.window"):
                    chunk = chunker.chunk(k)
                base_asym += chunk.base_asym
                base_mut += chunk.base_mut
                chunk_items.append(chunk.num_items)
                if progress is not None:
                    progress(chunk.index, chunker.num_chunks,
                             chunk.num_items)
                # a fully pruned chunk is credited its bases above and
                # not dispatched: its all-invalid items contribute nothing
                if chunk.num_items:
                    yield np.concatenate([chunk.item_sp, chunk.item_pv])

        hist_acc, inter_acc = _dispatch(
            pipe, _item_launcher(step, graph, shape), words())

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * st.items
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)

    def _run_stream_desc(self, chunker: PlanChunker, progress,
                         max_items: int | None) -> np.ndarray:
        """Device-emission stream: per chunk the host ships the O(pairs)
        descriptor window; the device expands pairs→items against the
        resident flat-index array.  Bit-identical to :meth:`_run_stream`
        — every item the plan would prune is a zero contribution of the
        classification masks (see
        :func:`repro_torch.core.census.prune_keep_mask`)."""
        space = chunker.space
        words_len = 1 + 3 * chunker.desc_shape + chunker.num_anchors
        gbytes = replicated_graph_bytes(space)
        self.stats = EngineStats(
            backend=self.backend, orient=space.orient,
            streamed=max_items is not None, max_items=max_items,
            chunks=chunker.num_chunks, chunk_shape=chunker.chunk_shape,
            items=0, peak_plan_bytes=ITEM_BYTES * chunker.chunk_shape,
            emit="device", desc_shape=chunker.desc_shape,
            plan_upload_bytes=(DESC_BYTES * chunker.desc_shape
                               + 4 * chunker.num_anchors + 4),
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if chunker.num_chunks == 0:
            return assemble_counts(space.n, 0, 0, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        graph = self._upload_graph(chunker.device_arrays())
        # the flat item-index space: made on the device once, reused by
        # every chunk
        idx = torch.arange(chunker.chunk_shape, dtype=torch.int32,
                           device=self.device)
        step = desc_partials_fn(self.backend, space.search_iters,
                                chunker.desc_iters, space.orient,
                                space.prune_self)
        pipe = _Pipeline(self.device, words_len)
        base_asym = base_mut = 0
        chunk_items: list[int] = []

        def words():
            nonlocal base_asym, base_mut
            for k in range(chunker.num_chunks):
                ba, bm = chunker.bases(k)
                base_asym += ba
                base_mut += bm
                with record_function("census.window"):
                    host_words = chunker.descriptors(k).device_words()
                yield host_words

        def landed(k, inter):
            chunk_items.append(int(inter[2]))
            if progress is not None:
                progress(k, chunker.num_chunks, int(inter[2]))

        hist_acc, inter_acc = _dispatch(
            pipe, _desc_launcher(step, graph, idx, chunker.num_anchors),
            words(), landed)

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * st.items
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)


def _pad_i32(a: np.ndarray, cap: int) -> np.ndarray:
    """Zero-pad an integer array to a fixed capacity, as int32."""
    out = np.zeros(cap, dtype=np.int32)
    out[:a.shape[0]] = a
    return out


class _TimedIter:
    """Wrap an iterator, accumulating the walltime spent *inside*
    ``next()`` — the host-side plan/window construction cost of a lazy
    emission stream, excluding the consumer's device-wait time (the
    ``host_emit_seconds`` stats bucket)."""

    def __init__(self, it):
        self._it = iter(it)
        self.seconds = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            self.seconds += time.perf_counter() - t0


class EngineSession:
    """Resident-graph census session: upload once, recount by delta.

    The graph-shaped device arrays (CSR ``indptr``/``packed`` + pair
    arrays) live in zero-padded buffers of a fixed capacity, grown
    geometrically and written in place for each graph revision.  The
    padding is inert: windows and items reference only real pairs and
    slots, and every search stays inside a real row.  A revision's writes
    are queued on the compute stream after the last kernel that read the
    previous revision, and that kernel's partials have landed before
    :meth:`update` writes (the old-graph recount lands every window before
    it returns).

    The plain versions' row-search depth is pinned at open to
    ``ceil(log2 n)``, a bound on every row of any revision, so an update
    that grows a row past the initial graph's largest degree is searched
    to the end; the CUDA kernels search to convergence.

    Two ways to move the session forward:

    * :meth:`set_graph` + :meth:`census` — full recompute of a new graph
      (the tumbling-window path).
    * :meth:`update` — apply an edge delta via
      :func:`repro_torch.core.digraph.apply_delta` and recount only the
      *affected pairs* (see :mod:`repro_torch.core.incremental`):
      ``C_new = C_old + contrib(A, G_new) − contrib(A, G_old)``,
      bit-identical to a from-scratch census of the edited graph.

    ``max_items`` bounds the padded items per dispatch (default: one
    chunk sized to the initial graph's pre-prune item space).  Under
    ``emit="device"`` (the default) each dispatch uploads one descriptor
    window, whose capacity and anchor geometry are fixed at open (windows
    that would overflow shrink their item span instead); under
    ``emit="host"`` it uploads the packed items.  After every operation
    :attr:`stats` (also ``engine.stats``) records the dispatch schedule,
    including ``full_items`` — what a from-scratch recompute would have
    processed — and ``affected_pairs``, field for field as the JAX
    package's session on one device.
    """

    def __init__(self, engine: CensusEngine, g: CompactDigraph, *,
                 orient: str = "none", prune_self: bool = True,
                 max_items: int | None = None, emit: str | None = None,
                 index: bool = True):
        if max_items is not None and max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items}")
        emit = engine.emit if emit is None else emit
        if emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        self.engine = engine
        self.device = engine.device
        self.orient = orient
        self.prune_self = prune_self
        self.emit = emit
        self.n = g.n
        self.max_items = max_items
        #: keep a persistent :class:`PairSpaceIndex` and edit it per
        #: update instead of rebuilding the O(P) pair space
        self.use_index = bool(index)
        self._pair_index: PairSpaceIndex | None = None
        self._t_pair = self._t_merge = self._t_emit = 0.0
        #: pinned row-search depth: any row has < n entries
        self.search_iters = max(1, int(np.ceil(np.log2(max(g.n, 2)))))
        self._cap_entries = 0
        self._cap_pairs = 0
        self._dev: tuple[torch.Tensor, ...] | None = None
        self.chunk_shape: int | None = None
        self.desc_shape: int | None = None
        self._census: np.ndarray | None = None
        self.last_delta: GraphDelta | None = None
        self.stats: EngineStats | None = None
        self._closed = False
        self._install(g)
        cs = self.chunk_shape
        if self.emit == "device":
            space = self._space
            self.desc_shape = _desc_capacity(
                cs, max_pairs_per_window(space.offsets, cs))
            self.desc_iters = DESC_SEARCH_ITERS
            self.num_anchors = num_desc_anchors(cs)
            self._idx = torch.arange(cs, dtype=torch.int32,
                                     device=self.device)
            self._step = desc_partials_fn(
                engine.backend, self.search_iters, self.desc_iters,
                orient, prune_self)
            words = 1 + 3 * self.desc_shape + self.num_anchors
        else:
            self._step = partials_fn(engine.backend, self.search_iters)
            words = 2 * cs
        self._pipe = _Pipeline(self.device, words)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release the resident device buffers.  Idempotent; the session
        is unusable afterwards."""
        self._dev = None
        self._idx = None
        self._pipe = None
        self._closed = True

    def __enter__(self) -> "EngineSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("session is closed")

    # ------------------------------------------------------------ state
    @property
    def graph(self) -> CompactDigraph:
        return self._g

    @property
    def space(self) -> PairSpace:
        return self._space

    @property
    def counts(self) -> np.ndarray | None:
        """The session's running census C_k (None until :meth:`census`)."""
        return None if self._census is None else self._census.copy()

    @staticmethod
    def _grown(cap: int, need: int) -> int:
        cap = max(cap, 256)
        while cap < need:
            cap *= 2
        return cap

    def _install(self, g: CompactDigraph, space=None) -> None:
        """Make ``g`` the resident graph: rebuild the pair space (or
        adopt the prebuilt ``space`` an index edit produced) and write
        the padded device arrays, regrowing them when they are full."""
        self._g = g
        if space is None:
            t0 = time.perf_counter()
            if self.use_index:
                self._pair_index = PairSpaceIndex(
                    g, orient=self.orient, prune_self=self.prune_self)
                space = self._pair_index.space
            else:
                space = pair_space(g, orient=self.orient,
                                   prune_self=self.prune_self)
            self._t_pair += time.perf_counter() - t0
        self._space = space
        self._full_items: int | None = None   # lazy per-install stat
        if self.chunk_shape is None:
            budget = (self.max_items if self.max_items is not None
                      else max(space.num_items_preprune, 1))
            self.chunk_shape = _guard_chunk_shape(max(int(budget), 1))
        cap_entries = self._grown(self._cap_entries, space.packed.shape[0])
        cap_pairs = self._grown(self._cap_pairs, space.num_pairs)
        if self._dev is None or (cap_entries, cap_pairs) != (
                self._cap_entries, self._cap_pairs):
            self._cap_entries, self._cap_pairs = cap_entries, cap_pairs
            self._dev = tuple(
                torch.zeros(size, dtype=torch.int32, device=self.device)
                for size in (self.n + 1, cap_entries, cap_pairs,
                             cap_pairs, cap_pairs))
        host = (space.indptr.astype(np.int32),
                _pad_i32(space.packed, cap_entries),
                _pad_i32(space.pair_u, cap_pairs),
                _pad_i32(space.pair_v, cap_pairs),
                _pad_i32(space.pair_code, cap_pairs))
        for dev, arr in zip(self._dev, host):
            dev.copy_(torch.from_numpy(arr))

    def set_graph(self, g: CompactDigraph) -> None:
        """Replace the resident graph wholesale (no delta bookkeeping).
        Invalidates the running census until :meth:`census` recomputes."""
        self._check_open()
        if g.n != self.n:
            raise ValueError(f"session is pinned to n={self.n}, got {g.n}")
        self._install(g)
        self._census = None
        self.last_delta = None

    # ---------------------------------------------------------- running
    def _run_batches(self, batches
                     ) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """Dispatch item batches (each with at most ``chunk_shape``
        items) against the resident device graph; empty batches are
        skipped without a dispatch.  Returns int64 partials and the
        items per dispatch."""
        cs = self.chunk_shape
        chunk_items: list[int] = []

        def words():
            for item_pair, item_slot, item_side in batches:
                if item_pair.shape[0]:
                    chunk_items.append(int(item_pair.shape[0]))
                    yield np.concatenate(pad_and_pack(
                        item_pair, item_slot, item_side, cs))

        hist, inter = _dispatch(
            self._pipe, _item_launcher(self._step, self._dev, cs), words())
        return hist, inter, chunk_items

    def _run_desc_batches(self, windows
                          ) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """Device-emission twin of :meth:`_run_batches`: dispatch
        descriptor windows against the resident graph and flat-index
        arrays.  Valid-item counts come back from the device (``inter``
        lane 2), so the stats match host emission without materializing
        a single item."""
        chunk_items: list[int] = []
        hist, inter = _dispatch(
            self._pipe,
            _desc_launcher(self._step, self._dev, self._idx,
                           self.num_anchors),
            (win.device_words() for win in windows if win.num_preprune),
            lambda k, inter3: chunk_items.append(int(inter3[2])))
        return hist, inter, chunk_items

    def _slices(self, item_pair, item_slot, item_side):
        """Yield materialized items in ``chunk_shape``-sized batches."""
        cs = self.chunk_shape
        for lo in range(0, int(item_pair.shape[0]), cs):
            yield (item_pair[lo:lo + cs], item_slot[lo:lo + cs],
                   item_side[lo:lo + cs])

    def _subset(self, pair_ids: np.ndarray
                ) -> tuple[np.ndarray, int, list[int]]:
        """Contribution of a pair subset of the RESIDENT graph.  Host
        memory is O(subset items) under host emission and O(subset pairs)
        under device emission.  Every dispatch has landed when it
        returns."""
        base_asym, base_mut = base_for_pairs(self._space, pair_ids)
        if self.emit == "device":
            ids = np.asarray(pair_ids, dtype=np.int64).ravel()
            wins = _TimedIter(
                subset_descriptor_windows(self._space, ids,
                                          self.chunk_shape,
                                          self.desc_shape,
                                          self.num_anchors))
            hist, inter, chunk_items = self._run_desc_batches(wins)
            self._t_emit += wins.seconds
            return (contribution_counts(base_asym, base_mut, hist, inter),
                    int(sum(chunk_items)), chunk_items)
        t0 = time.perf_counter()
        items = emit_items_for_pairs(self._space, pair_ids)
        self._t_emit += time.perf_counter() - t0
        num_items = int(items[0].shape[0])
        if num_items == 0:
            return (contribution_counts(base_asym, base_mut,
                                        np.zeros(64, np.int64),
                                        np.zeros(2, np.int64)), 0, [])
        hist, inter, chunk_items = self._run_batches(self._slices(*items))
        return (contribution_counts(base_asym, base_mut, hist, inter),
                num_items, chunk_items)

    def _postprune_items(self) -> int:
        """Full-recompute item count of the resident graph, computed at
        most once per graph revision: the index's maintained per-pair
        cost vector, or the closed-form scan without an index."""
        if self._full_items is None:
            if self.use_index and self._pair_index is not None:
                self._full_items = int(self._pair_index.costs.sum())
            else:
                self._full_items = self._space.num_items_postprune()
        return self._full_items

    def _set_stats(self, chunk_items: list[int], items: int,
                   full_items: int, affected_pairs: int) -> None:
        gbytes = replicated_graph_bytes(self._space)
        self.stats = EngineStats(
            backend=self.engine.backend, orient=self.orient,
            streamed=True, max_items=self.max_items,
            chunks=len(chunk_items), chunk_shape=self.chunk_shape,
            items=items, chunk_items=chunk_items,
            peak_plan_bytes=ITEM_BYTES * self.chunk_shape,
            monolithic_plan_bytes=ITEM_BYTES * full_items,
            full_items=full_items, affected_pairs=affected_pairs,
            emit=self.emit, desc_shape=self.desc_shape or 0,
            plan_upload_bytes=(
                DESC_BYTES * self.desc_shape + 4 * self.num_anchors + 4
                if self.emit == "device"
                else ITEM_BYTES * self.chunk_shape),
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes,
            host_pair_seconds=self._t_pair,
            host_merge_seconds=self._t_merge,
            host_emit_seconds=self._t_emit, indexed=self.use_index)
        self._t_pair = self._t_merge = self._t_emit = 0.0
        self.engine.stats = self.stats

    def census(self) -> np.ndarray:
        """Full census of the resident graph; (re)bases the session's
        running C_k that :meth:`update` moves forward.  Under host
        emission items are emitted per pre-prune slice of
        ``chunk_shape``; under device emission only descriptor windows
        are built."""
        self._check_open()
        space = self._space
        w0 = space.num_items_preprune
        cs = self.chunk_shape
        if self.emit == "device":
            wins = _TimedIter(
                iter_descriptor_windows(space.offsets, cs,
                                        self.desc_shape,
                                        self.num_anchors))
            hist, inter, chunk_items = self._run_desc_batches(wins)
            self._t_emit += wins.seconds
        else:
            batches = _TimedIter(emit_items(space, lo, min(lo + cs, w0))
                                 for lo in range(0, w0, cs))
            hist, inter, chunk_items = self._run_batches(batches)
            self._t_emit += batches.seconds
        base_asym, base_mut = global_bases(space)
        self._census = assemble_counts(self.n, base_asym, base_mut,
                                       hist, inter)
        num_items = int(sum(chunk_items))
        self._full_items = num_items      # the full census just counted it
        self._set_stats(chunk_items, num_items, num_items, space.num_pairs)
        return self._census.copy()

    def update(self, add_src=None, add_dst=None,
               del_src=None, del_dst=None) -> np.ndarray:
        """Apply an edge delta and return the edited graph's census,
        recounting only the affected pairs — bit-identical to a
        from-scratch census of the new graph on any backend."""
        self._check_open()
        if self._census is None:
            raise RuntimeError(
                "no baseline census: call census() before update()")
        t0 = time.perf_counter()
        g_new, delta = apply_delta(self._g, add_src, add_dst,
                                   del_src, del_dst)
        self._t_merge += time.perf_counter() - t0
        self.last_delta = delta
        if delta.num_changed == 0:
            # nothing changed: no recount, no upload, no dispatch — the
            # running census is already the answer
            self._set_stats([], 0, self._postprune_items(), 0)
            return self._census.copy()

        t0 = time.perf_counter()
        aff_old = (self._pair_index.affected_pair_ids(delta.touched)
                   if self.use_index
                   else affected_pair_ids(self._space, delta.touched))
        self._t_pair += time.perf_counter() - t0
        # lands every window of the old graph before the install below
        # overwrites the resident buffers
        contrib_old, items_old, chunks_old = self._subset(aff_old)
        if self.use_index:
            # edit the persistent index into the new graph's pair space
            # (O(delta · log P + affected)) instead of rebuilding O(P)
            t0 = time.perf_counter()
            space_new = self._pair_index.apply(delta, g_new)
            self._t_pair += time.perf_counter() - t0
            self._install(g_new, space=space_new)
        else:
            self._install(g_new)
        t0 = time.perf_counter()
        aff_new = (self._pair_index.affected_pair_ids(delta.touched)
                   if self.use_index
                   else affected_pair_ids(self._space, delta.touched))
        self._t_pair += time.perf_counter() - t0
        contrib_new, items_new, chunks_new = self._subset(aff_new)
        self._census = combine(self._census, contrib_old, contrib_new,
                               self.n)
        self._set_stats(chunks_old + chunks_new, items_old + items_new,
                        self._postprune_items(),
                        int(aff_old.shape[0] + aff_new.shape[0]))
        return self._census.copy()
