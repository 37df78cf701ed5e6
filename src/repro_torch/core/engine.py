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

Host phases are marked as ``torch.profiler`` ranges, read from a trace of
a run (``chip_smoke.py`` does): ``census.plan`` (pair space, bases and
window shapes) and ``census.window`` (one window's descriptors or item
words).  Outside a profiler a range costs a few microseconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.census import (
    BACKENDS, assemble_census, assemble_counts, desc_partials_fn,
    partials_fn)
from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.plan_stream import PlanChunker
from repro_torch.core.planner import (
    DESC_BYTES, CensusPlan, build_plan, split_device_words)

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
        self.stats = EngineStats(
            backend=self.backend, orient=plan.orient, streamed=False,
            max_items=None, chunks=1 if plan.num_items else 0,
            chunk_shape=wp, items=plan.num_items,
            chunk_items=[plan.num_items] if plan.num_items else [],
            peak_plan_bytes=ITEM_BYTES * wp,
            monolithic_plan_bytes=ITEM_BYTES * wp, emit="host",
            plan_upload_bytes=ITEM_BYTES * wp)
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

    def _run_stream(self, chunker: PlanChunker, progress) -> np.ndarray:
        """Host-emission stream: per chunk the host emits, packs and
        uploads the chunk's item words (one buffer, ``[item_sp…,
        item_pv…]``); fully pruned chunks are not dispatched."""
        space = chunker.space
        shape = chunker.chunk_shape
        self.stats = EngineStats(
            backend=self.backend, orient=space.orient, streamed=True,
            max_items=chunker.max_items, chunks=chunker.num_chunks,
            chunk_shape=shape, items=0,
            peak_plan_bytes=ITEM_BYTES * shape, emit="host",
            plan_upload_bytes=ITEM_BYTES * shape)
        if chunker.num_chunks == 0:
            return assemble_counts(space.n, 0, 0, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        graph = self._upload_graph(chunker.device_arrays())
        step = partials_fn(self.backend, space.search_iters)
        pipe = _Pipeline(self.device, 2 * shape)

        hist_acc = np.zeros(64, np.int64)
        inter_acc = np.zeros(2, np.int64)
        base_asym = base_mut = 0
        chunk_items: list[int] = []
        pending = None
        dispatched = 0
        for k in range(chunker.num_chunks):
            with record_function("census.window"):
                chunk = chunker.chunk(k)
            base_asym += chunk.base_asym
            base_mut += chunk.base_mut
            chunk_items.append(chunk.num_items)
            if progress is not None:
                progress(chunk.index, chunker.num_chunks, chunk.num_items)
            if chunk.num_items == 0:
                # fully pruned chunk: its bases are credited above and its
                # all-invalid items would contribute nothing
                continue
            words = pipe.upload(dispatched, np.concatenate(
                [chunk.item_sp, chunk.item_pv]))
            hist, inter = step(*graph, words[:shape], words[shape:])
            ticket = pipe.fetch(dispatched, hist, inter)
            dispatched += 1
            if pending is not None:
                h, i = pipe.land(pending)
                hist_acc += h
                inter_acc += i
            pending = ticket
        if pending is not None:
            h, i = pipe.land(pending)
            hist_acc += h
            inter_acc += i

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
        self.stats = EngineStats(
            backend=self.backend, orient=space.orient,
            streamed=max_items is not None, max_items=max_items,
            chunks=chunker.num_chunks, chunk_shape=chunker.chunk_shape,
            items=0, peak_plan_bytes=ITEM_BYTES * chunker.chunk_shape,
            emit="device", desc_shape=chunker.desc_shape,
            plan_upload_bytes=(DESC_BYTES * chunker.desc_shape
                               + 4 * chunker.num_anchors + 4))
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

        hist_acc = np.zeros(64, np.int64)
        inter_acc = np.zeros(2, np.int64)
        base_asym = base_mut = 0
        chunk_items: list[int] = []

        def land(ticket, k):
            hist, inter3 = pipe.land(ticket)
            hist_acc[:] += hist
            inter_acc[:] += inter3[:2]
            chunk_items.append(int(inter3[2]))
            if progress is not None:
                progress(k, chunker.num_chunks, int(inter3[2]))

        pending = None
        for k in range(chunker.num_chunks):
            ba, bm = chunker.bases(k)
            base_asym += ba
            base_mut += bm
            with record_function("census.window"):
                host_words = chunker.descriptors(k).device_words()
            words = pipe.upload(k, host_words)
            nv, dp, dc, dw, an = split_device_words(words,
                                                    chunker.num_anchors)
            hist, inter = step(*graph, dp, dc, dw, an, nv, idx)
            ticket = pipe.fetch(k, hist, inter)
            if pending is not None:
                land(pending, k - 1)
            pending = ticket
        land(pending, chunker.num_chunks - 1)

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * st.items
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)
