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
* **Per-shard chunking.**  :class:`ShardSchedule` locks several per-shard
  streams (one graph shard's local pair space each,
  :mod:`repro_torch.core.partition`) into one geometry for the
  partitioned engine; :class:`ShardStreamPipeline` produces each shard's
  windows on a background thread, and :class:`WindowBatcher` coalesces
  them into fixed ``(cap, words)`` megabatches.

Host-side numpy, framework-free.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.faults import FaultError
from repro_torch.core.planner import (
    DESC_SEARCH_ITERS, DescriptorWindow, PairSpace, PlanOverflowError,
    descriptor_window, emit_items, max_pairs_per_window, num_desc_anchors,
    pad_and_pack, pair_space)


class ProducerStalledError(FaultError):
    """A shard's window producer made no progress past the watchdog
    timeout and exhausted its restart budget."""


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

    def descriptors(self, k: int, *, anchors: bool = True
                    ) -> DescriptorWindow:
        """Chunk ``k`` as a pair-descriptor window (O(pairs-in-chunk)
        memory, no item materialization).  Intra-pair splits surface as
        the window's ``desc_within0`` offsets.  ``anchors=False`` leaves
        the anchor table to the device (an empty host table)."""
        lo, hi = self._bounds(k)
        return descriptor_window(self.space.offsets, lo, hi,
                                 self.desc_shape,
                                 self.num_anchors if anchors else 0)

    def bases(self, k: int) -> tuple[int, int]:
        """Chunk ``k``'s additive (base_asym, base_mut) share."""
        return int(self._base_asym[k]), int(self._base_mut[k])

    def __iter__(self) -> Iterator[PlanChunk]:
        for k in range(self.num_chunks):
            yield self.chunk(k)


class ShardSchedule:
    """Per-shard chunk schedules under one fixed geometry.

    The partitioned engine gives every device a *private* stream: shard s
    walks its own item space in windows of ``chunk_shape`` pre-prune
    items.  This schedule locks the per-shard :class:`PlanChunker`
    geometries together — one common ``chunk_shape`` (the per-device slice
    of ``max_items``) and one common ``desc_shape`` (the widest pair span
    any shard's window can have) — so every shard's every window fits
    the same preallocated device buffers.

    Two execution disciplines consume the same geometry:

    * **Lock-step** (``schedule="lockstep"``): one step launches every
      device's window and waits for all of them; ``num_steps`` is
      the longest shard's step count and shorter shards pad with empty
      windows (:meth:`step_words` / :meth:`step_items` stack all shards).
      The bit-identity oracle.
    * **Async** (``schedule="async"``, the default): each shard's private
      queue is walked independently — :meth:`steps_for` real windows per
      shard, no padding steps, no inter-shard barrier
      (:meth:`shard_step_items` / :meth:`descriptors` serve one shard's
      window at a time).  Walltime tracks the mean shard cost instead of
      the max.
    """

    def __init__(self, spaces, max_items: int | None, num_devices: int,
                 mesh_shape: tuple | None = None):
        if max_items is not None and max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items}")
        self.spaces = list(spaces)
        if mesh_shape is not None and (
                int(mesh_shape[0]) * int(mesh_shape[1]) != len(self.spaces)):
            raise ValueError(
                f"mesh_shape {tuple(mesh_shape)} does not cover "
                f"{len(self.spaces)} shard spaces")
        #: (pair_shards, vertex_slices) when the spaces are 2D tiles in
        #: flat s*V+j order; queue s then serves tile
        #: :meth:`tile_coords`(s) — geometry and dispatch are unchanged
        self.mesh_shape = (tuple(int(x) for x in mesh_shape)
                           if mesh_shape is not None else None)
        w_max = max((s.num_items_preprune for s in self.spaces), default=0)
        budget = (-(-int(max_items) // num_devices)
                  if max_items is not None else max(w_max, 1))
        self.max_items = max_items
        #: fixed per-DEVICE dispatch lanes (each device expands/processes
        #: its own ``chunk_shape`` item window per step)
        self.chunk_shape = max(min(budget, max(w_max, 1)), 1)
        if self.chunk_shape >= 2**31:
            raise PlanOverflowError(
                f"per-device chunk_shape {self.chunk_shape} exceeds int32 "
                f"item indexing and would silently wrap the per-window "
                f"int32 accumulator lanes; pass a smaller max_items "
                f"budget (< 2**31 per device)")
        self.num_steps = max(
            (-(-s.num_items_preprune // self.chunk_shape)
             for s in self.spaces), default=0)
        self.desc_shape = max(
            max_pairs_per_window(s.offsets, self.chunk_shape)
            for s in self.spaces) if self.spaces else 1
        self.desc_iters = DESC_SEARCH_ITERS
        self.num_anchors = num_desc_anchors(self.chunk_shape)

    @property
    def num_shards(self) -> int:
        return len(self.spaces)

    def tile_coords(self, s: int) -> tuple:
        """Shard index → (pair shard, vertex slice) mesh coordinates;
        identity-on-axis-0 for 1D schedules (slice 0)."""
        if self.mesh_shape is None:
            return (s, 0)
        return (s // self.mesh_shape[1], s % self.mesh_shape[1])

    def steps_for(self, s: int) -> int:
        """Shard ``s``'s REAL step count: the windows that actually carry
        pre-prune items (``num_steps`` minus this shard's lock-step
        padding)."""
        return -(-self.spaces[s].num_items_preprune // self.chunk_shape)

    @property
    def shard_steps(self) -> list:
        """Per-shard real step counts — the async schedule's work list
        and the lock-step schedule's idle accounting
        (``idle = num_steps * num_shards - sum(shard_steps)``)."""
        return [self.steps_for(s) for s in range(self.num_shards)]

    @property
    def total_windows(self) -> int:
        """Total real windows across every shard — the async path's
        dispatch count (lock-step dispatches
        ``num_steps * num_shards`` window lanes instead)."""
        return sum(self.shard_steps)

    def _bounds(self, s: int, k: int) -> tuple[int, int]:
        """Item window [lo, hi) of shard ``s`` at step ``k`` — empty (at
        the space's end) once the shard's own queue is exhausted."""
        total = self.spaces[s].num_items_preprune
        lo = min(k * self.chunk_shape, total)
        return lo, min(lo + self.chunk_shape, total)

    def descriptors(self, s: int, k: int, *, anchors: bool = True
                    ) -> DescriptorWindow:
        """Shard ``s``'s descriptor window at step ``k`` (possibly empty);
        ``anchors=False`` leaves the anchor table to the device."""
        lo, hi = self._bounds(s, k)
        return descriptor_window(self.spaces[s].offsets, lo, hi,
                                 self.desc_shape,
                                 self.num_anchors if anchors else 0)

    def step_words(self, k: int) -> np.ndarray:
        """All shards' step-``k`` windows as one (num_shards, words) int32
        buffer — the sharded per-step upload of the device-emission path,
        which leaves the anchor tables to the device."""
        return np.stack([self.descriptors(s, k, anchors=False)
                         .device_words() for s in range(self.num_shards)])

    def shard_step_items(self, s: int, k: int
                         ) -> tuple[np.ndarray, np.ndarray, int]:
        """Shard ``s``'s step-``k`` packed item window
        ((chunk_shape,) sp/pv words + valid item count) — the per-shard
        unit the async path dispatches one at a time."""
        lo, hi = self._bounds(s, k)
        item_pair, item_slot, item_side = emit_items(self.spaces[s],
                                                     lo, hi)
        sp, pv = pad_and_pack(item_pair, item_slot, item_side,
                              self.chunk_shape)
        return sp, pv, int(item_pair.shape[0])

    def step_items(self, k: int
                   ) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """All shards' step-``k`` packed item windows, stacked
        (num_shards, chunk_shape), plus per-shard valid item counts — the
        host-emission twin of :meth:`step_words`."""
        sps, pvs, nums = [], [], []
        for s in range(self.num_shards):
            sp, pv, num = self.shard_step_items(s, k)
            nums.append(num)
            sps.append(sp)
            pvs.append(pv)
        return np.stack(sps), np.stack(pvs), nums


#: end-of-stream sentinel of :class:`ShardStreamPipeline` producers
_STREAM_DONE = object()


class WindowBatcher:
    """Adaptive K-window megabatch coalescer for the async pipeline.

    :meth:`wrap` turns a per-shard descriptor-window source (a stream of
    ``DescriptorWindow.device_words()`` rows, all of one schedule-wide
    length ``words``) into a stream of fixed-shape megabatches: each
    yield is ``(buffer, real)`` where ``buffer`` is ``(cap, words)``
    int32 holding up to the CURRENT ``k`` stacked window rows and
    ``real`` counts them.  Rows past ``real`` stay all-zero — their
    leading ``num_preprune`` word is 0, so the megastep gives them exact
    zeros and skips their work
    (:func:`repro_torch.core.census.census_partials_desc_batch`) — and
    the buffer shape never depends on ``k``, so one pair of device
    buffers serves every batch however many real windows land.

    ``k`` adapts in [1, cap] from live pipeline feedback, one monotone
    move per signal:

    * :meth:`shrink` (consumer stalled: every queue empty while batches
      remain — the producers are the bottleneck) halves ``k`` so
      smaller batches reach the device sooner and the pipeline stays
      full;
    * :meth:`grow` (producer backlogged: a put found its queue full —
      the consumer/device side is the bottleneck) doubles ``k`` toward
      ``cap`` to amortize more Python dispatch overhead per step.

    ``k`` starts at ``cap`` (greedy: in the dispatch-bound regime the
    batcher exists for, producers outrun the consumer and full batches
    are right from the first dispatch).  Reads/writes of the single
    ``k`` int are atomic under the GIL; a batch snapshots ``k`` when it
    starts filling, so adaptive moves apply from the next batch on.
    """

    def __init__(self, cap: int, words: int, start: int | None = None):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        if words < 1:
            raise ValueError(f"words must be >= 1, got {words}")
        self.cap = int(cap)
        self.words = int(words)
        self.k = self.cap if start is None \
            else max(1, min(int(start), self.cap))

    def shrink(self) -> None:
        """Producer-starved signal: halve ``k`` (floor 1)."""
        self.k = max(1, self.k // 2)

    def grow(self) -> None:
        """Consumer-backlogged signal: double ``k`` (cap ``cap``)."""
        self.k = min(self.cap, self.k * 2)

    def wrap(self, source):
        """Generator coalescing ``source``'s window rows into
        ``(buffer (cap, words) int32, real)`` megabatches of at most
        the current ``k`` windows each."""
        it = iter(source)
        while True:
            take = self.k
            buf = np.zeros((self.cap, self.words), dtype=np.int32)
            real = 0
            for row in it:
                buf[real] = row
                real += 1
                if real >= take:
                    break
            if real == 0:
                return
            yield buf, real


class ShardStreamPipeline:
    """Background per-shard window producers feeding a round-robin
    consumer — the host half of the async partitioned pipeline.

    One daemon thread per shard runs that shard's ``source`` generator
    (descriptor-window packing or item emission — numpy host work only;
    every upload and launch stays on the consuming thread, and so does
    every CUDA stream) into a private bounded queue of ``depth`` windows,
    so window k+1's generation overlaps window k's upload + device
    compute and no shard's production ever waits on another's.  ``depth=2`` double-buffers: one
    window in flight to the device, one pre-built behind it.

    Iterating the pipeline yields ``(shard, window)`` in round-robin
    order over whichever shards have a window ready — a fast shard is
    never held back by a slow one (no barrier); drained shards (their
    ``_STREAM_DONE`` sentinel consumed) leave the rotation immediately
    and are never polled again, so exhausted or empty-shard streams
    cost the consumer nothing (the engine additionally never opens a
    stream for a shard with zero windows).  When *no* live shard has a
    window ready the consumer blocks on the first live queue and counts
    a **stall** (producer-bound moments, surfaced as
    ``EngineStats.stall_steps``).  Producer exceptions re-raise in the
    consumer; :meth:`close` unblocks and joins the threads (the engine
    closes in a ``finally``).

    ``batch`` (optional) is a :class:`WindowBatcher`: each source is
    wrapped so its producer thread coalesces up to the batcher's
    current ``k`` windows into one fixed-shape megabatch per queue
    item, and the pipeline feeds the batcher its adaptive signals —
    consumer stalls call :meth:`WindowBatcher.shrink` (only once
    something has been consumed, so startup latency is not mistaken for
    producer starvation) and producer backlog (a put finding its queue
    full) calls :meth:`WindowBatcher.grow`, once per blocked window.

    **Fault tolerance** (all optional, all off by default):

    * ``restart`` — a factory ``restart(slot, skip) -> source`` building
      a fresh window source for ``slot`` that skips its first ``skip``
      raw windows.  With it, a producer that *raises* retries in place:
      the thread rebuilds its source from the number of windows already
      landed on the queue (the authoritative progress record — windows
      put are never regenerated, windows lost mid-generation always
      are) and resumes, up to ``max_retries`` attempts with exponential
      ``backoff``; the budget exhausted, the exception surfaces to the
      consumer as before.  Regeneration is pure host numpy from the
      same immutable pair space, so a restarted stream is bit-identical
      to an uninterrupted one.
    * ``watchdog`` — a stall timeout in seconds.  A monitor thread
      watches every live producer; one whose queue is *empty* and whose
      put-count has not advanced for ``watchdog`` seconds is declared
      hung, its attempt is cancelled, and a fresh thread resumes from
      the same put-count (``watchdog_fires`` counts these).  The
      watchdog joins no thread: a hung attempt is left to end on its
      own (it holds no CUDA state) and is reaped by :meth:`close`.  Cancelled
      attempts can never land a late window: puts and cancellation are
      serialized under one lock, and a cancelled attempt re-checks its
      own cancel event under that lock before every put.

    The pipeline is a context manager; ``__exit__`` calls
    :meth:`close`, so producer threads are reaped on exceptions and
    KeyboardInterrupt, not just on the engine's explicit ``finally``.
    """

    _POLL = 0.05

    def __init__(self, sources, depth: int = 2, batch=None, *,
                 restart=None, watchdog: float | None = None,
                 max_retries: int = 2, backoff: float = 0.01):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.depth = int(depth)
        self.batch = batch
        self.stalls = 0
        self.producer_retries = 0
        self.watchdog_fires = 0
        self._consumed = 0
        self._stop = threading.Event()
        self._restart = restart
        self._watchdog = watchdog
        self._max_retries = int(max_retries)
        self._backoff = float(backoff)
        sources = list(sources)
        n = len(sources)
        self._live = set(range(n))
        self._queues = [queue.Queue(maxsize=self.depth) for _ in range(n)]
        #: serializes producer puts against watchdog cancellation so a
        #: cancelled attempt can never land a late (duplicate) window
        self._lock = threading.Lock()
        #: raw windows successfully landed per slot, across all attempts
        self._puts = [0] * n
        #: restart attempts consumed per slot (error + watchdog combined)
        self._attempts = [0] * n
        self._cancels: list = [threading.Event() for _ in range(n)]
        self._threads = []
        for s, src in enumerate(sources):
            self._spawn(s, src, self._cancels[s])
        if watchdog is not None:
            t = threading.Thread(target=self._watch, daemon=True)
            t.start()
            self._threads.append(t)

    def __enter__(self) -> "ShardStreamPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _spawn(self, slot: int, source, cancel) -> None:
        if self.batch is not None:
            source = self.batch.wrap(source)
        t = threading.Thread(target=self._produce,
                             args=(slot, self._queues[slot], source, cancel),
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _make_source(self, slot: int, skip: int):
        src = self._restart(slot, skip)
        return self.batch.wrap(src) if self.batch is not None else src

    def _offer(self, q: queue.Queue, item) -> bool:
        """Stop-aware put: lands ``item`` or gives up once :meth:`close`
        has been called (the consumer is gone — nobody will ever drain a
        full queue, so an unconditional put would strand the thread)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=self._POLL)
                return True
            except queue.Full:
                continue
        return False

    def _put_window(self, slot: int, q: queue.Queue, window,
                    cancel) -> bool:
        """Land one window under the put/cancel lock; ``False`` once this
        attempt is stopped or cancelled (the window is then discarded —
        its replacement attempt will regenerate it)."""
        count = window[1] if self.batch is not None else 1
        backlogged = False
        while not (self._stop.is_set() or cancel.is_set()):
            with self._lock:
                if cancel.is_set():
                    return False
                try:
                    q.put_nowait(window)
                    self._puts[slot] += count
                    return True
                except queue.Full:
                    pass
            if not backlogged and self.batch is not None:
                # consumer behind: one grow signal per blocked window,
                # not per retry
                self.batch.grow()
                backlogged = True
            time.sleep(0.002)
        return False

    def _produce(self, slot: int, q: queue.Queue, source, cancel) -> None:
        while True:
            try:
                for window in source:
                    if not self._put_window(slot, q, window, cancel):
                        return
            except BaseException as exc:
                if (self._restart is None or self._stop.is_set()
                        or cancel.is_set()
                        or self._attempts[slot] >= self._max_retries):
                    # out of budget (or no restart factory): surface to
                    # the consumer, as before
                    self._offer(q, exc)
                    return
                self._attempts[slot] += 1
                self.producer_retries += 1
                time.sleep(self._backoff * 2 ** (self._attempts[slot] - 1))
                source = self._make_source(slot, self._puts[slot])
                continue
            break
        self._offer(q, _STREAM_DONE)

    def _watch(self) -> None:
        """Watchdog: restart producers whose queue is empty and whose
        put-count is frozen past the timeout.  An empty queue rules out
        a producer blocked on a legitimately full queue (that is
        consumer-bound, not a stall), so a frozen count really means the
        generation itself is hung."""
        n = len(self._queues)
        seen = list(self._puts)
        since = [time.monotonic()] * n
        poll = min(self._watchdog / 4.0, self._POLL) or self._POLL
        while not self._stop.wait(poll):
            now = time.monotonic()
            for s in list(self._live):
                fresh = None
                with self._lock:
                    if self._puts[s] != seen[s] or not self._queues[s].empty():
                        seen[s] = self._puts[s]
                        since[s] = now
                        continue
                    if now - since[s] < self._watchdog:
                        continue
                    # hung: cancel this attempt under the lock (no put
                    # can interleave) and snapshot the resume point
                    self._cancels[s].set()
                    skip = self._puts[s]
                    since[s] = now
                    self.watchdog_fires += 1
                    if (self._restart is None
                            or self._attempts[s] >= self._max_retries):
                        fresh = False
                    else:
                        self._attempts[s] += 1
                        fresh = True
                if fresh is False:
                    self._offer(self._queues[s], ProducerStalledError(
                        f"shard {s} producer made no progress for "
                        f"{self._watchdog}s and exhausted its "
                        f"{self._max_retries} restarts"))
                elif fresh:
                    cancel = threading.Event()
                    self._cancels[s] = cancel
                    try:
                        src = self._restart(s, skip)
                    except BaseException as exc:
                        self._offer(self._queues[s], exc)
                        continue
                    self._spawn(s, src, cancel)

    def _resolve(self, item, s: int):
        if item is _STREAM_DONE:
            # drained: out of the rotation for good — never polled again
            self._live.discard(s)
            return None
        if isinstance(item, BaseException):
            raise item
        self._consumed += 1
        return (s, item)

    def __iter__(self):
        while self._live:
            progressed = False
            for s in sorted(self._live):
                try:
                    item = self._queues[s].get_nowait()
                except queue.Empty:
                    continue
                progressed = True
                got = self._resolve(item, s)
                if got is not None:
                    yield got
            if not progressed and self._live:
                # every live producer is mid-generation: block on the
                # lowest shard and record the stall
                self.stalls += 1
                if self.batch is not None and self._consumed:
                    self.batch.shrink()
                s = min(self._live)
                got = self._resolve(self._queues[s].get(), s)
                if got is not None:
                    yield got

    def close(self) -> None:
        """Stop the producers, drain the queues, and join the threads
        (idempotent); safe mid-iteration.

        Draining matters: a producer blocked on a full queue — including
        one trying to land its terminal exception or ``_STREAM_DONE``
        sentinel — frees up immediately instead of spinning out its stop
        timeout, and the join below then reaps every thread even when a
        producer raised after the consumer stopped iterating.
        """
        self._stop.set()
        for q in self._queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in self._threads:
            t.join(timeout=1.0)


def iter_plan_chunks(g: CompactDigraph, max_items: int,
                     orient: str = "none", pad_to: int = 1,
                     prune_self: bool = True) -> Iterator[PlanChunk]:
    """Generator convenience over :class:`PlanChunker`."""
    yield from PlanChunker(g, max_items, orient=orient, pad_to=pad_to,
                           prune_self=prune_self)
