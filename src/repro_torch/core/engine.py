"""Streaming census engine: monolithic, streamed and multi-device runs.

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
  buffer of O(pairs) descriptors
  (:class:`repro_torch.core.planner.DescriptorWindow`); the device builds
  the window's anchor table from them (a megastep's rows still carry
  theirs), maps every flat item index back to its pair, derives
  slot/side against the resident CSR and applies the pruning predicate
  in place.
* ``emit="host"``: emit, prune, pack and upload the O(W) item words in
  numpy — the oracle, and the path of prebuilt plans (:meth:`run_plan`).

``devices=`` (a list of :class:`LogicalDevice`, e.g.
:func:`repro_torch.core.distributed.default_devices`) runs on several
logical devices, each with its own CUDA stream — the counterpart of the
JAX package's ``mesh=``; several logical devices may share one card:

* **Replicated** (the default): every device holds the whole graph and
  each chunk's lanes are split into one contiguous slice per device; the
  per-device partials of a step are summed on the host (the reference's
  ``psum``).
* **Partitioned** (``partition=True``, or ``partition_2d=(P, V)``): the
  pair space is LPT-split into one private shard (or 2D tile) per device
  (:mod:`repro_torch.core.partition`); each device holds only its
  shard's relabeled local subgraph and walks its own window stream.
  ``schedule="lockstep"`` launches every shard's window of a step and
  waits for all of them (the oracle); ``schedule="async"`` (default)
  drains each shard's queue independently through background window
  producers (:class:`repro_torch.core.plan_stream.ShardStreamPipeline`)
  and, under device emission, launches one **megastep** per batch of up
  to ``max_windows_per_dispatch`` windows
  (:func:`repro_torch.core.census.census_partials_desc_batch`).

On CUDA every stream of dispatches overlaps host and device work: window
k+1 is built on the host and uploaded from pinned memory on a copy stream
while window k runs, and partials land (pinned, non-blocking copy, waited
on by event) only after later work has been dispatched.

Partials are integer sums and the closed-form bases are additive, so any
chunking, device count, partition and landing order is bit-identical to
the monolithic dispatch, for every backend, both orient modes and both
emit modes.

:meth:`CensusEngine.session` opens an :class:`EngineSession`: the graph
stays resident on the device and :meth:`EngineSession.update` recounts
only the pairs an edge delta touches (:mod:`repro_torch.core.incremental`),
bit-identical to a from-scratch census of the edited graph.

On several logical devices, :meth:`CensusEngine.session` opens a
replicated :class:`EngineSession` or, partitioned, a
:class:`PartitionedEngineSession` (2D: :class:`PartitionedEngineSession2D`)
whose delta updates dispatch only the shards owning touched pairs.

Fault tolerance (:mod:`repro_torch.core.faults`): async partitioned runs
retry every dispatch, retire failing logical devices to the survivors,
restart failed or stalled window producers and journal landed windows
for :meth:`CensusEngine.resume`; sessions retry on their own devices.
Only injected faults and partials that fail validation are retried.

Host phases are :func:`repro_torch.core.spans.span` ranges named
``census.*`` (:mod:`repro_torch.core.spans` lists them): a trace of a run
shows each, and every host-seconds field of :class:`EngineStats` is the
sum of one span's durations.  Outside a profiler a span costs a few
microseconds.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.census import (
    BACKENDS, assemble_census, assemble_counts, desc_anchors_fn,
    desc_batch_partials_fn, desc_partials_fn, partials_fn)
from repro_torch.core.digraph import CompactDigraph, GraphDelta, apply_delta
from repro_torch.core.faults import FaultError, FaultPlan, poison_result
from repro_torch.core.incremental import (
    affected_pair_ids, combine, contribution_counts,
    subset_descriptor_windows)
from repro_torch.core.pair_index import PairSpaceIndex
from repro_torch.core.partition import (
    extract_shard, graph_bytes, partition_graph, partition_graph_2d,
    range_postprune_pair_counts, replicated_graph_bytes, slice_pair_terms,
    stacked_device_arrays)
from repro_torch.core.plan_stream import (
    PlanChunker, ShardSchedule, ShardStreamPipeline, WindowBatcher)
from repro_torch.core.planner import (
    DESC_BYTES, DESC_SEARCH_ITERS, CensusPlan, PairSpace,
    PlanOverflowError, base_for_pairs, build_plan, emit_items,
    emit_items_for_pairs, global_bases, iter_descriptor_windows,
    max_pairs_per_window, num_desc_anchors, pad_and_pack, pair_space,
    postprune_pair_counts, split_device_words)
from repro_torch.core.spans import (
    ANCHORS, EMIT, GRAPH, INSTALL, MERGE, PAIR, PARTITION, PLAN, UPLOAD,
    WAIT, WINDOW, span, spanned)

#: work-item emission modes: ``device`` streams O(pairs) descriptors and
#: expands pairs→items on the device (the default); ``host`` materializes
#: and uploads every packed item in numpy (the oracle)
EMIT_MODES = ("device", "host")

#: partitioned execution disciplines: ``async`` (the default) walks each
#: shard's private window queue independently — no inter-shard barrier,
#: background per-shard window producers — so walltime tracks the MEAN
#: shard cost; ``lockstep`` advances every shard's queue together, one
#: barrier per step (the slowest shard gates each step), and is kept as
#: the bit-identity oracle
SCHEDULES = ("async", "lockstep")

#: per-shard produced-window queue depth of the async host pipeline
#: (2 == double-buffering: one window in flight, one pre-built behind it)
PIPELINE_DEPTH = 2

#: default cap K on the descriptor windows one async megastep launch
#: consumes: launch cost is paid once per up-to-K windows; the live batch
#: size adapts between 1 and this cap from stall/backlog feedback
#: (:class:`repro_torch.core.plan_stream.WindowBatcher`)
MAX_WINDOWS_PER_DISPATCH = 8

#: bytes per packed work item (two int32 words)
ITEM_BYTES = 8

#: partial words per window: hist64 then up to three counter lanes
_OUT_WORDS = 67


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names the CPU.

    ``None`` means the current CUDA device and raises when there is none
    — a census meant for the card never drops to the host silently; so
    does a CUDA index past the cards present.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "unless given device='cpu' (the plain torch path)")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               f"device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        elif device.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               f"are present")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use cuda or cpu")
    return device


@dataclass(frozen=True, eq=False)
class LogicalDevice:
    """One device of a multi-device run: a physical device and, on CUDA,
    a stream of its own, so that logical devices sharing one card launch
    concurrently.  Shard ``s`` of a partitioned run lives on logical
    device ``s``."""

    index: int
    device: torch.device
    #: the device's own ``torch.cuda.Stream``; None on the CPU (and for
    #: the single-device engine, which launches on the current stream)
    stream: object = None

    @classmethod
    def on(cls, index: int, device) -> "LogicalDevice":
        """Logical device ``index`` on ``device`` (resolved as
        :func:`resolve_device` does), with a new stream on CUDA."""
        device = resolve_device(device)
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)
        return cls(index, device, stream)


def resolve_devices(devices) -> list[LogicalDevice]:
    """Validate a device list: each entry a :class:`LogicalDevice` (its
    device checked again) or anything :func:`resolve_device` takes (given
    a stream of its own)."""
    out = []
    for i, d in enumerate(devices):
        if isinstance(d, LogicalDevice):
            resolve_device(d.device)
            out.append(LogicalDevice(i, d.device, d.stream))
        else:
            out.append(LogicalDevice.on(i, d))
    if not out:
        raise ValueError("devices must name at least one device")
    if len({d.device.type for d in out}) != 1:
        raise ValueError("devices mix the CPU and CUDA")
    return out


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


def _validate_partials(hist, inter) -> None:
    """Landing-time sanity check on fetched device partials: census
    histogram and intersection lanes are counts and can never go
    negative.  A corrupted (poisoned) result fails here, turning silent
    wrong answers into a retryable :class:`FaultError`."""
    if (hist < 0).any() or (inter < 0).any():
        raise FaultError(
            "device returned corrupted census partials (negative "
            "counts); retrying the window")


@dataclass
class EngineStats:
    """Execution stats of the last :class:`CensusEngine` run, field for
    field as the JAX package's ``EngineStats``.

    ``peak_plan_bytes`` is the per-dispatch item-lane footprint at
    packed-item width (``ITEM_BYTES * chunk_shape``, all devices);
    ``monolithic_plan_bytes`` is what one dispatch of the same work would
    have shipped; ``plan_upload_bytes`` is what each dispatch uploads to
    each device (packed items under host emission, divided across the
    devices when the items are split; the descriptor window under device
    emission, whole on every device when replicated, one private window
    per device when partitioned; the JAX package's count, anchor table
    included, also where the device builds the table and the dispatch
    ships none).  ``step_compiles`` and
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
    #: logical devices the run dispatched on
    ndev: int = 1
    #: work-item emission mode of the run ("host" or "device")
    emit: str = "host"
    #: fixed per-dispatch descriptor-array length (device emission only)
    desc_shape: int = 0
    plan_upload_bytes: int = 0
    #: session extras: valid items a full recompute of the current graph
    #: would process, and the affected pairs an update re-counted
    full_items: int = 0
    affected_pairs: int = 0
    #: True when the run sharded the GRAPH (each device held only its
    #: pair shard's local subgraph), not just the work items
    partitioned: bool = False
    #: (pair_shards, vertex_slices) of a 2D-partitioned run; None when
    #: un-partitioned or 1D (device d serves tile (d // V, d % V))
    partition_shape: tuple | None = None
    #: per-shard post-prune work items owned (partitioned runs: the LPT
    #: balance record)
    shard_items: list[int] = field(default_factory=list)
    #: per-device resident graph + pair bytes: the largest shard's when
    #: partitioned, the whole graph's otherwise
    graph_resident_bytes: int = 0
    #: what replication would have made ``graph_resident_bytes`` — equal
    #: to it on un-partitioned runs, >= it on partitioned ones
    graph_replicated_bytes: int = 0
    #: partitioned execution discipline ("async" or "lockstep"; "" when
    #: not partitioned)
    schedule: str = ""
    #: per-shard REAL dispatch steps (windows carrying pre-prune items)
    shard_steps: list[int] = field(default_factory=list)
    #: empty padded windows the lock-step barrier still launched
    #: (``num_steps * ndev − Σ shard_steps``); 0 under async
    idle_steps: int = 0
    #: async consumer stalls: moments every produced-window queue was
    #: empty and the host had to wait on a producer (pipeline-bound)
    stall_steps: int = 0
    #: per-shard produced-window queue depth of the async host pipeline
    pipeline_depth: int = 0
    #: host→device plan bytes of the REAL windows over the whole run,
    #: summed across devices and dispatches; masked padding that was
    #: shipped (megabatch rows past the real windows under async, empty
    #: windows under lock-step) is ``plan_pad_bytes_total``.  Runs that
    #: are not partitioned, and sessions, count the bytes their
    #: dispatches copied (a retried dispatch copies again; a prebuilt
    #: plan on one device has no dispatch and counts 0; a descriptor
    #: window's anchor table, built on the device, is not copied), where
    #: the JAX package leaves 0
    plan_upload_bytes_total: int = 0
    plan_pad_bytes_total: int = 0
    #: dispatches issued for the run's windows: one megastep launch per
    #: batch of up to ``dispatch_batch_limit`` windows under async, one
    #: step (every shard's window) under lock-step
    dispatches_total: int = 0
    #: real windows per dispatch, mean and max over the run
    windows_per_dispatch_mean: float = 0.0
    windows_per_dispatch_max: int = 0
    #: the megabatch cap K in effect (1 == no window batching, 0 == not
    #: a partitioned run)
    dispatch_batch_limit: int = 0
    #: fault-tolerance record: window dispatches re-attempted after a
    #: transient failure (injected, or partials that failed validation),
    #: logical devices retired to the survivors, watchdog-restarted
    #: producers, and the retired device ids — all zero/empty on a
    #: fault-free run
    retries: int = 0
    failovers: int = 0
    watchdog_fires: int = 0
    retired_devices: list = field(default_factory=list)
    #: windows restored from a checkpoint journal instead of re-executed
    resumed_windows: int = 0
    #: session host walltime by phase, each the sum of one span
    #: (:mod:`repro_torch.core.spans`): pair-space maintenance (rebuild,
    #: or index edit + affected-pair discovery when ``indexed``;
    #: ``census.session.pair``), the ``apply_delta`` CSR edit
    #: (``census.session.merge``), and work emission (items or descriptor
    #: windows and their words, each ``next()`` of the dispatch loop's
    #: stream, device waits excluded; ``census.session.emit``)
    host_pair_seconds: float = 0.0
    host_merge_seconds: float = 0.0
    host_emit_seconds: float = 0.0
    #: True when the pair space came from the session's persistent
    #: :class:`~repro_torch.core.pair_index.PairSpaceIndex`
    indexed: bool = False
    #: partitioned runs: host walltime of the pair space, the LPT and the
    #: shard extraction (the ``census.partition`` span)
    host_partition_seconds: float = 0.0
    #: sessions: host walltime writing the resident graph buffers, their
    #: padding and copies (the ``census.session.install`` span); the
    #: JAX package has no such field
    host_install_seconds: float = 0.0

    @property
    def plan_host_seconds(self) -> float:
        """Total host planning walltime (sum of the three phase buckets)."""
        return (self.host_pair_seconds + self.host_merge_seconds
                + self.host_emit_seconds)

    @property
    def shard_max_over_mean(self) -> float:
        """Shard work imbalance (1.0 == perfectly balanced shards)."""
        if not self.shard_items or not sum(self.shard_items):
            return 1.0
        mean = sum(self.shard_items) / len(self.shard_items)
        return max(self.shard_items) / mean

    @property
    def chunk_max_over_mean(self) -> float:
        """Streamed-schedule imbalance (1.0 == perfectly even chunks)."""
        if not self.chunk_items or not sum(self.chunk_items):
            return 1.0
        mean = sum(self.chunk_items) / len(self.chunk_items)
        return max(self.chunk_items) / mean

    def summary(self) -> str:
        mode = (f"streamed max_items={self.max_items}" if self.streamed
                else "monolithic")
        part = ""
        if self.partitioned:
            mesh2d = (f" mesh={self.partition_shape[0]}"
                      f"x{self.partition_shape[1]}"
                      if self.partition_shape else "")
            part = (f" partitioned[{self.schedule}]{mesh2d} "
                    f"shards={len(self.shard_items)} "
                    f"shard_max_over_mean={self.shard_max_over_mean:.3f} "
                    f"graph_bytes={self.graph_resident_bytes}"
                    f"/{self.graph_replicated_bytes}")
            if self.schedule == "async":
                part += (f" stalls={self.stall_steps} "
                         f"depth={self.pipeline_depth} "
                         f"dispatches={self.dispatches_total} "
                         f"win/disp={self.windows_per_dispatch_mean:.2f}"
                         f"/{self.windows_per_dispatch_max}"
                         f"(cap {self.dispatch_batch_limit})")
            else:
                part += f" idle_steps={self.idle_steps}"
        if (self.retries or self.failovers or self.watchdog_fires
                or self.resumed_windows):
            part += (f" faults[retries={self.retries} "
                     f"failovers={self.failovers} "
                     f"retired={self.retired_devices} "
                     f"watchdog_fires={self.watchdog_fires} "
                     f"resumed={self.resumed_windows}]")
        if self.plan_host_seconds:
            part += (f" host[pair={self.host_pair_seconds * 1e3:.2f}ms"
                     f" merge={self.host_merge_seconds * 1e3:.2f}ms"
                     f" emit={self.host_emit_seconds * 1e3:.2f}ms"
                     f" install={self.host_install_seconds * 1e3:.2f}ms"
                     f"{' indexed' if self.indexed else ''}]")
        return (f"{self.backend} [{mode} emit={self.emit}] "
                f"ndev={self.ndev} "
                f"chunks={self.chunks} items={self.items} "
                f"peak_plan_bytes={self.peak_plan_bytes} "
                f"(monolithic {self.monolithic_plan_bytes}) "
                f"plan_upload_bytes={self.plan_upload_bytes} "
                f"chunk_max_over_mean={self.chunk_max_over_mean:.3f} "
                f"step_compiles={self.step_compiles}" + part)


class _CheckpointJournal:
    """JSONL window journal for ``CensusEngine.run(checkpoint=)``, in the
    JAX package's format.

    Line 0 is the run fingerprint (graph + schedule identity); every
    further line records one landed dispatch: the shard, the explicit
    window ids it covered, the dispatch's summed int64 partials, and
    the per-window valid item counts.  Landings are flushed
    line-by-line, so a run killed mid-stream leaves a valid prefix.

    Resume correctness rests on the property the async machinery already
    proved: the host merge is an integer sum over independent windows,
    so restoring the journaled partials and *skipping exactly the
    journaled window ids* reproduces the uninterrupted census
    bit-identically — regardless of the order landings happened to
    reach the journal (retried windows can land out of per-shard
    order, hence explicit ids instead of prefix counts).
    """

    VERSION = 1

    def __init__(self, path: str, fingerprint: dict, ndev: int):
        self.path = path
        self.fingerprint = fingerprint
        #: per-shard set of yielded-window ids already landed
        self.done: list = [set() for _ in range(ndev)]
        self.hist = np.zeros(64, np.int64)
        self.inter = np.zeros(2, np.int64)
        self.chunk_items: list = []
        self.shard_items = [0] * ndev
        self.windows = 0
        self._f = None
        if os.path.exists(path):
            self._load(ndev)
        self._f = open(path, "a" if self.windows or self._header_ok
                       else "w")
        if not self._header_ok:
            self._f.write(json.dumps({"v": self.VERSION,
                                      **fingerprint}) + "\n")
            self._f.flush()

    _header_ok = False

    @staticmethod
    def graph_fingerprint(space, *, emit: str, ndev: int,
                          max_items) -> dict:
        return {
            "n": int(space.n), "pairs": int(space.num_pairs),
            "preprune": int(space.num_items_preprune),
            "packed_crc": int(zlib.crc32(
                np.ascontiguousarray(space.packed).tobytes())),
            "orient": space.orient, "prune_self": bool(space.prune_self),
            "emit": emit, "ndev": int(ndev),
            "max_items": None if max_items is None else int(max_items),
        }

    def _load(self, ndev: int) -> None:
        with open(self.path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            return
        head = json.loads(lines[0])
        want = {"v": self.VERSION, **self.fingerprint}
        if head != want:
            raise FaultError(
                f"checkpoint {self.path!r} was written by a different "
                f"run (header {head} != {want}); delete it or pass a "
                f"fresh path")
        self._header_ok = True
        for ln in lines[1:]:
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                break                      # torn final line from a kill
            s = int(rec["s"])
            ids = {int(x) for x in rec["ids"]}
            if ids & self.done[s]:
                continue                   # duplicate landing — ignore
            self.done[s] |= ids
            self.hist += np.asarray(rec["hist"], dtype=np.int64)
            self.inter += np.asarray(rec["inter"], dtype=np.int64)
            self.chunk_items.extend(int(x) for x in rec["items"])
            self.shard_items[s] += int(sum(rec["items"]))
            self.windows += len(ids)

    def record(self, s: int, ids, hist, inter, items) -> None:
        self._f.write(json.dumps({
            "s": int(s), "ids": [int(x) for x in ids],
            "hist": [int(x) for x in hist],
            "inter": [int(x) for x in inter],
            "items": [int(x) for x in items]}) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class _Pipeline:
    """Double-buffered host↔device traffic of one stream of dispatches.

    On CUDA, uploads go from two pinned host buffers to two device
    buffers on a copy stream of the pipeline's own; the compute
    ``stream`` (the current stream unless given — a logical device's
    own) waits on each upload's event.  A device buffer is written again
    only after the last kernel that read it (the copy stream waits on
    that kernel's event, on the device), and a pinned buffer is refilled
    only after its copy has completed.  Each dispatch's partials
    (``rows`` windows of them: K for a megastep) come back by a
    non-blocking copy into a pinned buffer from a ring of ``ring``,
    waited on by an event only when they are landed; a slot is taken by
    a launch (never by an attempt that failed before it) and freed when
    its dispatch lands, so the ring must exceed the dispatches in
    flight.  On the CPU everything is synchronous.

    Host time is spanned: ``census.upload`` around each host copy and
    its enqueue, ``census.wait`` around each block on a device event (a
    buffer's last copy, a dispatch's partials).  On the CPU the launch
    runs in place, the upload hands over a view and the wait is empty.
    :attr:`uploaded` counts the bytes handed to the device.
    """

    def __init__(self, device: torch.device, shape, *, stream=None,
                 rows: int = 1, ring: int = 2):
        self.device = device
        self.cuda = device.type == "cuda"
        self.rows = rows
        #: bytes of ``words`` that :meth:`submit` handed to the device
        self.uploaded = 0
        if not self.cuda:
            return
        self.stream = (stream if stream is not None
                       else torch.cuda.current_stream(device))
        self.copy_stream = torch.cuda.Stream(device)
        self.host_in = [torch.empty(shape, dtype=torch.int32,
                                    pin_memory=True) for _ in range(2)]
        self.dev_in = [torch.empty(shape, dtype=torch.int32, device=device)
                       for _ in range(2)]
        self.copied: list = [None, None]
        self.read: list = [None, None]
        self.host_out = [torch.empty(rows * _OUT_WORDS, dtype=torch.int32,
                                     pin_memory=True) for _ in range(ring)]
        self.done: list = [None] * ring
        self.busy = [False] * ring
        self.count = 0
        self.launched = 0

    def submit(self, words: np.ndarray, launch, fire=None,
               real: int | None = None):
        """Ship host buffer ``words``, enqueue ``launch(device_words) ->
        (hist, inter)`` on the compute stream and start bringing its
        partials back; returns a ticket for :meth:`land`.  With ``real``
        (a megastep batch's real windows) only the first ``real`` rows of
        ``words`` are copied, into the first rows of the device buffer,
        and the launch is ``launch(device_words, real)``: the rows past
        them keep whatever an earlier batch left there.  ``fire(site)``
        (a fault injector's hook) is called with ``"upload"`` before the
        copy and ``"dispatch"`` before the launch; when it raises, the
        attempt ends there and its buffers are reused only after their
        events, as for any dispatch."""
        if fire is not None:
            fire("upload")
        extra = () if real is None else (real,)
        rows = slice(None) if real is None else slice(0, real)
        if not self.cuda:
            with span(UPLOAD):
                device_words = torch.from_numpy(words)
                self.uploaded += words[rows].nbytes
            if fire is not None:
                fire("dispatch")
            return launch(device_words, *extra)
        k = self.count
        self.count += 1
        slot = k % 2
        if self.copied[slot] is not None:
            with span(WAIT):
                self.copied[slot].synchronize()
        with span(UPLOAD):
            self.host_in[slot][rows].numpy()[...] = words[rows]
            copied = torch.cuda.Event()
            with torch.cuda.stream(self.copy_stream):
                if self.read[slot] is not None:
                    self.copy_stream.wait_event(self.read[slot])
                self.dev_in[slot][rows].copy_(self.host_in[slot][rows],
                                              non_blocking=True)
                copied.record(self.copy_stream)
            self.copied[slot] = copied
            self.uploaded += words[rows].nbytes
        if fire is not None:
            fire("dispatch")
        r = self._take_slot()
        out = self.host_out[r]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(copied)
            hist, inter = launch(self.dev_in[slot], *extra)
            read = torch.cuda.Event()
            read.record(self.stream)
            self.read[slot] = read
            lanes = inter.numel() // self.rows
            n = self.rows * 64
            out[:n].copy_(hist.reshape(-1), non_blocking=True)
            out[n:n + self.rows * lanes].copy_(inter.reshape(-1),
                                               non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.done[r] = done
        return r, lanes

    def _take_slot(self) -> int:
        """The next free slot of the partials ring, marked busy."""
        ring = len(self.host_out)
        for i in range(ring):
            r = (self.launched + i) % ring
            if not self.busy[r]:
                self.launched = r + 1
                self.busy[r] = True
                return r
        raise RuntimeError(f"all {ring} partials buffers are in flight")

    def drain(self) -> None:
        """Wait for every dispatch still in flight and free its ring slot,
        dropping its partials: what a dispatch loop that raised a
        :class:`FaultError` left behind, so the next loop on this pipeline
        finds the ring free."""
        if not self.cuda:
            return
        with span(WAIT):
            for r, busy in enumerate(self.busy):
                if busy:
                    self.done[r].synchronize()
                    self.busy[r] = False

    def land(self, ticket) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a submitted dispatch; its partials as int64 arrays,
        ``(rows, 64)`` and ``(rows, lanes)``."""
        with span(WAIT):
            if self.cuda:
                self.done[ticket[0]].synchronize()
        if not self.cuda:
            hist, inter = ticket
            return (hist.reshape(self.rows, 64).numpy().astype(np.int64),
                    inter.reshape(self.rows, -1).numpy().astype(np.int64))
        r, lanes = ticket
        self.busy[r] = False
        out = self.host_out[r].numpy().astype(np.int64)
        n = self.rows * 64
        return (out[:n].reshape(self.rows, 64),
                out[n:n + self.rows * lanes].reshape(self.rows, lanes))


def _uploaded(pipes) -> int:
    """The bytes ``pipes`` handed their devices since last asked; their
    counters restart at 0."""
    total = sum(pipe.uploaded for pipe in pipes)
    for pipe in pipes:
        pipe.uploaded = 0
    return total


def _host_seconds(spans: dict) -> dict:
    """A session's :class:`EngineStats` host-seconds fields from its span
    totals."""
    return dict(host_pair_seconds=spans.get(PAIR, 0.0),
                host_merge_seconds=spans.get(MERGE, 0.0),
                host_emit_seconds=spans.get(EMIT, 0.0),
                host_install_seconds=spans.get(INSTALL, 0.0))


def _dispatch(pipes, launches, steps, landed=None, session=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Run each step that ``steps`` yields — one int32 host buffer per
    pipe — as one dispatch on every pipe, ``launches[d](device_words) ->
    (hist, inter)`` on ``pipes[d]``: step k+1 is built, uploaded and
    launched before step k lands, and a step lands when every pipe's
    dispatch has (the step's barrier), its partials summed in int64.
    Every dispatch has landed when it returns.

    With a ``session``, each step fires the session's fault injector
    (as shard 0 on device 0, before the first pipe's copy and launch),
    is retried under the engine's budget, and its summed partials are
    validated as they land (:func:`_land_retrying_session`).

    ``landed(k, inter)`` is called with each step's summed int64 ``inter``
    lanes as it lands, in order.  Returns the int64 sums of ``hist`` and
    of ``inter``'s two census lanes."""
    hist_acc = np.zeros(64, np.int64)
    inter_acc = np.zeros(2, np.int64)
    inj = None if session is None else session._injector
    fire = (None if inj is None else
            lambda site: inj.fire(site, shard=0, device=0))

    def submit(buffers):
        tickets = [pipe.submit(words, launch, fire if d == 0 else None)
                   for d, (pipe, launch, words) in enumerate(
                       zip(pipes, launches, buffers))]
        return tickets, (inj.take_poison() if inj is not None else False)

    def fetch(tickets):
        hist = np.zeros(64, np.int64)
        inter = None
        for pipe, ticket in zip(pipes, tickets):
            h, i = pipe.land(ticket)
            hist += h[0]
            inter = i[0] if inter is None else inter + i[0]
        return hist, inter

    def dispatch(buffers):
        if session is None:
            return submit(buffers)
        return _dispatch_retrying_session(session, lambda: submit(buffers))

    def land(k, job):
        (tickets, poisoned), buffers = job
        if session is None:
            hist, inter = fetch(tickets)
        else:
            hist, inter = _land_retrying_session(
                session, fetch, tickets, poisoned,
                lambda: dispatch(buffers))
        hist_acc[:] += hist
        inter_acc[:] += inter[:2]
        if landed is not None:
            landed(k, inter)

    pending = None
    try:
        for k, buffers in enumerate(steps):
            job = (dispatch(buffers), buffers)
            if pending is not None:
                land(k - 1, pending)
            pending = job
        if pending is not None:
            land(k, pending)
    except FaultError:
        # a step that failed past its budget leaves the step before it
        # (or after it) in flight; a session that recovers from the fault
        # must find every ring slot free.  Any other error surfaces as it
        # is, with the ring left as it stood.
        for pipe in pipes:
            pipe.drain()
        raise
    return hist_acc, inter_acc


def _item_launcher(step, graph, chunk_shape: int):
    """``launch`` for :func:`_dispatch` over ``[item_sp…, item_pv…]``
    buffers (host emission)."""
    return lambda words: step(*graph, words[:chunk_shape],
                              words[chunk_shape:])


def _anchored(words, table: torch.Tensor, anchors):
    """A descriptor-window buffer that ships no anchor table
    (``[num_preprune, desc_pair…, desc_cum…, desc_within0…]``) as the
    desc step's ``(desc_pair, desc_cum, desc_within0, anchors,
    num_valid)``, its anchor table built from ``desc_cum`` into ``table``
    by ``anchors`` (:func:`repro_torch.core.census.desc_anchors_fn`) on
    the current stream: the ``census.window.anchors`` span.

    The step that reads the table is enqueued next on the same stream,
    and the next window's table only after it, so one table per launcher
    (per compute stream) serves every dispatch without a ring."""
    nv, dp, dc, dw, _ = split_device_words(words, 0)
    with span(ANCHORS):
        an = anchors(dc, table)
    return dp, dc, dw, an, nv


def _desc_launcher(step, anchors, graph, idx: torch.Tensor,
                   num_anchors: int):
    """``launch`` for :func:`_dispatch` over descriptor-window buffers
    without anchor tables (device emission): each window's table is built
    on ``idx``'s device into this launcher's own (:func:`_anchored`)."""
    table = torch.empty(num_anchors, dtype=torch.int32, device=idx.device)

    def launch(words):
        return step(*graph, *_anchored(words, table, anchors), idx)
    return launch


class CensusEngine:
    """Census engine: monolithic, streamed and multi-device runs.

    ``device=None`` runs on the CUDA device and raises when there is
    none; ``device="cpu"`` runs every backend's plain torch version on
    the host (the kernel wrappers take their plain versions for CPU
    tensors).  ``backend`` is ``"fused"`` (the default: one CUDA kernel
    per dispatch), ``"hist"`` (torch classification + the histogram
    kernel) or ``"torch"`` (plain torch, the oracle).

    ``devices`` (instead of ``device``) is a list of logical devices
    (:func:`repro_torch.core.distributed.default_devices`; entries may
    also be plain devices, each given a stream of its own): the
    counterpart of the JAX package's ``mesh``.  Un-partitioned runs
    replicate the graph and split each chunk's lanes across the devices;
    ``partition=True`` shards the GRAPH, one LPT pair shard per device,
    and ``partition_2d=(P, V)`` (``P * V == len(devices)``) splits each
    pair shard's witness range over V vertex slices.  Partitioned runs
    follow ``schedule`` (``"async"`` or ``"lockstep"``, see
    :data:`SCHEDULES`); the async schedule keeps ``pipeline_depth``
    produced windows per shard and batches up to
    ``max_windows_per_dispatch`` descriptor windows per megastep launch.
    After each :meth:`run` / :meth:`run_plan` the execution record is
    :attr:`stats`.

    Fault tolerance (the JAX package's knobs and defaults): every async
    partitioned dispatch, and every session dispatch, is retried up to
    ``max_retries`` times with exponential ``retry_backoff`` sleeps;
    ``watchdog_timeout`` (seconds, None == off) restarts stalled window
    producers; ``faults`` is an optional
    :class:`repro_torch.core.faults.FaultPlan` to inject against.  Only
    injected faults and partials that fail validation are retried: a
    CUDA error surfaces as it is.
    """

    def __init__(self, device=None, backend: str = "fused",
                 emit: str = "device", *, devices=None,
                 partition: bool = False,
                 partition_2d: tuple | None = None,
                 schedule: str = "async",
                 pipeline_depth: int = PIPELINE_DEPTH,
                 max_windows_per_dispatch: int = MAX_WINDOWS_PER_DISPATCH,
                 max_retries: int = 2, retry_backoff: float = 0.01,
                 watchdog_timeout: float | None = None,
                 faults: FaultPlan | None = None):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; one of {BACKENDS}")
        if emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        if schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; one of {SCHEDULES}")
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        if partition_2d is not None:
            partition = True          # a 2D factorization implies it
            partition_2d = (int(partition_2d[0]), int(partition_2d[1]))
            if partition_2d[0] < 1 or partition_2d[1] < 1:
                raise ValueError(
                    f"partition_2d must be >= (1, 1), got {partition_2d}")
        if partition and devices is None:
            raise ValueError("partition=True requires devices")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if max_windows_per_dispatch < 1:
            raise ValueError(
                "max_windows_per_dispatch must be >= 1, got "
                f"{max_windows_per_dispatch}")
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {max_retries}")
        if retry_backoff < 0:
            raise ValueError(
                f"retry_backoff must be >= 0, got {retry_backoff}")
        if watchdog_timeout is not None and watchdog_timeout <= 0:
            raise ValueError(
                f"watchdog_timeout must be > 0, got {watchdog_timeout}")
        self.devices = None if devices is None else resolve_devices(devices)
        if (partition_2d is not None
                and partition_2d[0] * partition_2d[1] != self.ndev):
            raise ValueError(
                f"partition_2d {partition_2d} needs "
                f"{partition_2d[0] * partition_2d[1]} devices; "
                f"{self.ndev} given")
        self.device = (resolve_device(device) if self.devices is None
                       else self.devices[0].device)
        self.backend = backend
        self.emit = emit
        self.partition = bool(partition)
        #: (pair_shards, vertex_slices) factorization of the device list;
        #: device d serves tile (d // V, d % V).  None == 1D partition.
        self.partition_2d = partition_2d
        self.schedule = schedule
        self.pipeline_depth = int(pipeline_depth)
        self.max_windows_per_dispatch = int(max_windows_per_dispatch)
        #: fault-tolerance knobs: per-window re-dispatch budget with
        #: exponential ``retry_backoff`` sleeps, producer-stall watchdog
        #: (None == off), and an optional deterministic
        #: :class:`repro_torch.core.faults.FaultPlan` to inject against
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.watchdog_timeout = (None if watchdog_timeout is None
                                 else float(watchdog_timeout))
        self.faults = faults
        self.stats: EngineStats | None = None

    @property
    def ndev(self) -> int:
        return 1 if self.devices is None else len(self.devices)

    def _lanes(self) -> list[LogicalDevice]:
        """The logical devices a run dispatches on: the device list, or
        the engine's one device on its current stream."""
        if self.devices is None:
            return [LogicalDevice(0, self.device)]
        return self.devices

    def _upload_graph(self, arrays, device=None) -> tuple[torch.Tensor, ...]:
        device = self.device if device is None else device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrays)

    def _replicate(self, lanes, arrays) -> dict:
        """``arrays`` uploaded once to each physical device of ``lanes``
        (logical devices on one card share them); every lane's stream is
        ordered after the uploads."""
        dev = {}
        for ld in lanes:
            if ld.device not in dev:
                dev[ld.device] = self._upload_graph(arrays, ld.device)
        _after_uploads(lanes)
        return dev

    @staticmethod
    def _flat_index(lanes, n: int) -> dict:
        """The flat item-index array ``arange(n)``, made once on each
        physical device of ``lanes``."""
        idx = {}
        for ld in lanes:
            if ld.device not in idx:
                idx[ld.device] = torch.arange(n, dtype=torch.int32,
                                              device=ld.device)
        _after_uploads(lanes)
        return idx

    def _stats(self, **kw) -> EngineStats:
        return EngineStats(backend=self.backend, ndev=self.ndev, **kw)

    # ------------------------------------------------------------- running
    def run_plan(self, plan: CensusPlan) -> np.ndarray:
        """Exact 16-type census from a prebuilt (monolithic) plan; on
        several devices the items are split across them."""
        if self.partition:
            raise ValueError(
                "prebuilt plans are replicated; partitioned execution "
                "plans from the graph — use run()")
        wp = int(plan.item_sp.shape[0])
        ndev = self.ndev
        if wp % ndev != 0:
            raise ValueError(
                f"plan padded to {wp} items, not a multiple of {ndev} "
                f"devices; build with pad_to=num_devices")
        gbytes = graph_bytes(plan.indptr.shape[0], plan.packed.shape[0],
                             plan.num_pairs)
        self.stats = self._stats(
            orient=plan.orient, streamed=False,
            max_items=None, chunks=1 if plan.num_items else 0,
            chunk_shape=wp, items=plan.num_items,
            chunk_items=[plan.num_items] if plan.num_items else [],
            peak_plan_bytes=ITEM_BYTES * wp,
            monolithic_plan_bytes=ITEM_BYTES * wp, emit="host",
            plan_upload_bytes=ITEM_BYTES * wp // ndev,
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if plan.num_pairs == 0 or plan.num_items == 0:
            # zero-work plans resolve entirely from the host closed forms
            return assemble_census(plan, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        step = partials_fn(self.backend, plan.search_iters)
        if self.devices is None:
            with span(GRAPH):
                arrays = self._upload_graph((plan.indptr, plan.packed,
                                             plan.pair_u, plan.pair_v,
                                             plan.pair_code, plan.item_sp,
                                             plan.item_pv))
            hist64, inter = step(*arrays)
            return assemble_census(plan, hist64.cpu().numpy(),
                                   inter.cpu().numpy())
        lanes = self._lanes()
        with span(GRAPH):
            graph = self._replicate(lanes, (plan.indptr, plan.packed,
                                            plan.pair_u, plan.pair_v,
                                            plan.pair_code))
        per = wp // ndev
        pipes = [_Pipeline(ld.device, (2 * per,), stream=ld.stream)
                 for ld in lanes]
        launches = [_item_launcher(step, graph[ld.device], per)
                    for ld in lanes]
        buffers = [np.concatenate([plan.item_sp[d * per:(d + 1) * per],
                                   plan.item_pv[d * per:(d + 1) * per]])
                   for d in range(ndev)]
        hist, inter = _dispatch(pipes, launches, [buffers])
        self.stats.plan_upload_bytes_total = _uploaded(pipes)
        return assemble_census(plan, hist, inter)

    def run(self, g: CompactDigraph, *, max_items: int | None = None,
            orient: str = "none", prune_self: bool = True,
            progress=None, emit: str | None = None,
            schedule: str | None = None, part=None,
            checkpoint: str | None = None) -> np.ndarray:
        """Plan + count ``g`` end to end.

        ``max_items=None`` covers the whole item space in one dispatch;
        an integer budget streams bounded chunks instead.  ``emit``
        (default: the engine's mode) picks the work-item path.
        ``progress(chunk_index, num_chunks, chunk_valid_items)`` is called
        per chunk — at dispatch under host emission, when the chunk's
        device-counted valid items land under device emission.

        Partitioned engines also take ``schedule`` (default: the
        engine's) and ``part`` — a prebuilt
        :class:`repro_torch.core.partition.GraphPartition` (or
        ``GraphPartition2D``) of ``len(devices)`` shards, overriding the
        internal LPT (``orient``/``prune_self`` are then its space's).

        ``checkpoint`` (partitioned async runs only) journals every
        landed window to the given JSONL path; a later ``run`` (or
        :meth:`resume`) against an existing journal restores the
        journaled partials, skips the completed windows, and reproduces
        the uninterrupted census bit-identically.
        """
        emit = self.emit if emit is None else emit
        if emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        schedule = self.schedule if schedule is None else schedule
        if schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; one of {SCHEDULES}")
        if part is not None and not self.partition:
            raise ValueError(
                "a prebuilt partition requires partition=True")
        if checkpoint is not None and not (
                self.partition and schedule == "async"):
            raise ValueError(
                "checkpoint/resume is supported on partitioned async "
                "runs (partition=True, schedule='async')")
        if self.partition:
            return self._run_partitioned(g, max_items=max_items,
                                         orient=orient,
                                         prune_self=prune_self,
                                         progress=progress, emit=emit,
                                         schedule=schedule, part=part,
                                         checkpoint=checkpoint)
        with span(PLAN):
            if emit == "host" and max_items is None:
                plan = build_plan(g, pad_to=self.ndev, orient=orient,
                                  prune_self=prune_self)
            else:
                chunker = PlanChunker(g, max_items, orient=orient,
                                      pad_to=self.ndev,
                                      prune_self=prune_self)
        if emit == "device":
            return self._run_stream_desc(chunker, progress,
                                         max_items=max_items)
        if max_items is None:
            return self.run_plan(plan)
        return self._run_stream(chunker, progress)

    def resume(self, g: CompactDigraph, checkpoint: str,
               **kwargs) -> np.ndarray:
        """Resume a checkpointed partitioned async run: requires the
        journal to exist (use :meth:`run` with ``checkpoint=`` to start
        one), restores its landed windows, and completes the rest —
        bit-identical to the uninterrupted run."""
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(
                f"no checkpoint journal at {checkpoint!r}; start the "
                f"run with run(..., checkpoint=path) first")
        return self.run(g, checkpoint=checkpoint, **kwargs)

    @staticmethod
    def compact_checkpoint(checkpoint: str) -> dict:
        """Fold an append-only checkpoint journal into its minimal form.

        A long checkpointed run appends one JSONL record per landed
        dispatch, so the journal grows with the window count even though
        resume only needs the *sums*.  Compaction rewrites the file as
        the fingerprint header plus ONE merged record per shard (summed
        partials, unioned window ids, concatenated per-window item
        counts) — the landing merge is an integer sum over independent
        windows, so :meth:`resume` restores the compacted journal to the
        exact state the full journal would have produced, and keeps
        appending new landings after it (``_load`` is additive per
        record; both forms read identically).

        Duplicate landings and a torn final line are dropped the same
        way loading drops them.  The rewrite is atomic (temp file +
        ``os.replace``), so a kill mid-compaction leaves the original
        journal intact.  Returns ``{"records", "compacted", "bytes",
        "compacted_bytes"}``.
        """
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(
                f"no checkpoint journal at {checkpoint!r}")
        old_bytes = os.path.getsize(checkpoint)
        with open(checkpoint) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if not lines:
            raise FaultError(
                f"checkpoint {checkpoint!r} is empty — nothing to "
                f"compact")
        head = json.loads(lines[0])
        if head.get("v") != _CheckpointJournal.VERSION:
            raise FaultError(
                f"checkpoint {checkpoint!r} has unknown version "
                f"{head.get('v')!r}")
        # replay the records exactly the way _load does (skip duplicate
        # landings and the torn tail), but keep the sums per shard
        merged: dict = {}
        records = 0
        for ln in lines[1:]:
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                break
            records += 1
            s = int(rec["s"])
            m = merged.setdefault(s, {
                "ids": set(), "hist": np.zeros(64, np.int64),
                "inter": np.zeros(2, np.int64), "items": []})
            ids = {int(x) for x in rec["ids"]}
            if ids & m["ids"]:
                continue
            m["ids"] |= ids
            m["hist"] += np.asarray(rec["hist"], dtype=np.int64)
            m["inter"] += np.asarray(rec["inter"], dtype=np.int64)
            m["items"].extend(int(x) for x in rec["items"])
        tmp = checkpoint + ".compact.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(head) + "\n")
            for s in sorted(merged):
                m = merged[s]
                f.write(json.dumps({
                    "s": s, "ids": sorted(m["ids"]),
                    "hist": [int(x) for x in m["hist"]],
                    "inter": [int(x) for x in m["inter"]],
                    "items": m["items"]}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, checkpoint)
        return {"records": records, "compacted": len(merged),
                "bytes": old_bytes,
                "compacted_bytes": os.path.getsize(checkpoint)}

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

        A partitioned engine opens a :class:`PartitionedEngineSession`
        (a 2D one a :class:`PartitionedEngineSession2D`), whose delta
        updates dispatch only the shards owning touched pairs;
        ``auto_rebalance_threshold`` (partitioned only) re-shards it with
        a fresh LPT whenever churn pushes the load ``max/mean`` past it
        (see :meth:`PartitionedEngineSession.rebalance`).  An engine on
        several devices without ``partition`` opens a replicated
        :class:`EngineSession`: every device holds the graph and each
        dispatch's lanes are split across them."""
        if self.partition:
            if self.partition_2d is not None:
                return PartitionedEngineSession2D(
                    self, g, mesh_shape=self.partition_2d,
                    orient=orient, prune_self=prune_self,
                    max_items=max_items, emit=emit,
                    auto_rebalance_threshold=auto_rebalance_threshold,
                    index=index)
            return PartitionedEngineSession(
                self, g, orient=orient, prune_self=prune_self,
                max_items=max_items, emit=emit,
                auto_rebalance_threshold=auto_rebalance_threshold,
                index=index)
        if auto_rebalance_threshold is not None:
            raise ValueError(
                "auto_rebalance_threshold requires partition=True")
        return EngineSession(self, g, orient=orient, prune_self=prune_self,
                             max_items=max_items, emit=emit, index=index)

    def _run_stream(self, chunker: PlanChunker, progress) -> np.ndarray:
        """Host-emission stream: per chunk the host emits, packs and
        uploads the chunk's item words, each device its contiguous slice
        (``[item_sp…, item_pv…]``); fully pruned chunks are not
        dispatched."""
        space = chunker.space
        shape = chunker.chunk_shape
        ndev = self.ndev
        per = shape // ndev
        gbytes = replicated_graph_bytes(space)
        self.stats = self._stats(
            orient=space.orient, streamed=True,
            max_items=chunker.max_items, chunks=chunker.num_chunks,
            chunk_shape=shape, items=0,
            peak_plan_bytes=ITEM_BYTES * shape, emit="host",
            # item arrays are split over the devices: per-device bytes
            plan_upload_bytes=ITEM_BYTES * shape // ndev,
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if chunker.num_chunks == 0:
            return assemble_counts(space.n, 0, 0, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        lanes = self._lanes()
        with span(GRAPH):
            graph = self._replicate(lanes, chunker.device_arrays())
        step = partials_fn(self.backend, space.search_iters)
        pipes = [_Pipeline(ld.device, (2 * per,), stream=ld.stream)
                 for ld in lanes]
        launches = [_item_launcher(step, graph[ld.device], per)
                    for ld in lanes]
        base_asym = base_mut = 0
        chunk_items: list[int] = []

        def steps():
            nonlocal base_asym, base_mut
            for k in range(chunker.num_chunks):
                with span(WINDOW):
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
                    yield [np.concatenate(
                        [chunk.item_sp[d * per:(d + 1) * per],
                         chunk.item_pv[d * per:(d + 1) * per]])
                        for d in range(ndev)]

        hist_acc, inter_acc = _dispatch(pipes, launches, steps())

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * (-(-st.items // ndev) * ndev)
        st.plan_upload_bytes_total = _uploaded(pipes)
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)

    def _run_stream_desc(self, chunker: PlanChunker, progress,
                         max_items: int | None) -> np.ndarray:
        """Device-emission stream: per chunk the host ships the O(pairs)
        descriptor window (whole, to every device), each device builds the
        window's anchor table and expands pairs→items against the
        resident flat-index array, each device its contiguous slice of
        it.  Bit-identical to :meth:`_run_stream`
        — every item the plan would prune is a zero contribution of the
        classification masks (see
        :func:`repro_torch.core.census.prune_keep_mask`)."""
        space = chunker.space
        ndev = self.ndev
        words_len = 1 + 3 * chunker.desc_shape
        gbytes = replicated_graph_bytes(space)
        self.stats = self._stats(
            orient=space.orient,
            streamed=max_items is not None, max_items=max_items,
            chunks=chunker.num_chunks, chunk_shape=chunker.chunk_shape,
            items=0, peak_plan_bytes=ITEM_BYTES * chunker.chunk_shape,
            emit="device", desc_shape=chunker.desc_shape,
            # the descriptor buffer goes whole to every device (as the
            # JAX package ships it: anchors included)
            plan_upload_bytes=(DESC_BYTES * chunker.desc_shape
                               + 4 * chunker.num_anchors + 4),
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if chunker.num_chunks == 0:
            return assemble_counts(space.n, 0, 0, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        lanes = self._lanes()
        with span(GRAPH):
            graph = self._replicate(lanes, chunker.device_arrays())
            # the flat item-index space: made on each device once, reused
            # by every chunk; device d expands its contiguous slice of it
            idx = self._flat_index(lanes, chunker.chunk_shape)
        per = chunker.chunk_shape // ndev
        step = desc_partials_fn(self.backend, space.search_iters,
                                chunker.desc_iters, space.orient,
                                space.prune_self)
        pipes = [_Pipeline(ld.device, (words_len,), stream=ld.stream)
                 for ld in lanes]
        anchors = desc_anchors_fn(self.backend)
        launches = [
            _desc_launcher(step, anchors, graph[ld.device],
                           idx[ld.device][d * per:(d + 1) * per],
                           chunker.num_anchors)
            for d, ld in enumerate(lanes)]
        base_asym = base_mut = 0
        chunk_items: list[int] = []

        def steps():
            nonlocal base_asym, base_mut
            for k in range(chunker.num_chunks):
                ba, bm = chunker.bases(k)
                base_asym += ba
                base_mut += bm
                with span(WINDOW):
                    host_words = chunker.descriptors(
                        k, anchors=False).device_words()
                yield [host_words] * ndev

        def landed(k, inter):
            chunk_items.append(int(inter[2]))
            if progress is not None:
                progress(k, chunker.num_chunks, int(inter[2]))

        hist_acc, inter_acc = _dispatch(pipes, launches, steps(), landed)

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * (-(-st.items // ndev) * ndev)
        st.plan_upload_bytes_total = _uploaded(pipes)
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)

    # -------------------------------------------------------- partitioned
    def _run_partitioned(self, g: CompactDigraph, *,
                         max_items: int | None, orient: str,
                         prune_self: bool, progress, emit: str,
                         schedule: str, part=None,
                         checkpoint: str | None = None) -> np.ndarray:
        """Partitioned plan + count: LPT-shard the pair space (or take a
        prebuilt ``part``), extract one local subgraph per device, and
        walk every device's private window queue
        (:class:`repro_torch.core.plan_stream.ShardSchedule`).  Each
        device holds only ITS shard's relabeled CSR + pair arrays and
        receives only its own descriptor windows (``emit="device"``) or
        packed item windows (``emit="host"``).  Bit-identical to the
        replicated and single-device paths for every backend, orient,
        emit and schedule (the relabeling is order-preserving, the pair
        partition is exact, and the partials are integer sums)."""
        spans: dict = {}
        with span(PARTITION, spans):
            if part is None:
                space = pair_space(g, orient=orient, prune_self=prune_self)
                part = (partition_graph_2d(space=space,
                                           mesh_shape=self.partition_2d)
                        if self.partition_2d is not None
                        else partition_graph(num_shards=self.ndev,
                                             space=space))
            elif part.num_shards != self.ndev:
                raise ValueError(
                    f"prebuilt partition has {part.num_shards} shards for "
                    f"{self.ndev} devices")
            elif (self.partition_2d is not None
                  and getattr(part, "mesh_shape", None)
                  != self.partition_2d):
                raise ValueError(
                    f"prebuilt partition mesh "
                    f"{getattr(part, 'mesh_shape', None)} does not match "
                    f"partition_2d={self.partition_2d}")
        with span(PLAN):
            sched = ShardSchedule([sh.space for sh in part.shards],
                                  max_items, self.ndev,
                                  mesh_shape=getattr(part, "mesh_shape",
                                                     None))
        upload = (4 * (1 + 3 * sched.desc_shape + sched.num_anchors)
                  if emit == "device"
                  else ITEM_BYTES * sched.chunk_shape)
        if schedule == "async":
            census = self._run_partitioned_async(part, sched, progress,
                                                 emit, max_items, upload,
                                                 checkpoint=checkpoint)
        else:
            census = self._run_partitioned_lockstep(part, sched, progress,
                                                    emit, max_items, upload)
        self.stats.host_partition_seconds = spans[PARTITION]
        return census

    def _shard_graphs(self, arrs) -> list[tuple[torch.Tensor, ...]]:
        """Each shard's padded local arrays (``arrs``: the
        :func:`stacked_device_arrays` of its partition — common lengths,
        as the reference ships them) committed to its logical device."""
        graphs = [self._upload_graph([a[s] for a in arrs], ld.device)
                  for s, ld in enumerate(self.devices)]
        _after_uploads(self.devices)
        return graphs

    def _run_partitioned_lockstep(self, part, sched: ShardSchedule,
                                  progress, emit: str,
                                  max_items: int | None,
                                  upload: int) -> np.ndarray:
        """Lock-step schedule: step k launches every shard's step-k
        window — empty padded windows of drained shards included, as the
        reference ships them — each on its device's stream, and the
        step lands when all of them have: one barrier per step, the host
        summing the shards' partials in int64."""
        space = part.space
        ndev = self.ndev
        self.stats = self._stats(
            orient=space.orient,
            streamed=max_items is not None, max_items=max_items,
            chunks=sched.num_steps,
            chunk_shape=sched.chunk_shape * ndev, items=0,
            peak_plan_bytes=ITEM_BYTES * sched.chunk_shape * ndev,
            emit=emit,
            desc_shape=sched.desc_shape if emit == "device" else 0,
            plan_upload_bytes=upload, partitioned=True,
            partition_shape=getattr(part, "mesh_shape", None),
            shard_items=list(part.stats.shard_items),
            graph_resident_bytes=part.stats.max_shard_bytes,
            graph_replicated_bytes=part.stats.replicated_bytes,
            schedule="lockstep", shard_steps=sched.shard_steps,
            idle_steps=sched.num_steps * ndev - sched.total_windows,
            plan_upload_bytes_total=sched.total_windows * upload,
            plan_pad_bytes_total=(sched.num_steps * ndev
                                  - sched.total_windows) * upload,
            dispatches_total=sched.num_steps,
            windows_per_dispatch_mean=(
                sched.total_windows / sched.num_steps
                if sched.num_steps else 0.0),
            # live lanes per step never exceed step 0's (shards only
            # drain), so the max is the non-empty shard count
            windows_per_dispatch_max=sum(
                1 for t in sched.shard_steps if t > 0),
            dispatch_batch_limit=1)
        base_asym, base_mut = global_bases(space)
        if sched.num_steps == 0:
            return assemble_counts(space.n, base_asym, base_mut,
                                   np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        lanes = self.devices
        cs = sched.chunk_shape
        with span(GRAPH):
            graphs = self._shard_graphs(stacked_device_arrays(part.shards))
            if emit == "device":
                idx = self._flat_index(lanes, cs)
        chunk_items: list[int] = []
        if emit == "device":
            step = desc_partials_fn(self.backend, space.search_iters,
                                    sched.desc_iters, space.orient,
                                    space.prune_self)
            anchors = desc_anchors_fn(self.backend)
            pipes = [_Pipeline(ld.device, (1 + 3 * sched.desc_shape,),
                               stream=ld.stream) for ld in lanes]
            launches = [_desc_launcher(step, anchors, graphs[s],
                                       idx[ld.device], sched.num_anchors)
                        for s, ld in enumerate(lanes)]

            def steps():
                for k in range(sched.num_steps):
                    with span(WINDOW):
                        words = sched.step_words(k)
                    yield list(words)

            def landed(k, inter):
                chunk_items.append(int(inter[2]))
                if progress is not None:
                    progress(k, sched.num_steps, int(inter[2]))

            hist_acc, inter_acc = _dispatch(pipes, launches, steps(),
                                            landed)
        else:
            step = partials_fn(self.backend, space.search_iters)
            pipes = [_Pipeline(ld.device, (2 * cs,), stream=ld.stream)
                     for ld in lanes]
            launches = [_item_launcher(step, graphs[s], cs)
                        for s in range(ndev)]

            def steps():
                for k in range(sched.num_steps):
                    with span(WINDOW):
                        item_sp, item_pv, nums = sched.step_items(k)
                    chunk_items.append(int(sum(nums)))
                    if progress is not None:
                        progress(k, sched.num_steps, chunk_items[-1])
                    yield [np.concatenate([item_sp[s], item_pv[s]])
                           for s in range(ndev)]

            hist_acc, inter_acc = _dispatch(pipes, launches, steps())

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * (-(-st.items // ndev) * ndev)
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)

    def _run_partitioned_async(self, part, sched: ShardSchedule,
                               progress, emit: str,
                               max_items: int | None,
                               upload: int,
                               checkpoint: str | None = None
                               ) -> np.ndarray:
        """Async per-shard streams: every device drains its PRIVATE
        window queue with no inter-shard barrier.

        One background producer per non-empty shard builds that shard's
        windows (numpy only) ``pipeline_depth`` ahead into its private
        queue (:class:`repro_torch.core.plan_stream.ShardStreamPipeline`);
        zero-window shards get no producer and no rotation slot.  This
        thread does every upload and launch: each window (or megabatch)
        goes through its shard's double-buffered pinned pipeline onto the
        stream of the logical device serving the shard, with a bounded
        in-flight deque of ``2 * ndev`` dispatches.

        Under ``emit="device"`` each dispatch is a **megastep**: the
        producer coalesces up to K descriptor windows into one
        ``(cap, words)`` batch (:class:`repro_torch.core.plan_stream
        .WindowBatcher`, ``cap = min(max_windows_per_dispatch, longest
        shard queue)``) and one launch runs them all; K adapts between 1
        and ``cap`` from stalls and backlog.  Only the batch's real rows
        are uploaded and launched; the stats still count the padded
        shape, as the JAX package's engine defines them.  ``emit="host"``
        dispatches one window at a time and skips fully pruned windows.

        Partials land on the host in int64, in any order — integer
        sums, so the landing order cannot change a bit.

        **Fault tolerance** rides on the same property: windows are
        independent and the merge is order-invariant, so any window can
        be re-dispatched or re-routed to a surviving logical device
        without changing a census bit.  Every dispatch is retried up to
        ``max_retries`` times with exponential backoff after an injected
        fault or partials that fail validation (poisoned rows, widened
        to int64, are checked on their first ``x`` rows); a device that
        exhausts the budget (or hits a persistent injected fault) is
        retired — its stream gets no further launch — and each shard it
        served moves to a survivor's stream, reusing the shard's resident
        tensors on the same card (re-uploaded from the host copies on
        another), ordered after their upload by event.  Failover routes
        among the engine's logical devices only.  Stalled producers are
        restarted by the pipeline watchdog, failed ones from their skip
        count, and ``checkpoint=`` journals every landed window so a
        killed run resumes to the same census.  A CUDA error is never
        retried: it surfaces as it is.
        """
        space = part.space
        ndev = self.ndev
        total_windows = sched.total_windows
        # never pad past the longest shard's queue: a schedule whose
        # every shard has s windows fills at most s rows per batch
        cap = (max(1, min(self.max_windows_per_dispatch,
                          max(sched.shard_steps, default=0)))
               if emit == "device" else 1)
        self.stats = self._stats(
            orient=space.orient,
            streamed=max_items is not None, max_items=max_items,
            chunks=0, chunk_shape=sched.chunk_shape, items=0,
            # the schedule-wide lane footprint (all devices), comparable
            # with the lock-step record
            peak_plan_bytes=ITEM_BYTES * sched.chunk_shape * ndev,
            emit=emit,
            desc_shape=sched.desc_shape if emit == "device" else 0,
            plan_upload_bytes=upload, partitioned=True,
            partition_shape=getattr(part, "mesh_shape", None),
            shard_items=list(part.stats.shard_items),
            graph_resident_bytes=part.stats.max_shard_bytes,
            graph_replicated_bytes=part.stats.replicated_bytes,
            schedule="async", shard_steps=[0] * ndev,
            pipeline_depth=self.pipeline_depth,
            dispatch_batch_limit=cap)
        base_asym, base_mut = global_bases(space)
        if total_windows == 0:
            return assemble_counts(space.n, base_asym, base_mut,
                                   np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        st = self.stats
        injector = (self.faults.injector()
                    if self.faults is not None else None)
        journal = None
        done = None
        if checkpoint is not None:
            fp = _CheckpointJournal.graph_fingerprint(
                space, emit=emit, ndev=ndev, max_items=max_items)
            journal = _CheckpointJournal(checkpoint, fp, ndev)
            done = journal.done
        lanes = self.devices
        # the host copies in ``arrs`` stay alive as the source of a
        # failover onto another physical device
        cs = sched.chunk_shape
        with span(GRAPH):
            arrs = stacked_device_arrays(part.shards)
            graphs = {(s, lanes[s].device): g
                      for s, g in enumerate(self._shard_graphs(arrs))}
            if emit == "device":
                idx = self._flat_index(lanes, cs)
        batcher = None
        if emit == "device":
            step = desc_batch_partials_fn(self.backend, space.search_iters,
                                          sched.desc_iters, space.orient,
                                          space.prune_self)
            words_len = 1 + 3 * sched.desc_shape + sched.num_anchors
            batcher = WindowBatcher(cap, words_len)
            shape, rows = (cap, words_len), cap
            # remaining window ids per shard in yield order: the consumer
            # recovers each pulled window's id (FIFO queues keep producer
            # order) for the checkpoint journal
            order = [[k for k in range(sched.steps_for(s))
                      if done is None or k not in done[s]]
                     for s in range(ndev)]
            live = [s for s in range(ndev) if order[s]]

            def launcher(graph, device):
                ix = idx[device]
                return lambda words, real: step(*graph, words, ix,
                                                real=real)

            def make_source(s, skip=0):
                def gen():
                    for j, k in enumerate(order[s]):
                        if j < skip:
                            continue
                        if injector is not None:
                            injector.fire("producer", shard=s)
                        yield sched.descriptors(s, k).device_words()
                return gen()
        else:
            step = partials_fn(self.backend, space.search_iters)
            shape, rows = (2 * cs,), 1
            order = None
            live = [s for s in range(ndev) if sched.steps_for(s) > 0]

            def launcher(graph, device):
                return _item_launcher(step, graph, cs)

            def make_source(s, skip=0):
                def gen():
                    emitted = 0
                    for k in range(sched.steps_for(s)):
                        if done is not None and k in done[s]:
                            continue
                        sp, pv, num = sched.shard_step_items(s, k)
                        if num == 0:
                            # fully-pruned window: zero contribution by
                            # construction — never dispatched
                            continue
                        emitted += 1
                        if emitted <= skip:
                            continue
                        if injector is not None:
                            injector.fire("producer", shard=s)
                        yield k, np.concatenate([sp, pv]), num
                return gen()

        limit = 2 * ndev
        #: shard -> logical device serving it (failover re-routes)
        home = list(range(ndev))
        retired: set = set()
        #: (shard, logical device) -> (pipeline, launch)
        routes: dict = {}

        def route(s: int):
            """Shard ``s``'s pipeline and launch on the logical device
            now serving it, made at its first use there."""
            d = home[s]
            if (s, d) not in routes:
                ld = lanes[d]
                key = (s, ld.device)
                if key not in graphs:
                    with span(GRAPH):
                        graphs[key] = self._upload_graph(
                            [a[s] for a in arrs], ld.device)
                        _after_uploads([ld])
                routes[(s, d)] = (
                    _Pipeline(ld.device, shape, stream=ld.stream,
                              rows=rows, ring=limit + 2),
                    launcher(graphs[key], ld.device))
            return routes[(s, d)]

        hist_acc = np.zeros(64, np.int64)
        inter_acc = np.zeros(2, np.int64)
        chunk_items: list[int] = []
        if journal is not None and journal.windows:
            np.add(hist_acc, journal.hist, out=hist_acc)
            np.add(inter_acc, journal.inter, out=inter_acc)
            chunk_items.extend(journal.chunk_items)
            st.resumed_windows = journal.windows
        shard_steps = [0] * ndev
        pos = [0] * ndev
        dispatches = win_max = pad_windows = 0
        landed = [st.resumed_windows]

        def retire(d_id: int, cause) -> None:
            """Fail logical device ``d_id`` over to the survivors: every
            shard it served moves to a surviving device, whose stream
            takes the rest of its queue.  The merge is untouched, so the
            census stays bit-identical."""
            if d_id in retired:
                return
            retired.add(d_id)
            survivors = [x for x in range(ndev) if x not in retired]
            if not survivors:
                raise FaultError(
                    "every device has been retired; cannot complete "
                    "the census") from cause
            st.failovers += 1
            st.retired_devices.append(d_id)
            for s2 in range(ndev):
                if home[s2] == d_id:
                    home[s2] = survivors[s2 % len(survivors)]

        def do_dispatch(s: int, window):
            """One dispatch attempt of ``window`` on the device serving
            shard ``s``; returns ((pipeline, ticket), poisoned)."""
            d_id = home[s]
            pipe, launch = route(s)
            fire = (None if injector is None else
                    lambda site: injector.fire(site, shard=s, device=d_id))
            if emit == "device":
                # a megabatch: upload and launch its real rows only
                ticket = pipe.submit(window[0], launch, fire,
                                     real=window[1])
            else:
                ticket = pipe.submit(window[1], launch, fire)
            poisoned = (injector.take_poison()
                        if injector is not None else False)
            return (pipe, ticket), poisoned

        def dispatch_retrying(s: int, window, attempts: int = 0):
            """Dispatch with the retry/failover discipline: a transient
            fault backs off and retries on the same device up to
            ``max_retries``; a dead device (persistent fault) or an
            exhausted budget retires the device and re-routes."""
            while True:
                d_id = home[s]
                try:
                    fut, poisoned = do_dispatch(s, window)
                    return fut, poisoned, attempts
                except FaultError as exc:
                    dead = ((injector is not None
                             and injector.device_is_dead(d_id))
                            or getattr(getattr(exc, "fault", None),
                                       "persistent", False))
                    if dead:
                        retire(d_id, exc)
                        attempts = 0
                        continue
                    attempts += 1
                    st.retries += 1
                    if attempts > self.max_retries:
                        # budget exhausted: treat the device as failed
                        # and drain its queue on the survivors
                        retire(d_id, exc)
                        attempts = 0
                        continue
                    time.sleep(self.retry_backoff * 2 ** (attempts - 1))

        def land(job) -> None:
            s, window, ids, fut, x, attempts, poisoned = job
            while True:
                try:
                    pipe, ticket = fut
                    hist, inter = pipe.land(ticket)
                    if poisoned:
                        hist, inter = poison_result(hist, inter)
                    # megastep: per-window int32 partials stacked
                    # (cap, ·); summing the first x rows in int64 is
                    # landing x windows (host emission: x items, 1 row)
                    real = x if emit == "device" else 1
                    _validate_partials(hist[:real], inter[:real])
                    hsum = hist[:real].sum(axis=0)
                    isum = inter[:real, :2].sum(axis=0)
                    nums = ([int(inter[i, 2]) for i in range(x)]
                            if emit == "device" else [x])
                    break
                except FaultError as exc:
                    # validation failure: re-dispatch the SAME window
                    # (same-device retry, then failover) — the merge is
                    # order-invariant, so the late landing is identical
                    attempts += 1
                    st.retries += 1
                    if attempts > self.max_retries:
                        retire(home[s], exc)
                        attempts = 0
                    else:
                        time.sleep(self.retry_backoff
                                   * 2 ** (attempts - 1))
                    fut, poisoned, attempts = dispatch_retrying(
                        s, window, attempts)
            np.add(hist_acc, hsum, out=hist_acc)
            np.add(inter_acc, isum, out=inter_acc)
            if journal is not None:
                journal.record(s, ids, hsum, isum, nums)
            for num in nums:
                chunk_items.append(num)
                if progress is not None:
                    progress(landed[0], total_windows, num)
                landed[0] += 1

        def restart(slot: int, skip: int):
            return make_source(live[slot], skip)

        pipeline = ShardStreamPipeline(
            [make_source(s) for s in live], depth=self.pipeline_depth,
            batch=batcher, restart=restart,
            watchdog=self.watchdog_timeout,
            max_retries=self.max_retries, backoff=self.retry_backoff)
        pending: deque = deque()
        try:
            with pipeline:
                for slot, window in pipeline:
                    s = live[slot]
                    if emit == "device":
                        x = window[1]
                        ids = order[s][pos[s]:pos[s] + x]
                        pos[s] += x
                        shard_steps[s] += x
                        win_max = max(win_max, x)
                        pad_windows += cap - x
                    else:
                        wid, _words, x = window
                        ids = [wid]
                        shard_steps[s] += 1
                        win_max = max(win_max, 1)
                    fut, poisoned, attempts = dispatch_retrying(s, window)
                    dispatches += 1
                    pending.append(
                        (s, window, ids, fut, x, attempts, poisoned))
                    if len(pending) > limit:
                        land(pending.popleft())
                while pending:
                    land(pending.popleft())
        finally:
            if journal is not None:
                journal.close()

        st.chunk_items = chunk_items
        st.chunks = len(chunk_items)
        st.items = int(sum(chunk_items))
        st.shard_steps = shard_steps
        st.stall_steps = pipeline.stalls
        st.retries += pipeline.producer_retries
        st.watchdog_fires = pipeline.watchdog_fires
        st.dispatches_total = dispatches
        st.windows_per_dispatch_max = win_max
        st.windows_per_dispatch_mean = (
            sum(shard_steps) / dispatches if dispatches else 0.0)
        st.plan_upload_bytes_total = upload * sum(shard_steps)
        st.plan_pad_bytes_total = upload * pad_windows
        st.monolithic_plan_bytes = ITEM_BYTES * (-(-st.items // ndev) * ndev)
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)


def _after_uploads(lanes) -> None:
    """Order every lane's own stream after the work queued so far on its
    device's current stream (the uploads its kernels read)."""
    for ld in lanes:
        if ld.stream is not None:
            ld.stream.wait_stream(torch.cuda.current_stream(ld.device))


def _pad_i32(a: np.ndarray, cap: int) -> np.ndarray:
    """Zero-pad an integer array to a fixed capacity, as int32."""
    out = np.zeros(cap, dtype=np.int32)
    out[:a.shape[0]] = a
    return out


def _dispatch_retrying_session(session, thunk):
    """Session-side dispatch retry: call ``thunk`` (upload + launch, with
    the session's fault-injection hooks inside) under the engine's retry
    budget with exponential backoff.  Sessions retry on the same device
    only — failover is an engine-run discipline — so a persistent fault
    surfaces to the caller once the budget is spent.  Only a
    :class:`FaultError` is retried."""
    engine = session.engine
    attempts = 0
    while True:
        try:
            return thunk()
        except FaultError:
            if attempts >= engine.max_retries:
                raise
            attempts += 1
            session.retries += 1
            time.sleep(engine.retry_backoff * 2 ** (attempts - 1))


def _land_retrying_session(session, fetch, ticket, poisoned, redo):
    """Session-side landing: ``fetch(ticket) -> (hist64, inter)`` int64,
    poison, validate, and on a validation failure re-dispatch the same
    window through ``redo() -> (ticket, poisoned)``, up to the engine's
    retry budget.  Returns the validated partials — the caller
    accumulates them, so nothing is ever counted twice."""
    engine = session.engine
    attempts = 0
    while True:
        hist, inter = fetch(ticket)
        if poisoned:
            hist, inter = poison_result(hist, inter)
        try:
            _validate_partials(hist, inter)
            return hist, inter
        except FaultError:
            if redo is None or attempts >= engine.max_retries:
                raise
            attempts += 1
            session.retries += 1
            time.sleep(engine.retry_backoff * 2 ** (attempts - 1))
            ticket, poisoned = redo()


def _sorted_union(keys: np.ndarray, extra: np.ndarray) -> np.ndarray:
    """``np.union1d(keys, extra)`` for a sorted, duplicate-free ``keys``
    and a short ``extra``: the new keys are inserted in place (one pass
    over ``keys``) instead of sorting or hashing their concatenation."""
    extra = np.unique(extra).astype(keys.dtype)
    at = np.searchsorted(keys, extra)
    fresh = at == keys.shape[0]
    fresh[~fresh] = keys[at[~fresh]] != extra[~fresh]
    return np.insert(keys, at[fresh], extra[fresh])


def _session_graph_crc(g: CompactDigraph) -> int:
    return int(zlib.crc32(np.ascontiguousarray(g.packed).tobytes()))


def _save_session_checkpoint(session, path: str) -> None:
    """Persist a session's running census + graph fingerprint (the JAX
    package's format) so a new session over the same graph can continue
    warm updates without recomputing the baseline (every session kind
    shares this format)."""
    if session._census is None:
        raise RuntimeError(
            "no census to checkpoint: call census() first")
    with open(path, "w") as f:
        json.dump({
            "v": 1, "kind": "session", "n": int(session.n),
            "orient": session.orient,
            "prune_self": bool(session.prune_self),
            "packed_crc": _session_graph_crc(session._g),
            "census": [int(x) for x in session._census]}, f)
        f.write("\n")


def _load_session_checkpoint(session, path: str) -> np.ndarray:
    """Restore a running census saved by :func:`_save_session_checkpoint`
    into a session whose RESIDENT graph matches the checkpoint's
    fingerprint; :meth:`update` then continues exactly where the saved
    session left off."""
    with open(path) as f:
        rec = json.load(f)
    want = {"v": 1, "kind": "session", "n": int(session.n),
            "orient": session.orient,
            "prune_self": bool(session.prune_self),
            "packed_crc": _session_graph_crc(session._g)}
    got = {k: rec.get(k) for k in want}
    if got != want:
        raise FaultError(
            f"session checkpoint {path!r} does not match the resident "
            f"graph/session ({got} != {want})")
    session._census = np.asarray(rec["census"], dtype=np.int64)
    return session._census.copy()


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
    package's session.

    On an engine with several logical devices (replicated, not
    partitioned) every physical device holds the graph once, the chunk
    shape is a multiple of the device count, and each dispatch's lanes
    are split into one contiguous slice per device: the descriptor window
    goes whole to every device, the packed items are split.  The
    devices' partials of a dispatch are summed on the host.

    Every dispatch fires the engine's fault injector (``upload`` before
    the copy, ``dispatch`` before the launch, as shard 0 on device 0) and
    is retried on the same devices up to the engine's ``max_retries``;
    landed partials are validated (:attr:`retries` counts the
    re-attempts).  :meth:`save_checkpoint` / :meth:`load_checkpoint`
    carry the running census to a new session over the same graph.
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
        self._lanes = engine._lanes()
        self.ndev = len(self._lanes)
        self.orient = orient
        self.prune_self = prune_self
        self.emit = emit
        self.n = g.n
        self.max_items = max_items
        #: keep a persistent :class:`PairSpaceIndex` and edit it per
        #: update instead of rebuilding the O(P) pair space
        self.use_index = bool(index)
        self._pair_index: PairSpaceIndex | None = None
        #: host seconds by span name since the last stats
        #: (:mod:`repro_torch.core.spans`)
        self._spans: dict = {}
        #: pinned row-search depth: any row has < n entries
        self.search_iters = max(1, int(np.ceil(np.log2(max(g.n, 2)))))
        self._cap_entries = 0
        self._cap_pairs = 0
        #: resident graph buffers, one set per physical device
        self._dev: dict = {}
        self.chunk_shape: int | None = None
        self.desc_shape: int | None = None
        self._census: np.ndarray | None = None
        self.last_delta: GraphDelta | None = None
        self.stats: EngineStats | None = None
        #: injected-fault runtime shared across this session's dispatches
        #: (occurrence counters persist across census()/update() calls)
        self._injector = (engine.faults.injector()
                          if engine.faults is not None else None)
        #: dispatches re-attempted after a fault, across the session's life
        self.retries = 0
        self._closed = False
        self._install(g)
        cs = self.chunk_shape
        if self.emit == "device":
            space = self._space
            self.desc_shape = _desc_capacity(
                cs, max_pairs_per_window(space.offsets, cs))
            self.desc_iters = DESC_SEARCH_ITERS
            self.num_anchors = num_desc_anchors(cs)
            self._idx = engine._flat_index(self._lanes, cs)
            self._step = desc_partials_fn(
                engine.backend, self.search_iters, self.desc_iters,
                orient, prune_self)
            self._anchors = desc_anchors_fn(engine.backend)
            words = 1 + 3 * self.desc_shape
        else:
            self._step = partials_fn(engine.backend, self.search_iters)
            words = 2 * (cs // self.ndev)
        self._pipes = [_Pipeline(ld.device, (words,), stream=ld.stream)
                       for ld in self._lanes]
        self._launches = [self._lane_launch(d)
                          for d in range(self.ndev)]

    def _lane_launch(self, d: int):
        """``launch(words)`` of logical device ``d``: its slice of the
        dispatch's lanes against the resident buffers as they are at
        launch time (a capacity growth reallocates them); under device
        emission each window's anchor table is built into the lane's own
        (:func:`_anchored`)."""
        device = self._lanes[d].device
        per = self.chunk_shape // self.ndev
        if self.emit == "device":
            table = torch.empty(self.num_anchors, dtype=torch.int32,
                                device=device)

            def launch(words):
                return self._step(*self._dev[device],
                                  *_anchored(words, table, self._anchors),
                                  self._idx[device][d * per:(d + 1) * per])
        else:
            def launch(words):
                return self._step(*self._dev[device], words[:per],
                                  words[per:])
        return launch

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release the resident device buffers.  Idempotent; the session
        is unusable afterwards."""
        self._dev = {}
        self._idx = None
        self._pipes = None
        self._launches = None
        self._closed = True

    def __enter__(self) -> "EngineSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("session is closed")

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str) -> None:
        """Persist the running census + graph fingerprint (JSON) so a new
        session over the same graph resumes warm updates via
        :meth:`load_checkpoint` without recomputing the baseline."""
        _save_session_checkpoint(self, path)

    def load_checkpoint(self, path: str) -> np.ndarray:
        """Adopt a census saved by :meth:`save_checkpoint`; the resident
        graph must match the checkpoint's fingerprint.  Returns the
        restored census; later :meth:`update` calls continue from it."""
        return _load_session_checkpoint(self, path)

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
            with span(PAIR, self._spans):
                if self.use_index:
                    self._pair_index = PairSpaceIndex(
                        g, orient=self.orient, prune_self=self.prune_self)
                    space = self._pair_index.space
                else:
                    space = pair_space(g, orient=self.orient,
                                       prune_self=self.prune_self)
        self._space = space
        self._full_items: int | None = None   # lazy per-install stat
        if self.chunk_shape is None:
            budget = (self.max_items if self.max_items is not None
                      else max(space.num_items_preprune, 1))
            self.chunk_shape = _guard_chunk_shape(
                -(-max(int(budget), 1) // self.ndev) * self.ndev)
        with span(INSTALL, self._spans):
            cap_entries = self._grown(self._cap_entries,
                                      space.packed.shape[0])
            cap_pairs = self._grown(self._cap_pairs, space.num_pairs)
            if not self._dev or (cap_entries, cap_pairs) != (
                    self._cap_entries, self._cap_pairs):
                self._cap_entries, self._cap_pairs = cap_entries, cap_pairs
                self._dev = {}
                for ld in self._lanes:
                    if ld.device not in self._dev:
                        self._dev[ld.device] = tuple(
                            torch.zeros(size, dtype=torch.int32,
                                        device=ld.device)
                            for size in (self.n + 1, cap_entries,
                                         cap_pairs, cap_pairs, cap_pairs))
            host = (space.indptr.astype(np.int32),
                    _pad_i32(space.packed, cap_entries),
                    _pad_i32(space.pair_u, cap_pairs),
                    _pad_i32(space.pair_v, cap_pairs),
                    _pad_i32(space.pair_code, cap_pairs))
            for bufs in self._dev.values():
                for dev, arr in zip(bufs, host):
                    dev.copy_(torch.from_numpy(arr))
            _after_uploads(self._lanes)

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
        items) against the resident device graph, each device its
        contiguous slice of the packed items; empty batches are skipped
        without a dispatch.  Drawing a batch and packing it is the
        ``census.session.emit`` span.  Returns int64 partials and the
        items per dispatch."""
        cs = self.chunk_shape
        per = cs // self.ndev
        chunk_items: list[int] = []

        def steps():
            for item_pair, item_slot, item_side in batches:
                if item_pair.shape[0]:
                    chunk_items.append(int(item_pair.shape[0]))
                    sp, pv = pad_and_pack(item_pair, item_slot, item_side,
                                          cs)
                    yield [np.concatenate([sp[d * per:(d + 1) * per],
                                           pv[d * per:(d + 1) * per]])
                           for d in range(self.ndev)]

        hist, inter = _dispatch(self._pipes, self._launches,
                                spanned(steps(), EMIT, self._spans),
                                session=self)
        return hist, inter, chunk_items

    def _run_desc_batches(self, windows
                          ) -> tuple[np.ndarray, np.ndarray, list[int]]:
        """Device-emission twin of :meth:`_run_batches`: dispatch
        descriptor windows (whole, to every device) against the resident
        graph and flat-index arrays.  Valid-item counts come back from
        the device (``inter`` lane 2), so the stats match host emission
        without materializing a single item.  Building a window and its
        words is the ``census.session.emit`` span."""
        chunk_items: list[int] = []
        hist, inter = _dispatch(
            self._pipes, self._launches,
            spanned(([win.device_words()] * self.ndev
                     for win in windows if win.num_preprune),
                    EMIT, self._spans),
            lambda k, inter3: chunk_items.append(int(inter3[2])),
            session=self)
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
            hist, inter, chunk_items = self._run_desc_batches(
                subset_descriptor_windows(self._space, ids,
                                          self.chunk_shape,
                                          self.desc_shape, 0))
            return (contribution_counts(base_asym, base_mut, hist, inter),
                    int(sum(chunk_items)), chunk_items)
        with span(EMIT, self._spans):
            items = emit_items_for_pairs(self._space, pair_ids)
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
        ndev = self.ndev
        gbytes = replicated_graph_bytes(self._space)
        self.stats = EngineStats(
            backend=self.engine.backend, ndev=ndev, orient=self.orient,
            streamed=True, max_items=self.max_items,
            chunks=len(chunk_items), chunk_shape=self.chunk_shape,
            items=items, chunk_items=chunk_items,
            peak_plan_bytes=ITEM_BYTES * self.chunk_shape,
            monolithic_plan_bytes=ITEM_BYTES
            * (-(-full_items // ndev) * ndev),
            full_items=full_items, affected_pairs=affected_pairs,
            emit=self.emit, desc_shape=self.desc_shape or 0,
            # per-device plan bytes: descriptor windows go whole to every
            # device, packed items are split across them
            plan_upload_bytes=(
                DESC_BYTES * self.desc_shape + 4 * self.num_anchors + 4
                if self.emit == "device"
                else ITEM_BYTES * self.chunk_shape // ndev),
            retries=self.retries,
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes,
            plan_upload_bytes_total=_uploaded(self._pipes),
            **_host_seconds(self._spans), indexed=self.use_index)
        self._spans = {}
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
            hist, inter, chunk_items = self._run_desc_batches(
                iter_descriptor_windows(space.offsets, cs,
                                        self.desc_shape, 0))
        else:
            hist, inter, chunk_items = self._run_batches(
                emit_items(space, lo, min(lo + cs, w0))
                for lo in range(0, w0, cs))
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
        with span(MERGE, self._spans):
            g_new, delta = apply_delta(self._g, add_src, add_dst,
                                       del_src, del_dst)
        self.last_delta = delta
        if delta.num_changed == 0:
            # nothing changed: no recount, no upload, no dispatch — the
            # running census is already the answer
            self._set_stats([], 0, self._postprune_items(), 0)
            return self._census.copy()

        with span(PAIR, self._spans):
            aff_old = (self._pair_index.affected_pair_ids(delta.touched)
                       if self.use_index
                       else affected_pair_ids(self._space, delta.touched))
        # lands every window of the old graph before the install below
        # overwrites the resident buffers
        contrib_old, items_old, chunks_old = self._subset(aff_old)
        if self.use_index:
            # edit the persistent index into the new graph's pair space
            # (O(delta · log P + affected)) instead of rebuilding O(P)
            with span(PAIR, self._spans):
                space_new = self._pair_index.apply(delta, g_new)
            self._install(g_new, space=space_new)
        else:
            self._install(g_new)
        with span(PAIR, self._spans):
            aff_new = (self._pair_index.affected_pair_ids(delta.touched)
                       if self.use_index
                       else affected_pair_ids(self._space, delta.touched))
        contrib_new, items_new, chunks_new = self._subset(aff_new)
        self._census = combine(self._census, contrib_old, contrib_new,
                               self.n)
        self._set_stats(chunks_old + chunks_new, items_old + items_new,
                        self._postprune_items(),
                        int(aff_old.shape[0] + aff_new.shape[0]))
        return self._census.copy()


class PartitionedEngineSession:
    """Partition-resident census session: each shard lives on its logical
    device, delta updates dispatch only the shards owning touched pairs.

    On open the graph's pair space is LPT-split into one private shard
    per logical device (:mod:`repro_torch.core.partition`); each shard's
    relabeled local CSR + pair arrays are written into fixed-capacity
    buffers on THAT device (capacities are common across shards and grown
    geometrically; the plain versions' row-search depth is pinned to
    ``ceil(log2 n)`` exactly like :class:`EngineSession`).  Each shard
    dispatches on its device's stream through its own pipeline, with at
    most ``2 * ndev`` dispatches in flight; partials are merged on the
    host in int64 (the paper's private census vectors, merged once).

    :meth:`update` applies an edge delta and routes the recount by
    ownership: the *affected pairs* (endpoint row changed) are looked up
    in each shard's sorted key set, only the owning shards re-count their
    slices (old contribution against the still-resident arrays, then new
    contribution after only those shards re-extract + re-upload), and
    **untouched shards dispatch nothing** — no descriptor/item upload, no
    device work, their resident subgraphs unchanged.  Pairs that appear
    in the delta join a shard already owning one of their endpoints'
    pairs while it is below 1.25x the mean load, else the lightest shard.
    Bit-identical to a from-scratch census of the edited graph on every
    backend, orient and emit mode.

    :meth:`rebalance` re-shards with a fresh LPT over the CURRENT pair
    space (every shard re-extracted + re-uploaded; the running census
    stays valid — counts never depend on ownership);
    ``auto_rebalance_threshold`` triggers it at the end of any
    :meth:`update` that leaves ``load_max_over_mean`` above the threshold
    (``rebalances`` counts the triggers).

    Dispatches fire the engine's fault injector (shard ``s`` on device
    ``s``) and retry on the same device, as :class:`EngineSession`'s do.
    """

    def __init__(self, engine: CensusEngine, g: CompactDigraph, *,
                 orient: str = "none", prune_self: bool = True,
                 max_items: int | None = None, emit: str | None = None,
                 auto_rebalance_threshold: float | None = None,
                 index: bool = True):
        if max_items is not None and max_items < 1:
            raise ValueError(f"max_items must be >= 1, got {max_items}")
        if auto_rebalance_threshold is not None \
                and auto_rebalance_threshold < 1.0:
            raise ValueError(
                "auto_rebalance_threshold must be >= 1.0, got "
                f"{auto_rebalance_threshold}")
        emit = engine.emit if emit is None else emit
        if emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        self.auto_rebalance_threshold = (
            None if auto_rebalance_threshold is None
            else float(auto_rebalance_threshold))
        self.rebalances = 0
        self.engine = engine
        self.orient = orient
        self.prune_self = prune_self
        self.emit = emit
        self.n = g.n
        self.max_items = max_items
        self.ndev = engine.ndev
        self._lanes = engine._lanes()
        #: pinned row-search depth (see :class:`EngineSession`)
        self.search_iters = max(1, int(np.ceil(np.log2(max(g.n, 2)))))
        self._cap_n = self._cap_entries = self._cap_pairs = 0
        self.chunk_shape: int | None = None
        self.desc_shape: int | None = None
        self._census: np.ndarray | None = None
        self.last_delta: GraphDelta | None = None
        self.stats: EngineStats | None = None
        #: injected-fault runtime shared across this session's dispatches
        self._injector = (engine.faults.injector()
                          if engine.faults is not None else None)
        #: dispatches re-attempted after a fault, across the session's life
        self.retries = 0
        self._closed = False
        #: delta-incremental host planning (see :class:`EngineSession`)
        self.use_index = bool(index)
        self._pair_index: PairSpaceIndex | None = None
        #: host seconds by span name since the last stats
        self._spans: dict = {}
        self._dev: list = [None] * self.ndev
        self._pipes = None
        self._install_full(g)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Release every shard's resident device buffers.  Idempotent;
        the session is unusable afterwards."""
        self._dev = [None] * self.ndev
        self._idx = None
        self._pipes = None
        self._tables = None
        self._closed = True

    def __enter__(self) -> "PartitionedEngineSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("session is closed")

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str) -> None:
        """Persist the running census + graph fingerprint (JSON); a new
        session over the same graph warm-resumes updates via
        :meth:`load_checkpoint`.  The census never depends on the
        partition, so the restoring session may shard however it
        likes."""
        _save_session_checkpoint(self, path)

    def load_checkpoint(self, path: str) -> np.ndarray:
        """Adopt a census saved by :meth:`save_checkpoint` (the resident
        graph must match its fingerprint); :meth:`update` continues from
        it."""
        return _load_session_checkpoint(self, path)

    # ------------------------------------------------------------ state
    @property
    def graph(self) -> CompactDigraph:
        return self._g

    @property
    def space(self) -> PairSpace:
        """The GLOBAL pair space of the resident graph."""
        return self._space

    @property
    def shards(self):
        return list(self._shards)

    @property
    def counts(self) -> np.ndarray | None:
        return None if self._census is None else self._census.copy()

    def _install_full(self, g: CompactDigraph) -> None:
        """(Re)partition ``g`` from scratch and make every shard
        device-resident (session open and :meth:`set_graph`)."""
        self._g = g
        with span(PAIR, self._spans):
            if self.use_index:
                self._pair_index = PairSpaceIndex(
                    g, orient=self.orient, prune_self=self.prune_self)
                space = self._pair_index.space
            else:
                space = pair_space(g, orient=self.orient,
                                   prune_self=self.prune_self)
        self._space = space
        self._full_items: int | None = None
        part = self._make_partition(space)
        self._shards = list(part.shards)
        self._keys = [sh.keys for sh in self._shards]
        self._set_ownership(part)
        if self.chunk_shape is None:
            budget = (self.max_items if self.max_items is not None
                      else max(space.num_items_preprune, 1))
            self.chunk_shape = _guard_chunk_shape(
                -(-max(int(budget), 1) // self.ndev))
        cs = self.chunk_shape
        if self._pipes is None:
            if self.emit == "device":
                self.desc_shape = _desc_capacity(
                    cs, max(max_pairs_per_window(sh.space.offsets, cs)
                            for sh in self._shards))
                self.desc_iters = DESC_SEARCH_ITERS
                self.num_anchors = num_desc_anchors(cs)
                self._idx = self.engine._flat_index(self._lanes, cs)
                self._step = desc_partials_fn(
                    self.engine.backend, self.search_iters,
                    self.desc_iters, self.orient, self.prune_self)
                self._anchors = desc_anchors_fn(self.engine.backend)
                # one anchor table per shard's compute stream
                self._tables = [torch.empty(self.num_anchors,
                                            dtype=torch.int32,
                                            device=ld.device)
                                for ld in self._lanes]
                words = 1 + 3 * self.desc_shape
            else:
                self._step = partials_fn(self.engine.backend,
                                         self.search_iters)
                words = 2 * cs
            self._pipes = [_Pipeline(ld.device, (words,), stream=ld.stream,
                                     ring=2 * self.ndev + 2)
                           for ld in self._lanes]
        self._upload_shards(range(self.ndev))

    # ----------------------------------------------- ownership hooks
    # The 2D session (:class:`PartitionedEngineSession2D`) overrides
    # these four: there a device holds a TILE (pair shard × vertex
    # slice) while ownership/load bookkeeping stays per pair shard.
    def _make_partition(self, space):
        """Partition ``space`` into the device-resident shard list."""
        return partition_graph(num_shards=self.ndev, space=space)

    def _set_ownership(self, part) -> None:
        """Record ownership/load bookkeeping from a fresh partition."""
        self._load = [sh.items for sh in self._shards]

    def _tile_shard(self, s: int) -> int:
        """Device/tile index → owning pair shard (identity in 1D)."""
        return s

    def _ownership(self) -> list:
        """Per pair shard sorted global key arrays (the reassignment
        target of :meth:`update`); the per-device dispatch key sets in
        1D, the per-shard sets distinct from ``_keys`` in 2D."""
        return self._keys

    def _upload_shards(self, shard_ids) -> None:
        """Write the listed shards' padded local arrays into their
        devices' resident buffers; a capacity growth reallocates every
        shard's buffers, so it rewrites them all.  Each written device's
        stream is ordered after the writes.  The ``census.session.install``
        span."""
        with span(INSTALL, self._spans):
            need_n = max(max(sh.graph.indptr.shape[0]
                             for sh in self._shards), 2)
            need_e = max(max(sh.graph.packed.shape[0]
                             for sh in self._shards), 1)
            need_p = max(max(sh.num_pairs for sh in self._shards), 1)
            prev = (self._cap_n, self._cap_entries, self._cap_pairs)
            self._cap_n = EngineSession._grown(self._cap_n, need_n)
            self._cap_entries = EngineSession._grown(self._cap_entries,
                                                     need_e)
            self._cap_pairs = EngineSession._grown(self._cap_pairs, need_p)
            caps = (self._cap_n, self._cap_entries, self._cap_pairs)
            if prev != caps:
                shard_ids = range(self.ndev)
                for s, ld in enumerate(self._lanes):
                    self._dev[s] = tuple(
                        torch.zeros(size, dtype=torch.int32,
                                    device=ld.device)
                        for size in (self._cap_n, self._cap_entries,
                                     self._cap_pairs, self._cap_pairs,
                                     self._cap_pairs))
            shard_ids = list(shard_ids)
            for s in shard_ids:
                sh = self._shards[s]
                ip = np.zeros(self._cap_n, dtype=np.int32)
                ln = sh.graph.indptr.shape[0]
                ip[:ln] = sh.graph.indptr
                ip[ln:] = sh.graph.indptr[-1]      # phantom empty rows
                host = (ip, _pad_i32(sh.graph.packed, self._cap_entries),
                        _pad_i32(sh.space.pair_u, self._cap_pairs),
                        _pad_i32(sh.space.pair_v, self._cap_pairs),
                        _pad_i32(sh.space.pair_code, self._cap_pairs))
                for dev, arr in zip(self._dev[s], host):
                    dev.copy_(torch.from_numpy(arr))
            _after_uploads([self._lanes[s] for s in shard_ids])

    def set_graph(self, g: CompactDigraph) -> None:
        """Replace the resident graph wholesale: fresh LPT partition,
        every shard re-extracted + re-uploaded.  Invalidates the running
        census until :meth:`census` recomputes."""
        self._check_open()
        if g.n != self.n:
            raise ValueError(f"session is pinned to n={self.n}, got {g.n}")
        self._install_full(g)
        self._census = None
        self.last_delta = None

    @property
    def load_max_over_mean(self) -> float:
        """Current shard load imbalance (post-prune items; 1.0 ==
        perfectly balanced) — the quantity ``auto_rebalance_threshold``
        is compared against after every update."""
        total = sum(self._load)
        if not total:
            return 1.0
        return max(self._load) / (total / len(self._load))

    def rebalance(self) -> None:
        """Re-shard the CURRENT resident graph with a fresh LPT: every
        shard re-extracts + re-uploads, restoring ≈LPT balance after
        churn has drifted the locality-routed loads.  The running census
        and the pair space are untouched."""
        self._check_open()
        part = self._make_partition(self._space)
        self._shards = list(part.shards)
        self._keys = [sh.keys for sh in self._shards]
        self._set_ownership(part)
        self._upload_shards(range(self.ndev))
        self.rebalances += 1

    def _maybe_rebalance(self) -> None:
        if self.auto_rebalance_threshold is not None and \
                self.load_max_over_mean > self.auto_rebalance_threshold:
            self.rebalance()

    # ---------------------------------------------------------- running
    def _launch(self, s: int, words):
        """Launch one window of shard ``s`` against its resident buffers
        as they are now (a capacity growth reallocates them), its anchor
        table built into the shard's own (:func:`_anchored`)."""
        if self.emit == "device":
            return self._step(*self._dev[s],
                              *_anchored(words, self._tables[s],
                                         self._anchors),
                              self._idx[self._lanes[s].device])
        cs = self.chunk_shape
        return self._step(*self._dev[s], words[:cs], words[cs:])

    def _dispatch(self, s: int, words):
        """One window's words onto shard ``s``'s device and its launch
        there, the session's fault hooks fired before the copy and
        before the launch; returns ``(ticket, poisoned)``."""
        inj = self._injector
        fire = (None if inj is None else
                lambda site: inj.fire(site, shard=s, device=s))
        ticket = self._pipes[s].submit(
            words, lambda w: self._launch(s, w), fire)
        return ticket, (inj.take_poison() if inj is not None else False)

    def _shard_jobs(self, s: int, pair_ids=None):
        """Yield shard ``s``'s dispatch jobs: its full stream
        (``pair_ids=None``) or a local pair subset.  Each job is
        ``(ticket, poisoned, redo, num_or_None)`` — ``redo`` re-dispatches
        the same window (the landing-side retry handle), ``num`` is the
        item count under host emission and ``None`` under device emission
        (counts come back from the device).  Dispatch-time faults are
        retried here under the engine's budget.  Building a window or a
        batch and its words is the ``census.session.emit`` span."""
        sp = self._shards[s].space
        cs = self.chunk_shape
        if self.emit == "device":
            wins = (iter_descriptor_windows(sp.offsets, cs,
                                            self.desc_shape, 0)
                    if pair_ids is None else
                    subset_descriptor_windows(sp, pair_ids, cs,
                                              self.desc_shape, 0))
            stream = ((None, win.device_words())
                      for win in wins if win.num_preprune)
        else:
            if pair_ids is None:
                w0 = sp.num_items_preprune
                batches = (emit_items(sp, lo, min(lo + cs, w0))
                           for lo in range(0, w0, cs))
            else:
                with span(EMIT, self._spans):
                    items = emit_items_for_pairs(sp, pair_ids)
                batches = (
                    (items[0][lo:lo + cs], items[1][lo:lo + cs],
                     items[2][lo:lo + cs])
                    for lo in range(0, max(int(items[0].shape[0]), 1), cs))
            stream = ((int(batch[0].shape[0]),
                       np.concatenate(pad_and_pack(*batch, cs)))
                      for batch in batches if batch[0].shape[0])
        for num, words in spanned(stream, EMIT, self._spans):

            def redo(words=words):
                return _dispatch_retrying_session(
                    self, lambda: self._dispatch(s, words))

            ticket, poisoned = redo()
            yield ticket, poisoned, redo, num

    def _job_stream(self, s: int, pair_ids=None):
        """Shard ``s``'s jobs tagged with their shard id (a bound helper,
        so per-shard generators never share a loop variable)."""
        for ticket, poisoned, redo, num in self._shard_jobs(s, pair_ids):
            yield s, ticket, poisoned, redo, num

    def _land(self, jobs, hist_acc, inter_acc, chunk_items, shard_items):
        """Accumulate ``(shard, ticket, poisoned, redo, num_or_None)``
        jobs, re-dispatching through ``redo`` on corrupted partials (the
        landing half of the session retry)."""
        for s, ticket, poisoned, redo, num in jobs:
            pipe = self._pipes[s]
            hist, inter = _land_retrying_session(
                self, lambda t: tuple(a[0] for a in pipe.land(t)),
                ticket, poisoned, redo)
            if num is None:
                num = int(inter[2])
            inter_acc += inter[:2]
            hist_acc += hist
            chunk_items.append(num)
            shard_items[s] += num

    def _drain(self, streams, hist_acc, inter_acc, chunk_items,
               shard_items) -> None:
        """Pull per-shard job streams round-robin (every device gets fed
        each cycle) with at most ``2 * ndev`` dispatches — and their
        buffers — pending at once, so host and device memory stay
        O(ndev · chunk_shape)."""
        limit = 2 * self.ndev
        pending: deque = deque()
        active = list(streams)
        while active:
            alive = []
            for it in active:
                job = next(it, None)
                if job is None:
                    continue
                alive.append(it)
                pending.append(job)
                if len(pending) > limit:
                    self._land([pending.popleft()], hist_acc, inter_acc,
                               chunk_items, shard_items)
            active = alive
        self._land(pending, hist_acc, inter_acc, chunk_items,
                   shard_items)

    def _postprune_items(self) -> int:
        if self._full_items is None:
            if self.use_index and self._pair_index is not None:
                self._full_items = int(self._pair_index.costs.sum())
            else:
                self._full_items = self._space.num_items_postprune()
        return self._full_items

    def _set_stats(self, chunk_items, shard_items, items, full_items,
                   affected_pairs) -> None:
        self.stats = EngineStats(
            backend=self.engine.backend, ndev=self.ndev,
            orient=self.orient, streamed=True, max_items=self.max_items,
            chunks=len(chunk_items), chunk_shape=self.chunk_shape,
            items=items, chunk_items=chunk_items,
            peak_plan_bytes=ITEM_BYTES * self.chunk_shape,
            monolithic_plan_bytes=ITEM_BYTES
            * (-(-full_items // self.ndev) * self.ndev),
            full_items=full_items, affected_pairs=affected_pairs,
            emit=self.emit, desc_shape=self.desc_shape or 0,
            plan_upload_bytes=(
                DESC_BYTES * self.desc_shape + 4 * self.num_anchors + 4
                if self.emit == "device"
                else ITEM_BYTES * self.chunk_shape),
            retries=self.retries,
            partitioned=True,
            partition_shape=getattr(self, "mesh_shape", None),
            shard_items=shard_items,
            graph_resident_bytes=max(sh.resident_bytes
                                     for sh in self._shards),
            graph_replicated_bytes=replicated_graph_bytes(self._space),
            plan_upload_bytes_total=_uploaded(self._pipes),
            **_host_seconds(self._spans), indexed=self.use_index)
        self._spans = {}
        self.engine.stats = self.stats

    def census(self) -> np.ndarray:
        """Full census of the resident graph: every shard walks its own
        stream on its own device, partials merge on the host.  (Re)bases
        the running C_k that :meth:`update` moves forward."""
        self._check_open()
        hist_acc = np.zeros(64, np.int64)
        inter_acc = np.zeros(2, np.int64)
        chunk_items: list[int] = []
        shard_items = [0] * self.ndev
        self._drain([self._job_stream(s) for s in range(self.ndev)],
                    hist_acc, inter_acc, chunk_items, shard_items)
        base_asym, base_mut = global_bases(self._space)
        self._census = assemble_counts(self.n, base_asym, base_mut,
                                       hist_acc, inter_acc)
        items = int(sum(chunk_items))
        self._full_items = items
        self._set_stats(chunk_items, shard_items, items, items,
                        self._space.num_pairs)
        return self._census.copy()

    def _recount(self, aff_keys, chunk_items, shard_items,
                 touched_owner=None, touched=None):
        """Contribution of the affected pairs, recounted shard by shard
        on the CURRENT resident arrays; shards owning none of them are
        never dispatched.  Returns (contribution, dirty shard ids)."""
        base_asym = base_mut = 0
        streams = []
        dirty = []
        for s in range(self.ndev):
            loc = np.nonzero(np.isin(self._keys[s], aff_keys,
                                     assume_unique=True))[0]
            if loc.size == 0:
                continue
            dirty.append(s)
            sh = self._shards[s]
            if touched_owner is not None:
                # remember which shard owns each touched vertex's pairs —
                # appeared pairs are assigned for locality from this map
                gids = sh.pair_ids[loc]
                for u in np.intersect1d(
                        np.concatenate([self._space.pair_u[gids],
                                        self._space.pair_v[gids]]),
                        touched).tolist():
                    touched_owner.setdefault(int(u),
                                             self._tile_shard(s))
            ba, bm = base_for_pairs(sh.space, loc)
            base_asym += ba
            base_mut += bm
            streams.append(self._job_stream(s, loc))
        hist = np.zeros(64, np.int64)
        inter = np.zeros(2, np.int64)
        self._drain(streams, hist, inter, chunk_items, shard_items)
        return contribution_counts(base_asym, base_mut, hist, inter), \
            dirty

    def _refresh_shards(self, dirty, space_new, key_all_new,
                        costs_new=None) -> None:
        """Re-extract + re-upload the dirty pair shards against the new
        space; untouched shards keep their device buffers verbatim.
        ``costs_new`` is the per-pair post-prune cost vector — the
        session index's when it has one, else one global scan shared by
        every dirty shard."""
        if costs_new is None:
            costs_new = postprune_pair_counts(space_new)
        for s in dirty:
            ids = np.searchsorted(key_all_new, self._keys[s])
            self._shards[s] = extract_shard(space_new, ids, index=s,
                                            costs=costs_new)
            self._load[s] = self._shards[s].items
        self._upload_shards(dirty)

    def update(self, add_src=None, add_dst=None,
               del_src=None, del_dst=None) -> np.ndarray:
        """Apply an edge delta and return the edited graph's census.

        Only the shards owning affected pairs recount (old contribution
        on their still-resident arrays, new contribution after refresh);
        every other shard keeps its device buffers untouched and
        dispatches nothing.  Bit-identical to a from-scratch census."""
        self._check_open()
        if self._census is None:
            raise RuntimeError(
                "no baseline census: call census() before update()")
        with span(MERGE, self._spans):
            g_new, delta = apply_delta(self._g, add_src, add_dst,
                                       del_src, del_dst)
        self.last_delta = delta
        if delta.num_changed == 0:
            self._set_stats([], [0] * self.ndev, 0,
                            self._postprune_items(), 0)
            return self._census.copy()

        n = self.n
        space_old = self._space
        with span(PAIR, self._spans):
            if self.use_index:
                aff_old = self._pair_index.affected_pair_ids(delta.touched)
            else:
                aff_old = affected_pair_ids(space_old, delta.touched)
            aff_keys_old = (space_old.pair_u * n
                            + space_old.pair_v)[aff_old]
        chunk_items: list[int] = []
        shard_items = [0] * self.ndev
        touched_owner: dict[int, int] = {}
        contrib_old, dirty_old = self._recount(
            aff_keys_old, chunk_items, shard_items,
            touched_owner=touched_owner, touched=delta.touched)

        # ---- reassign ownership and refresh only the dirty shards
        self._g = g_new
        with span(PAIR, self._spans):
            if self.use_index:
                # edit the persistent index into the new pair space; its
                # maintained keys/costs also feed the owner routing and
                # the dirty-shard refresh below
                space_new = self._pair_index.apply(delta, g_new)
                key_all_new = self._pair_index.keys
                costs_new = self._pair_index.costs
            else:
                space_new = pair_space(g_new, orient=self.orient,
                                       prune_self=self.prune_self)
                key_all_new = space_new.pair_u * n + space_new.pair_v
                costs_new = None
        self._space = space_new
        self._full_items = None
        dkeys = delta.pair_lo * n + delta.pair_hi
        vanished = dkeys[delta.new_code == 0]
        appeared = dkeys[delta.old_code == 0]
        okeys = self._ownership()
        # dirty is tracked per PAIR SHARD (== per device in 1D; a 2D
        # shard refreshes all of its vertex-slice tiles together so the
        # designated base-term slice stays consistent within the shard)
        dirty = {self._tile_shard(t) for t in dirty_old}
        if vanished.size:
            for s in sorted(dirty):  # vanished pairs were affected-old
                okeys[s] = np.setdiff1d(okeys[s], vanished,
                                        assume_unique=True)
        if appeared.size:
            pending: dict[int, list[int]] = {}
            # locality first — an appeared pair joins the shard already
            # owning its endpoints' pairs — but only while that shard is
            # within 1.25x of the mean load; past it, spill to the
            # lightest shard so sustained churn cannot concentrate the
            # whole pair space onto one device
            cap = 1.25 * (sum(self._load) / len(self._load)) + 1.0
            for k in appeared.tolist():
                u, v = divmod(k, n)
                s = touched_owner.get(u, touched_owner.get(v))
                if s is None or self._load[s] > cap:
                    s = int(np.argmin(self._load))
                touched_owner.setdefault(u, s)
                touched_owner.setdefault(v, s)
                idx = int(np.searchsorted(key_all_new, k))
                self._load[s] += int(space_new.counts[idx])
                pending.setdefault(s, []).append(k)
            for s, ks in pending.items():
                okeys[s] = _sorted_union(okeys[s], np.asarray(ks, np.int64))
                dirty.add(s)
        self._refresh_shards(sorted(dirty), space_new, key_all_new,
                             costs_new)

        # ---- new-side recount (owners of every affected new pair are,
        # by construction, in the refreshed dirty set)
        with span(PAIR, self._spans):
            if self.use_index:
                aff_new = self._pair_index.affected_pair_ids(delta.touched)
            else:
                aff_new = affected_pair_ids(space_new, delta.touched)
            aff_keys_new = key_all_new[aff_new]
        contrib_new, _ = self._recount(
            aff_keys_new, chunk_items, shard_items)
        self._census = combine(self._census, contrib_old, contrib_new,
                               self.n)
        self._set_stats(chunk_items, shard_items,
                        int(sum(chunk_items)),
                        self._postprune_items(),
                        int(aff_old.shape[0] + aff_new.shape[0]))
        self._maybe_rebalance()
        return self._census.copy()


class PartitionedEngineSession2D(PartitionedEngineSession):
    """2D-partition-resident session: device = tile (pair shard × vertex
    slice), ownership = pair shard.

    Every device-facing mechanism of :class:`PartitionedEngineSession`
    runs verbatim over the flat tile list (tile ``(s, j)`` at device
    ``s * V + j``).  What the second axis changes is *bookkeeping*: a
    pair belongs to one pair shard (``_ownership`` tracks per-shard key
    sets), its items split across that shard's ``V`` tiles by witness
    vertex range, and its closed-form base term is credited to one
    designated tile (:func:`repro_torch.core.partition.slice_pair_terms`)
    so per-tile bases stay subset-additive.

    :meth:`update` recounts affected pairs only on the tiles whose
    vertex slice holds some of their items, and a dirty shard
    re-extracts all of its slice tiles together against the session's
    pinned vertex bounds.  Bit-identical to the 1D and unpartitioned
    sessions on every backend, orient and emit mode.
    """

    def __init__(self, engine: CensusEngine, g: CompactDigraph, *,
                 mesh_shape: tuple, **kwargs):
        mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1]))
        if mesh_shape[0] * mesh_shape[1] != engine.ndev:
            raise ValueError(
                f"mesh_shape {mesh_shape} needs "
                f"{mesh_shape[0] * mesh_shape[1]} devices; the engine "
                f"has {engine.ndev}")
        self.mesh_shape = mesh_shape
        super().__init__(engine, g, **kwargs)

    def _make_partition(self, space):
        return partition_graph_2d(space=space,
                                  mesh_shape=self.mesh_shape)

    def _set_ownership(self, part) -> None:
        num_shards, num_slices = self.mesh_shape
        self._vertex_bounds = np.asarray(part.vertex_bounds,
                                         dtype=np.int64)
        space = part.space
        key_all = (space.pair_u.astype(np.int64) * space.n
                   + space.pair_v)
        self._shard_keys = [np.sort(key_all[part.owner == s])
                            for s in range(num_shards)]
        self._load = [sum(self._shards[s * num_slices + j].items
                          for j in range(num_slices))
                      for s in range(num_shards)]

    def _tile_shard(self, s: int) -> int:
        return s // self.mesh_shape[1]

    def _ownership(self) -> list:
        return self._shard_keys

    def _refresh_shards(self, dirty, space_new, key_all_new,
                        costs_new=None) -> None:
        """Re-extract every vertex-slice tile of each dirty pair shard
        against the session's pinned slice bounds (one shard's tiles are
        a unit: the designated base-term slice of any of its pairs must
        agree across them), then re-upload just those tiles.
        ``costs_new`` is ignored: tile costs are range-restricted per
        vertex slice, so they are recomputed here."""
        num_slices = self.mesh_shape[1]
        bounds = self._vertex_bounds
        terms = slice_pair_terms(space_new, bounds)
        slice_costs = [range_postprune_pair_counts(
            space_new, int(bounds[j]), int(bounds[j + 1]))
            for j in range(num_slices)]
        tiles = []
        for s in dirty:
            ids = np.searchsorted(key_all_new, self._shard_keys[s])
            load = 0
            for j in range(num_slices):
                t = s * num_slices + j
                sh = extract_shard(
                    space_new, ids, index=t, costs=slice_costs[j],
                    vertex_range=(int(bounds[j]), int(bounds[j + 1])),
                    pair_term=terms[j])
                self._shards[t] = sh
                self._keys[t] = sh.keys
                load += sh.items
                tiles.append(t)
            self._load[s] = load
        self._upload_shards(tiles)
