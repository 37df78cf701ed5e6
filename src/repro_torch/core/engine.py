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
  buffer of O(pairs) descriptors + anchors
  (:class:`repro_torch.core.planner.DescriptorWindow`); the device maps
  every flat item index back to its pair, derives slot/side against the
  resident CSR and applies the pruning predicate in place.
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

Host phases are marked as ``torch.profiler`` ranges, read from a trace of
a run (``chip_smoke.py`` does): ``census.plan`` (pair space, bases and
window shapes), ``census.partition`` (a partitioned run's pair space, LPT
and shard extraction) and ``census.window`` (one window's descriptors or
item words).  Outside a profiler a range costs a few microseconds.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.census import (
    BACKENDS, assemble_census, assemble_counts, desc_batch_partials_fn,
    desc_partials_fn, partials_fn)
from repro_torch.core.digraph import CompactDigraph, GraphDelta, apply_delta
from repro_torch.core.incremental import (
    affected_pair_ids, combine, contribution_counts,
    subset_descriptor_windows)
from repro_torch.core.pair_index import PairSpaceIndex
from repro_torch.core.partition import (
    graph_bytes, partition_graph, partition_graph_2d,
    replicated_graph_bytes, stacked_device_arrays)
from repro_torch.core.plan_stream import (
    PlanChunker, ShardSchedule, ShardStreamPipeline, WindowBatcher)
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


@dataclass
class EngineStats:
    """Execution stats of the last :class:`CensusEngine` run, field for
    field as the JAX package's ``EngineStats`` (its fault-tolerance
    fields excepted).

    ``peak_plan_bytes`` is the per-dispatch item-lane footprint at
    packed-item width (``ITEM_BYTES * chunk_shape``, all devices);
    ``monolithic_plan_bytes`` is what one dispatch of the same work would
    have shipped; ``plan_upload_bytes`` is what each dispatch uploads to
    each device (packed items under host emission, divided across the
    devices when the items are split; the descriptor window under device
    emission, whole on every device when replicated, one private window
    per device when partitioned).  ``step_compiles`` and
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
    #: windows under lock-step) is ``plan_pad_bytes_total``
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
    #: partitioned runs: host walltime of the pair space, the LPT and the
    #: shard extraction (the ``census.partition`` range)
    host_partition_seconds: float = 0.0

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
        if self.plan_host_seconds:
            part += (f" host[pair={self.host_pair_seconds * 1e3:.2f}ms"
                     f" merge={self.host_merge_seconds * 1e3:.2f}ms"
                     f" emit={self.host_emit_seconds * 1e3:.2f}ms"
                     f"{' indexed' if self.indexed else ''}]")
        return (f"{self.backend} [{mode} emit={self.emit}] "
                f"ndev={self.ndev} "
                f"chunks={self.chunks} items={self.items} "
                f"peak_plan_bytes={self.peak_plan_bytes} "
                f"(monolithic {self.monolithic_plan_bytes}) "
                f"plan_upload_bytes={self.plan_upload_bytes} "
                f"chunk_max_over_mean={self.chunk_max_over_mean:.3f} "
                f"step_compiles={self.step_compiles}" + part)


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
    waited on by an event only when they are landed, so the ring must
    exceed the dispatches in flight.  On the CPU everything is
    synchronous.
    """

    def __init__(self, device: torch.device, shape, *, stream=None,
                 rows: int = 1, ring: int = 2):
        self.device = device
        self.cuda = device.type == "cuda"
        self.rows = rows
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
        self.count = 0

    def submit(self, words: np.ndarray, launch):
        """Ship host buffer ``words``, enqueue ``launch(device_words) ->
        (hist, inter)`` on the compute stream and start bringing its
        partials back; returns a ticket for :meth:`land`."""
        if not self.cuda:
            return launch(torch.from_numpy(words))
        k = self.count
        self.count += 1
        slot = k % 2
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        self.host_in[slot].numpy()[...] = words
        copied = torch.cuda.Event()
        with torch.cuda.stream(self.copy_stream):
            if self.read[slot] is not None:
                self.copy_stream.wait_event(self.read[slot])
            self.dev_in[slot].copy_(self.host_in[slot], non_blocking=True)
            copied.record(self.copy_stream)
        self.copied[slot] = copied
        r = k % len(self.host_out)
        out = self.host_out[r]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(copied)
            hist, inter = launch(self.dev_in[slot])
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

    def land(self, ticket) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a submitted dispatch; its partials as int64 arrays,
        ``(rows, 64)`` and ``(rows, lanes)``."""
        if not self.cuda:
            hist, inter = ticket
            return (hist.reshape(self.rows, 64).numpy().astype(np.int64),
                    inter.reshape(self.rows, -1).numpy().astype(np.int64))
        r, lanes = ticket
        self.done[r].synchronize()
        out = self.host_out[r].numpy().astype(np.int64)
        n = self.rows * 64
        return (out[:n].reshape(self.rows, 64),
                out[n:n + self.rows * lanes].reshape(self.rows, lanes))


def _dispatch(pipes, launches, steps, landed=None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Run each step that ``steps`` yields — one int32 host buffer per
    pipe — as one dispatch on every pipe, ``launches[d](device_words) ->
    (hist, inter)`` on ``pipes[d]``: step k+1 is built, uploaded and
    launched before step k lands, and a step lands when every pipe's
    dispatch has (the step's barrier), its partials summed in int64.
    Every dispatch has landed when it returns.

    ``landed(k, inter)`` is called with each step's summed int64 ``inter``
    lanes as it lands, in order.  Returns the int64 sums of ``hist`` and
    of ``inter``'s two census lanes."""
    hist_acc = np.zeros(64, np.int64)
    inter_acc = np.zeros(2, np.int64)
    pending = None

    def land(k, tickets):
        hist = np.zeros(64, np.int64)
        inter = None
        for pipe, ticket in zip(pipes, tickets):
            h, i = pipe.land(ticket)
            hist += h[0]
            inter = i[0] if inter is None else inter + i[0]
        hist_acc[:] += hist
        inter_acc[:] += inter[:2]
        if landed is not None:
            landed(k, inter)

    for k, buffers in enumerate(steps):
        tickets = [pipe.submit(words, launch) for pipe, launch, words
                   in zip(pipes, launches, buffers)]
        if pending is not None:
            land(k - 1, pending)
        pending = tickets
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
    """

    def __init__(self, device=None, backend: str = "fused",
                 emit: str = "device", *, devices=None,
                 partition: bool = False,
                 partition_2d: tuple | None = None,
                 schedule: str = "async",
                 pipeline_depth: int = PIPELINE_DEPTH,
                 max_windows_per_dispatch: int = MAX_WINDOWS_PER_DISPATCH):
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
            arrays = self._upload_graph((plan.indptr, plan.packed,
                                         plan.pair_u, plan.pair_v,
                                         plan.pair_code, plan.item_sp,
                                         plan.item_pv))
            hist64, inter = step(*arrays)
            return assemble_census(plan, hist64.cpu().numpy(),
                                   inter.cpu().numpy())
        lanes = self._lanes()
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
        return assemble_census(plan, hist, inter)

    def run(self, g: CompactDigraph, *, max_items: int | None = None,
            orient: str = "none", prune_self: bool = True,
            progress=None, emit: str | None = None,
            schedule: str | None = None, part=None) -> np.ndarray:
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
        if self.partition:
            return self._run_partitioned(g, max_items=max_items,
                                         orient=orient,
                                         prune_self=prune_self,
                                         progress=progress, emit=emit,
                                         schedule=schedule, part=part)
        with record_function("census.plan"):
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
        Sessions run on one device: partitioned sessions (and with them
        ``auto_rebalance_threshold``) are not ported yet, and a session
        of an engine on several devices raises."""
        if self.partition or self.ndev > 1:
            raise ValueError(
                "sessions run on one device; partitioned and multi-device "
                "sessions are not ported yet")
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
                    yield [np.concatenate(
                        [chunk.item_sp[d * per:(d + 1) * per],
                         chunk.item_pv[d * per:(d + 1) * per]])
                        for d in range(ndev)]

        hist_acc, inter_acc = _dispatch(pipes, launches, steps())

        st = self.stats
        st.chunk_items = chunk_items
        st.items = int(sum(chunk_items))
        st.monolithic_plan_bytes = ITEM_BYTES * (-(-st.items // ndev) * ndev)
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)

    def _run_stream_desc(self, chunker: PlanChunker, progress,
                         max_items: int | None) -> np.ndarray:
        """Device-emission stream: per chunk the host ships the O(pairs)
        descriptor window (whole, to every device); the device expands
        pairs→items against the resident flat-index array, each device
        its contiguous slice of it.  Bit-identical to :meth:`_run_stream`
        — every item the plan would prune is a zero contribution of the
        classification masks (see
        :func:`repro_torch.core.census.prune_keep_mask`)."""
        space = chunker.space
        ndev = self.ndev
        words_len = 1 + 3 * chunker.desc_shape + chunker.num_anchors
        gbytes = replicated_graph_bytes(space)
        self.stats = self._stats(
            orient=space.orient,
            streamed=max_items is not None, max_items=max_items,
            chunks=chunker.num_chunks, chunk_shape=chunker.chunk_shape,
            items=0, peak_plan_bytes=ITEM_BYTES * chunker.chunk_shape,
            emit="device", desc_shape=chunker.desc_shape,
            # the descriptor buffer goes whole to every device
            plan_upload_bytes=(DESC_BYTES * chunker.desc_shape
                               + 4 * chunker.num_anchors + 4),
            graph_resident_bytes=gbytes, graph_replicated_bytes=gbytes)
        if chunker.num_chunks == 0:
            return assemble_counts(space.n, 0, 0, np.zeros(64, np.int64),
                                   np.zeros(2, np.int64))
        lanes = self._lanes()
        graph = self._replicate(lanes, chunker.device_arrays())
        # the flat item-index space: made on each device once, reused by
        # every chunk; device d expands its contiguous slice of it
        idx = self._flat_index(lanes, chunker.chunk_shape)
        per = chunker.chunk_shape // ndev
        step = desc_partials_fn(self.backend, space.search_iters,
                                chunker.desc_iters, space.orient,
                                space.prune_self)
        pipes = [_Pipeline(ld.device, (words_len,), stream=ld.stream)
                 for ld in lanes]
        launches = [
            _desc_launcher(step, graph[ld.device],
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
                with record_function("census.window"):
                    host_words = chunker.descriptors(k).device_words()
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
        return assemble_counts(space.n, base_asym, base_mut,
                               hist_acc, inter_acc)

    # -------------------------------------------------------- partitioned
    def _run_partitioned(self, g: CompactDigraph, *,
                         max_items: int | None, orient: str,
                         prune_self: bool, progress, emit: str,
                         schedule: str, part=None) -> np.ndarray:
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
        t0 = time.perf_counter()
        with record_function("census.partition"):
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
        partition_s = time.perf_counter() - t0
        with record_function("census.plan"):
            sched = ShardSchedule([sh.space for sh in part.shards],
                                  max_items, self.ndev,
                                  mesh_shape=getattr(part, "mesh_shape",
                                                     None))
        upload = (4 * (1 + 3 * sched.desc_shape + sched.num_anchors)
                  if emit == "device"
                  else ITEM_BYTES * sched.chunk_shape)
        if schedule == "async":
            census = self._run_partitioned_async(part, sched, progress,
                                                 emit, max_items, upload)
        else:
            census = self._run_partitioned_lockstep(part, sched, progress,
                                                    emit, max_items, upload)
        self.stats.host_partition_seconds = partition_s
        return census

    def _shard_graphs(self, part) -> list[tuple[torch.Tensor, ...]]:
        """Each shard's padded local arrays (:func:`stacked_device_arrays`
        rows: common lengths, as the reference ships them) committed to
        its logical device."""
        arrs = stacked_device_arrays(part.shards)
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
        graphs = self._shard_graphs(part)
        chunk_items: list[int] = []
        cs = sched.chunk_shape
        if emit == "device":
            idx = self._flat_index(lanes, cs)
            step = desc_partials_fn(self.backend, space.search_iters,
                                    sched.desc_iters, space.orient,
                                    space.prune_self)
            words_len = 1 + 3 * sched.desc_shape + sched.num_anchors
            pipes = [_Pipeline(ld.device, (words_len,), stream=ld.stream)
                     for ld in lanes]
            launches = [_desc_launcher(step, graphs[s], idx[ld.device],
                                       sched.num_anchors)
                        for s, ld in enumerate(lanes)]

            def steps():
                for k in range(sched.num_steps):
                    with record_function("census.window"):
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
                    with record_function("census.window"):
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
                               upload: int) -> np.ndarray:
        """Async per-shard streams: every device drains its PRIVATE
        window queue with no inter-shard barrier.

        One background producer per non-empty shard builds that shard's
        windows (numpy only) ``pipeline_depth`` ahead into its private
        queue (:class:`repro_torch.core.plan_stream.ShardStreamPipeline`);
        zero-window shards get no producer and no rotation slot.  This
        thread does every upload and launch: each window (or megabatch)
        goes through its shard's double-buffered pinned pipeline onto the
        shard's device stream, with a bounded in-flight deque of
        ``2 * ndev`` dispatches.

        Under ``emit="device"`` each dispatch is a **megastep**: the
        producer coalesces up to K descriptor windows into one
        ``(cap, words)`` batch (:class:`repro_torch.core.plan_stream
        .WindowBatcher`, ``cap = min(max_windows_per_dispatch, longest
        shard queue)``) and one launch runs them all; K adapts between 1
        and ``cap`` from stalls and backlog.  ``emit="host"`` dispatches
        one window at a time and skips fully pruned windows.

        Partials land on the host in int64, in any order — integer
        sums, so the landing order cannot change a bit.
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
        lanes = self.devices
        graphs = self._shard_graphs(part)
        cs = sched.chunk_shape
        batcher = None
        if emit == "device":
            idx = self._flat_index(lanes, cs)
            step = desc_batch_partials_fn(self.backend, space.search_iters,
                                          sched.desc_iters, space.orient,
                                          space.prune_self)
            words_len = 1 + 3 * sched.desc_shape + sched.num_anchors
            batcher = WindowBatcher(cap, words_len)
            shape, rows = (cap, words_len), cap

            def launcher(s):
                graph, ix = graphs[s], idx[lanes[s].device]
                return lambda words: step(*graph, words, ix)

            def make_source(s):
                for k in range(sched.steps_for(s)):
                    yield sched.descriptors(s, k).device_words()
        else:
            step = partials_fn(self.backend, space.search_iters)
            shape, rows = (2 * cs,), 1

            def launcher(s):
                return _item_launcher(step, graphs[s], cs)

            def make_source(s):
                for k in range(sched.steps_for(s)):
                    sp, pv, num = sched.shard_step_items(s, k)
                    if num == 0:
                        # fully-pruned window: zero contribution by
                        # construction — never dispatched
                        continue
                    yield np.concatenate([sp, pv]), num

        # a shard with no window gets no producer and no rotation slot
        live = [s for s in range(ndev) if sched.steps_for(s) > 0]
        limit = 2 * ndev
        pipes = {s: _Pipeline(lanes[s].device, shape,
                              stream=lanes[s].stream, rows=rows,
                              ring=limit + 2) for s in live}
        launches = {s: launcher(s) for s in live}
        hist_acc = np.zeros(64, np.int64)
        inter_acc = np.zeros(2, np.int64)
        chunk_items: list[int] = []
        shard_steps = [0] * ndev
        dispatches = win_max = pad_windows = 0

        def land(job) -> None:
            s, ticket, x = job
            hist, inter = pipes[s].land(ticket)
            if emit == "device":
                # megastep: per-window int32 partials stacked (cap, ·);
                # summing the first x rows in int64 is landing x windows
                hist_acc[:] += hist[:x].sum(axis=0)
                inter_acc[:] += inter[:x, :2].sum(axis=0)
                nums = [int(inter[i, 2]) for i in range(x)]
            else:
                hist_acc[:] += hist[0]
                inter_acc[:] += inter[0, :2]
                nums = [x]
            for num in nums:
                if progress is not None:
                    progress(len(chunk_items), total_windows, num)
                chunk_items.append(num)

        pending: deque = deque()
        with ShardStreamPipeline([make_source(s) for s in live],
                                 depth=self.pipeline_depth,
                                 batch=batcher) as pipeline:
            for slot, (words, x) in pipeline:
                s = live[slot]
                if emit == "device":
                    shard_steps[s] += x
                    win_max = max(win_max, x)
                    pad_windows += cap - x
                else:
                    shard_steps[s] += 1
                    win_max = 1
                pending.append((s, pipes[s].submit(words, launches[s]), x))
                dispatches += 1
                if len(pending) > limit:
                    land(pending.popleft())
            while pending:
                land(pending.popleft())

        st = self.stats
        st.chunk_items = chunk_items
        st.chunks = len(chunk_items)
        st.items = int(sum(chunk_items))
        st.shard_steps = shard_steps
        st.stall_steps = pipeline.stalls
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
        self._pipe = _Pipeline(self.device, (words,))

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
                    yield [np.concatenate(pad_and_pack(
                        item_pair, item_slot, item_side, cs))]

        hist, inter = _dispatch(
            [self._pipe], [_item_launcher(self._step, self._dev, cs)],
            words())
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
            [self._pipe],
            [_desc_launcher(self._step, self._dev, self._idx,
                            self.num_anchors)],
            ([win.device_words()] for win in windows if win.num_preprune),
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
