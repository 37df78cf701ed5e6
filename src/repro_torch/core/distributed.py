"""Distributed triad census: the public partition + device-list API.

The port's counterpart of the JAX package's ``core/distributed.py``.  A
JAX mesh becomes a list of *logical* devices (:func:`default_devices`):
each a physical device with a CUDA stream of its own, so several shards
can share one card and still launch concurrently.  Every regime ends in
the paper's single merge of per-processor private census vectors, here
an int64 sum on the host:

* **Replicated** (the default): every device holds the whole CSR and
  each chunk's lanes are split across the devices.
* **Partitioned** (``partition=True`` / :func:`partition_graph`): the
  pair space is LPT-split into one private shard per device, each device
  holds only its shard's relabeled local subgraph and walks its own
  window stream.
* **2D partitioned** (``partition_2d=(P, V)`` /
  :func:`partition_graph_2d`): each pair shard's witness range is split
  over ``V`` vertex slices, so hub rows are sliced too.

All are bit-identical to the single-device census for every backend,
orient, emit mode and schedule.  Dispatch lives in
:class:`repro_torch.core.engine.CensusEngine`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.engine import CensusEngine, LogicalDevice
from repro_torch.core.partition import (
    GraphPartition, GraphPartition2D, LocalShard, PartitionStats,
    extract_shard, graph_bytes, lpt_assign, lpt_assign_heap,
    partition_graph, partition_graph_2d, replicated_graph_bytes,
    vertex_slices)
from repro_torch.core.planner import CensusPlan

__all__ = [
    "GraphPartition", "GraphPartition2D", "LocalShard", "LogicalDevice",
    "PartitionStats", "default_devices", "extract_shard", "graph_bytes",
    "lpt_assign", "lpt_assign_heap", "partition_graph",
    "partition_graph_2d", "replicated_graph_bytes", "shard_report",
    "triad_census_distributed", "triad_census_graph", "vertex_slices",
]


def default_devices(k: int | None = None,
                    device=None) -> list[LogicalDevice]:
    """``k`` logical devices, each with a CUDA stream of its own.

    ``device=None`` spreads them round-robin over the CUDA cards present
    (on a machine with one card every logical device is ``cuda:0``) and
    raises when there is none; ``device="cpu"`` gives ``k`` CPU devices
    (plain torch, no streams); any other ``device`` puts all ``k`` on it.
    ``k=None`` is one logical device per card (1 on the CPU).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; default_devices runs on the "
                "GPU unless given device='cpu'")
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [device]
    if k is None:
        k = len(cards) if device is None else 1
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return [LogicalDevice.on(i, cards[i % len(cards)]) for i in range(k)]


def shard_report(part: GraphPartition | GraphPartition2D,
                 stats=None) -> str:
    """Human-readable per-shard balance + residency table of a
    :func:`partition_graph` or :func:`partition_graph_2d` result (2D
    partitions label each row with its ``(pair_shard, vertex_slice)``
    tile coordinate and add a resident-entry replication line).

    Pass the run's :class:`~repro_torch.core.engine.EngineStats` as
    ``stats`` to append a fault-tolerance section when anything went
    wrong: retried windows, producer watchdog restarts, retired logical
    devices whose queues failed over to the survivors, and
    checkpoint-resumed windows.
    """
    text = part.stats.report()
    if stats is None:
        return text
    fired = (stats.retries or stats.failovers or stats.watchdog_fires
             or stats.retired_devices or stats.resumed_windows)
    if not fired:
        return text
    lines = ["", "fault tolerance:"]
    if stats.retired_devices:
        lines.append(f"  retired devices : {sorted(stats.retired_devices)}"
                     " (queues drained by survivors)")
    lines.append(f"  retries         : {stats.retries}")
    lines.append(f"  failovers       : {stats.failovers}")
    lines.append(f"  watchdog fires  : {stats.watchdog_fires}")
    if stats.resumed_windows:
        lines.append(f"  resumed windows : {stats.resumed_windows}"
                     " (skipped via checkpoint)")
    return text + "\n".join(lines)


def triad_census_distributed(plan: CensusPlan, devices=None,
                             backend: str = "fused") -> np.ndarray:
    """Exact 16-type census of a prebuilt (monolithic, replicated) plan
    across ``devices`` (default: :func:`default_devices`): replicated
    graph, items split across the devices; the plan must be padded to a
    multiple of their count (``build_plan(g, pad_to=len(devices))``)."""
    if devices is None:
        devices = default_devices()
    return CensusEngine(devices=devices, backend=backend).run_plan(plan)


def triad_census_graph(g: CompactDigraph, devices=None,
                       backend: str = "fused", orient: str = "none",
                       max_items: int | None = None,
                       progress=None,
                       emit: str | None = None,
                       partition: bool = False,
                       partition_2d: tuple[int, int] | None = None,
                       schedule: str = "async") -> np.ndarray:
    """Convenience: plan + distribute + count in one call.

    ``max_items=None`` is one dispatch per device; an integer budget
    streams the plan in O(max_items) host memory.  ``emit`` picks the
    work-item path (default ``"device"``: descriptor upload + on-device
    pair→item expansion; ``"host"``: packed-item upload).
    ``partition=True`` shards the GRAPH across the devices and
    ``schedule`` picks the discipline (``"async"``: private per-shard
    streams; ``"lockstep"``: one barrier per step, the oracle);
    ``partition_2d=(P, V)`` (``P * V == len(devices)``) is the 2D
    pair×vertex decomposition.  Bit-identical on every combination.
    """
    if devices is None:
        devices = default_devices()
    engine = CensusEngine(devices=devices, backend=backend,
                          partition=partition, partition_2d=partition_2d,
                          schedule=schedule)
    return engine.run(g, max_items=max_items, orient=orient,
                      progress=progress, emit=emit)
