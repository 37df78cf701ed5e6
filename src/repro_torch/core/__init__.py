"""The census core of the port: host planning (numpy) and the device
half (torch).  The public API is re-exported by :mod:`repro_torch`; this
package exports what the JAX package's ``repro.core`` does, under the
port's names (``default_devices`` for ``default_mesh``)."""

from repro_torch.core.census import (
    assemble_census, census_partials_desc_batch, triad_census)
from repro_torch.core.census_ref import (
    census_batagelj_mrvar, census_bruteforce, census_dict)
from repro_torch.core.digraph import (
    CompactDigraph, GraphDelta, apply_delta, canonical_pairs, from_dense,
    from_edges, from_pairs, to_dense)
from repro_torch.core.distributed import (
    default_devices, shard_report, triad_census_distributed,
    triad_census_graph)
from repro_torch.core.engine import (
    EMIT_MODES, SCHEDULES, CensusEngine, EngineSession, EngineStats,
    PartitionedEngineSession, PartitionedEngineSession2D)
from repro_torch.core.faults import (
    Fault, FaultError, FaultInjector, FaultPlan, InjectedFault)
from repro_torch.core.generators import (
    PAPER_WORKLOADS, erdos_renyi_digraph, paper_workload,
    scale_free_digraph)
from repro_torch.core.incremental import (
    affected_pair_ids, subset_contribution, subset_descriptor_windows,
    verify_delta_closure)
from repro_torch.core.pair_index import IndexCorruptionError, PairSpaceIndex
from repro_torch.core.partition import (
    GraphPartition, GraphPartition2D, LocalShard, PartitionStats,
    extract_shard, lpt_assign, lpt_assign_heap, partition_graph,
    partition_graph_2d, replicated_graph_bytes, vertex_slices)
from repro_torch.core.plan_stream import (
    PlanChunk, PlanChunker, ProducerStalledError, ShardSchedule,
    ShardStreamPipeline, WindowBatcher, iter_plan_chunks)
from repro_torch.core.planner import (
    CensusPlan, DescriptorWindow, PairSpace, PlanOverflowError,
    base_for_pairs, build_plan, descriptor_window, emit_items,
    emit_items_for_pairs, iter_descriptor_windows, pack_items, pair_space,
    unpack_items)
from repro_torch.core.temporal import (
    SECURITY_PATTERN_INDICES, SECURITY_PATTERNS, TriadMonitor)
from repro_torch.core.tricode import (
    FOLD_64_TO_16, NUM_CLASSES, TRIAD_NAMES, TRICODE_TO_CLASS)

__all__ = [
    "CompactDigraph", "GraphDelta", "apply_delta", "canonical_pairs",
    "from_edges", "from_dense", "from_pairs", "to_dense",
    "CensusPlan", "DescriptorWindow", "PairSpace", "base_for_pairs",
    "build_plan", "descriptor_window", "emit_items",
    "emit_items_for_pairs", "iter_descriptor_windows", "pack_items",
    "pair_space", "unpack_items",
    "PlanChunk", "PlanChunker", "ProducerStalledError", "ShardSchedule",
    "ShardStreamPipeline", "WindowBatcher", "iter_plan_chunks",
    "Fault", "FaultError", "FaultInjector", "FaultPlan", "InjectedFault",
    "PlanOverflowError",
    "CensusEngine", "EMIT_MODES", "SCHEDULES", "EngineSession",
    "EngineStats", "PartitionedEngineSession",
    "PartitionedEngineSession2D",
    "affected_pair_ids", "subset_contribution",
    "subset_descriptor_windows", "verify_delta_closure",
    "IndexCorruptionError", "PairSpaceIndex",
    "GraphPartition", "GraphPartition2D", "LocalShard", "PartitionStats",
    "extract_shard", "lpt_assign", "lpt_assign_heap", "partition_graph",
    "partition_graph_2d", "replicated_graph_bytes", "vertex_slices",
    "shard_report",
    "triad_census", "assemble_census", "census_partials_desc_batch",
    "triad_census_distributed", "triad_census_graph", "default_devices",
    "census_bruteforce", "census_batagelj_mrvar", "census_dict",
    "TRIAD_NAMES", "TRICODE_TO_CLASS", "FOLD_64_TO_16", "NUM_CLASSES",
    "scale_free_digraph", "paper_workload", "erdos_renyi_digraph",
    "PAPER_WORKLOADS", "TriadMonitor", "SECURITY_PATTERNS",
    "SECURITY_PATTERN_INDICES",
]
