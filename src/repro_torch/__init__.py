"""Parallel triad census in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` to PyTorch and CUDA (NVIDIA
Hopper, ``sm_90a``).  It imports neither JAX nor ``repro``; every module
mirrors its counterpart there (``repro_torch.core.planner`` ↔
``repro.core.planner``, ``repro_torch.kernels.ops`` ↔
``repro.kernels.ops``, …) and is held to bit-identical censuses,
partials and stats.

Public API::

    g = from_edges(src, dst, n)                 # paper Fig 7 structure
    plan = build_plan(g)                        # manhattan-collapse plan
    census = triad_census(plan, device="cpu")   # plain torch on the host

    # stream bounded descriptor windows through the fused CUDA kernel
    engine = CensusEngine()                     # device=None: the GPU
    census = engine.run(g, max_items=2**24)
    engine.stats                                # chunks, items, bytes

    # resident sliding-window session: upload once, recount by edge delta
    session = engine.session(g, max_items=2**24)
    c0 = session.census()
    c1 = session.update(add_src, add_dst, del_src, del_dst)

    # partitioned over 4 logical devices (one card: 4 streams on cuda:0)
    engine = CensusEngine(devices=default_devices(4), partition=True)
    census = engine.run(g, max_items=2**24)     # async, K-window megasteps
    print(engine.stats.summary())
    print(shard_report(partition_graph(g, num_shards=4)))
    CensusEngine(devices=default_devices(4), partition_2d=(2, 2),
                 schedule="lockstep").run(g, max_items=2**24)

    # sessions of a multi-device engine: a partitioned session's update
    # dispatches only the shards that own touched pairs
    session = engine.session(g, max_items=2**24)  # PartitionedEngineSession
    c0 = session.census()
    c1 = session.update(add_src, add_dst, del_src, del_dst)

    # fault tolerance: seeded faults, retries, failover to the surviving
    # streams, and a checkpoint journal to resume a killed run from
    plan = FaultPlan.seeded(0, 4, producer_errors=1, dispatch_errors=1,
                            retire_devices=1, poisons=1)
    engine = CensusEngine(devices=default_devices(4), partition=True,
                          faults=plan)
    census = engine.run(g, max_items=2**24, checkpoint="run.ckpt")
    engine.stats.retries, engine.stats.failovers  # what recovery cost
    census = engine.resume(g, "run.ckpt", max_items=2**24)  # after a kill

    # temporal monitor: sliding-window censuses of an edge stream, each
    # slide a delta update of one resident session, with robust-z alarms
    monitor = TriadMonitor(n_hosts, window=1200, stride=600, history=20)
    monitor.observe(src, dst)                   # any batch sizes
    monitor.censuses, monitor.alarms()          # (windows, 16); alarms
    monitor.window_stats[-1].items              # items of full_items

Backends map one-to-one onto ``repro``'s:

============  ================  =========================================
``repro``     ``repro_torch``   what runs
============  ================  =========================================
``jnp``       ``torch``         plain torch (the oracle)
``pallas``    ``hist``          torch classification + CUDA histogram
``pallas-     ``fused``         one CUDA kernel per dispatch (default)
fused``
============  ================  =========================================

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device, ``device=None`` raises.  The
kernels are built from ``kernels/csrc`` by ``nvcc`` at first CUDA use.

The LM substrate's serving path (the attention architectures of
``repro_torch.configs``) lives in ``repro_torch.models`` and
``repro_torch.serve``, in plain torch::

    params = make_params(get_config("qwen2-0.5b"), seed=0)   # on the card
    eng = ServeEngine(cfg, params, max_seq_len=584, q_chunk=64)
    out = eng.generate(prompts, max_new_tokens=64)
"""

from repro_torch.core.census import (
    BACKENDS, assemble_census, assemble_counts, census_partials_desc_batch,
    triad_census)
from repro_torch.core.census_ref import (
    census_batagelj_mrvar, census_bruteforce, census_dict)
from repro_torch.core.digraph import (
    CompactDigraph, GraphDelta, apply_delta, canonical_pairs, from_dense,
    from_edges, from_pairs, to_dense)
from repro_torch.core.distributed import (
    default_devices, shard_report, triad_census_distributed,
    triad_census_graph)
from repro_torch.core.engine import (
    EMIT_MODES, MAX_WINDOWS_PER_DISPATCH, PIPELINE_DEPTH, SCHEDULES,
    CensusEngine, EngineSession, EngineStats, LogicalDevice,
    PartitionedEngineSession, PartitionedEngineSession2D)
from repro_torch.core.faults import (
    Fault, FaultError, FaultInjector, FaultPlan, InjectedFault,
    poison_result)
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
    partition_graph_2d, replicated_graph_bytes, stacked_device_arrays,
    vertex_slices)
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
from repro_torch.kernels.ops import pair_codes

__all__ = [
    "BACKENDS", "assemble_census", "assemble_counts",
    "census_partials_desc_batch", "triad_census",
    "census_batagelj_mrvar", "census_bruteforce", "census_dict",
    "CompactDigraph", "GraphDelta", "apply_delta", "canonical_pairs",
    "from_dense", "from_edges", "from_pairs", "to_dense",
    "default_devices", "shard_report", "triad_census_distributed",
    "triad_census_graph",
    "EMIT_MODES", "MAX_WINDOWS_PER_DISPATCH", "PIPELINE_DEPTH",
    "SCHEDULES", "CensusEngine", "EngineSession", "EngineStats",
    "LogicalDevice", "PartitionedEngineSession",
    "PartitionedEngineSession2D",
    "Fault", "FaultError", "FaultInjector", "FaultPlan", "InjectedFault",
    "poison_result",
    "affected_pair_ids", "subset_contribution",
    "subset_descriptor_windows", "verify_delta_closure",
    "IndexCorruptionError", "PairSpaceIndex",
    "PAPER_WORKLOADS", "erdos_renyi_digraph", "paper_workload",
    "scale_free_digraph",
    "GraphPartition", "GraphPartition2D", "LocalShard", "PartitionStats",
    "extract_shard", "lpt_assign", "lpt_assign_heap", "partition_graph",
    "partition_graph_2d", "replicated_graph_bytes",
    "stacked_device_arrays", "vertex_slices",
    "PlanChunk", "PlanChunker", "ProducerStalledError", "ShardSchedule",
    "ShardStreamPipeline", "WindowBatcher", "iter_plan_chunks",
    "CensusPlan", "DescriptorWindow", "PairSpace", "PlanOverflowError",
    "base_for_pairs", "build_plan", "descriptor_window", "emit_items",
    "emit_items_for_pairs", "iter_descriptor_windows", "pack_items",
    "pair_space", "unpack_items",
    "SECURITY_PATTERN_INDICES", "SECURITY_PATTERNS", "TriadMonitor",
    "FOLD_64_TO_16", "NUM_CLASSES", "TRIAD_NAMES", "TRICODE_TO_CLASS",
    "pair_codes",
]
