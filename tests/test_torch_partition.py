"""The port's partition layer and shard schedules against the JAX
package's: LPT assignment, vertex slices, range-restricted pair counts,
shard extraction, 1D and 2D partitions, stacked device arrays, partition
stats, ``ShardSchedule`` windows, ``WindowBatcher`` buffers, and the
``ShardStreamPipeline`` producers are array-equal (or behave the same) on
the same inputs.

Everything here is numpy on both sides; the tolerance is zero."""

import time

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import generators as ref_generators
from repro.core import partition as ref_partition
from repro.core import plan_stream as ref_stream
from repro.core import planner as ref_planner
from repro_torch.core import partition, plan_stream

torch.set_num_threads(1)

#: as tests/test_census_fused.py
SMALL_SIZES = {"patents": (600, 3.0), "orkut": (250, 12.0),
               "webgraph": (400, 6.0)}
ORIENTS = ("none", "degree")


def spaces(name, orient, seed=0):
    """(the JAX package's pair space, the port's) of one small workload."""
    n, deg = SMALL_SIZES[name]
    ref_g = ref_generators.paper_workload(name, n, deg, seed=seed)
    g = rt.paper_workload(name, n, deg, seed=seed)
    return (ref_planner.pair_space(ref_g, orient=orient),
            rt.pair_space(g, orient=orient))


def assert_same(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


SPACE_FIELDS = ("n", "orient", "prune_self", "max_degree", "search_iters",
                "indptr", "packed", "nbr", "deg", "pair_u", "pair_v",
                "pair_code", "counts", "offsets", "pair_term", "pair_mut")
GRAPH_FIELDS = ("n", "indptr", "packed", "num_arcs")
SHARD_FIELDS = ("index", "pair_ids", "keys", "verts", "items",
                "vertex_range", "num_pairs", "resident_bytes")
STATS_FIELDS = ("num_shards", "total_items", "shard_items", "shard_pairs",
                "shard_bytes", "replicated_bytes", "mesh_shape",
                "shard_entries", "total_entries", "entry_replication",
                "max_over_mean", "max_shard_bytes", "byte_reduction")


def assert_shards_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b, SHARD_FIELDS)
        assert_same(a.graph, b.graph, GRAPH_FIELDS)
        assert_same(a.space, b.space, SPACE_FIELDS)


def costs(kind, size, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(1, 4, size)
    if kind == "power":
        return (rng.pareto(1.2, size) * 10).astype(np.int64) + 1
    if kind == "zeros":
        return np.zeros(size, np.int64)
    return rng.integers(0, 50, size)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["ties", "power", "uniform", "zeros"])
@pytest.mark.parametrize("size", [0, 7, 300, 5000, 20000])
def test_lpt_assign_matches(size, kind, shards):
    """Both assigners, below and above the bucketed path's exact head
    (4,096 pairs), ties included."""
    c = costs(kind, size, seed=size + shards)
    np.testing.assert_array_equal(partition.lpt_assign(c, shards),
                                  ref_partition.lpt_assign(c, shards))
    if size <= 5000:
        np.testing.assert_array_equal(
            partition.lpt_assign_heap(c, shards),
            ref_partition.lpt_assign_heap(c, shards))


def test_lpt_rejects_zero_shards():
    for fn in (partition.lpt_assign, partition.lpt_assign_heap):
        with pytest.raises(ValueError):
            fn([1, 2], 0)


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("name", sorted(SMALL_SIZES))
def test_vertex_slices_and_range_counts(name, orient):
    ref_space, space = spaces(name, orient)
    for v in (1, 2, 3, 4):
        bounds = partition.vertex_slices(space, v)
        np.testing.assert_array_equal(
            bounds, ref_partition.vertex_slices(ref_space, v))
        for got, want in zip(partition.slice_pair_terms(space, bounds),
                             ref_partition.slice_pair_terms(ref_space,
                                                            bounds)):
            np.testing.assert_array_equal(got, want)
        for j in range(v):
            lo, hi = int(bounds[j]), int(bounds[j + 1])
            np.testing.assert_array_equal(
                partition.range_preprune_pair_counts(space, lo, hi),
                ref_planner.range_preprune_pair_counts(ref_space, lo, hi))
            np.testing.assert_array_equal(
                partition.range_postprune_pair_counts(space, lo, hi),
                ref_planner.range_postprune_pair_counts(ref_space, lo, hi))


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("name", sorted(SMALL_SIZES))
def test_extract_shard_matches(name, orient):
    """Random pair subsets, whole and restricted to vertex ranges (the
    2D tiles' slice-aware variant), the empty subset included."""
    ref_space, space = spaces(name, orient)
    rng = np.random.default_rng(3)
    n = space.n
    for take in (0.0, 0.1, 0.5, 1.0):
        ids = np.nonzero(rng.random(space.num_pairs) < take)[0]
        assert_shards_equal(
            [partition.extract_shard(space, ids, index=2)],
            [ref_partition.extract_shard(ref_space, ids, index=2)])
        for lo, hi in ((0, n), (0, n // 3), (n // 3, n), (n // 2, n // 2)):
            assert_shards_equal(
                [partition.extract_shard(space, ids, vertex_range=(lo, hi))],
                [ref_partition.extract_shard(ref_space, ids,
                                             vertex_range=(lo, hi))])
    with pytest.raises(ValueError):
        partition.extract_shard(space, [space.num_pairs])


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("name", sorted(SMALL_SIZES))
def test_partition_graph_matches(name, orient, shards):
    ref_space, space = spaces(name, orient)
    got = partition.partition_graph(num_shards=shards, space=space)
    want = ref_partition.partition_graph(num_shards=shards, space=ref_space)
    np.testing.assert_array_equal(got.owner, want.owner)
    assert_same(got.stats, want.stats, STATS_FIELDS)
    assert got.stats.report() == want.stats.report()
    assert rt.shard_report(got) == want.stats.report()
    assert_shards_equal(got.shards, want.shards)
    for a, b in zip(partition.stacked_device_arrays(got.shards),
                    ref_partition.stacked_device_arrays(want.shards)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1), (2, 3)])
@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("name", sorted(SMALL_SIZES))
def test_partition_graph_2d_matches(name, orient, mesh):
    ref_space, space = spaces(name, orient)
    got = partition.partition_graph_2d(space=space, mesh_shape=mesh)
    want = ref_partition.partition_graph_2d(space=ref_space,
                                            mesh_shape=mesh)
    assert got.mesh_shape == want.mesh_shape
    np.testing.assert_array_equal(got.owner, want.owner)
    np.testing.assert_array_equal(got.vertex_bounds, want.vertex_bounds)
    assert_same(got.stats, want.stats, STATS_FIELDS)
    assert got.stats.report() == want.stats.report()
    assert_shards_equal(got.shards, want.shards)
    assert got.tile(mesh[0] - 1, mesh[1] - 1) is got.shards[-1]
    for a, b in zip(partition.stacked_device_arrays(got.shards),
                    ref_partition.stacked_device_arrays(want.shards)):
        np.testing.assert_array_equal(a, b)


def test_explicit_owner_and_bounds_match():
    """A skewed owner (every pair on shard 0: three empty shards) and
    explicit vertex bounds, as the skewed-schedule tests build them."""
    ref_space, space = spaces("orkut", "none")
    owner = np.zeros(space.num_pairs, np.int64)
    got = partition.partition_graph(num_shards=4, space=space, owner=owner)
    want = ref_partition.partition_graph(num_shards=4, space=ref_space,
                                         owner=owner)
    assert_same(got.stats, want.stats, STATS_FIELDS)
    assert_shards_equal(got.shards, want.shards)
    bounds = np.array([0, 10, space.n], np.int64)
    got = partition.partition_graph_2d(space=space, mesh_shape=(2, 2),
                                       owner=owner % 2, vertex_bounds=bounds)
    want = ref_partition.partition_graph_2d(space=ref_space,
                                            mesh_shape=(2, 2),
                                            owner=owner % 2,
                                            vertex_bounds=bounds)
    assert_shards_equal(got.shards, want.shards)
    for bad in (dict(owner=owner + 9), dict(owner=owner[:-1])):
        with pytest.raises(ValueError):
            partition.partition_graph(num_shards=4, space=space, **bad)


def test_graph_bytes_live_in_partition():
    """The engine's resident-byte figures are the partition module's."""
    from repro_torch.core import engine
    assert engine.graph_bytes is partition.graph_bytes
    assert engine.replicated_graph_bytes is partition.replicated_graph_bytes
    _, space = spaces("webgraph", "none")
    assert partition.replicated_graph_bytes(space) == \
        ref_partition.replicated_graph_bytes(spaces("webgraph", "none")[0])


SCHED_FIELDS = ("chunk_shape", "num_steps", "desc_shape", "desc_iters",
                "num_anchors", "shard_steps", "total_windows", "num_shards",
                "mesh_shape")


def schedules(name, orient, shards, max_items, mesh=None):
    ref_space, space = spaces(name, orient)
    if mesh is None:
        got = partition.partition_graph(num_shards=shards, space=space)
        want = ref_partition.partition_graph(num_shards=shards,
                                             space=ref_space)
    else:
        got = partition.partition_graph_2d(space=space, mesh_shape=mesh)
        want = ref_partition.partition_graph_2d(space=ref_space,
                                                mesh_shape=mesh)
    return (plan_stream.ShardSchedule([sh.space for sh in got.shards],
                                      max_items, shards, mesh_shape=mesh),
            ref_stream.ShardSchedule([sh.space for sh in want.shards],
                                     max_items, shards, mesh_shape=mesh))


@pytest.mark.parametrize("max_items", [None, 1, 2, 3, 4, 5, 97, 1000])
@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("layout", ["1d-2", "1d-4", "2d-2x2", "2d-1x4"])
def test_shard_schedule_matches(layout, orient, max_items):
    """Geometry, every step's stacked words (without and with the anchor
    tables) and items, and every shard's windows; budgets of 1-5 items give 2D tiles windows over pairs with a
    single in-slice item."""
    shards = int(layout[-1]) if layout.startswith("1d") else 4
    mesh = None if layout.startswith("1d") else (
        int(layout[3]), int(layout[5]))
    name = "orkut" if max_items is not None and max_items < 10 else \
        "webgraph"
    got, want = schedules(name, orient, shards, max_items, mesh)
    assert_same(got, want, SCHED_FIELDS)
    for s in range(shards):
        assert got.tile_coords(s) == want.tile_coords(s)
        assert got.steps_for(s) == want.steps_for(s)
    steps = range(0, got.num_steps, max(1, got.num_steps // 20))
    short = 1 + 3 * got.desc_shape
    for k in steps:
        # the port ships the windows without their anchor tables, which the
        # device builds; each shard's full window still equals the reference
        full = want.step_words(k)
        np.testing.assert_array_equal(got.step_words(k), full[:, :short])
        np.testing.assert_array_equal(
            np.stack([got.descriptors(s, k).device_words()
                      for s in range(shards)]), full)
        sp, pv, nums = got.step_items(k)
        wsp, wpv, wnums = want.step_items(k)
        np.testing.assert_array_equal(sp, wsp)
        np.testing.assert_array_equal(pv, wpv)
        assert nums == wnums
        for s in range(shards):
            a = got.shard_step_items(s, k)
            b = want.shard_step_items(s, k)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]


def test_shard_schedule_validation():
    with pytest.raises(ValueError):
        plan_stream.ShardSchedule([], 0, 1)
    _, space = spaces("webgraph", "none")
    with pytest.raises(ValueError):
        plan_stream.ShardSchedule([space, space], 10, 2, mesh_shape=(2, 2))
    empty = plan_stream.ShardSchedule([], None, 4)
    assert empty.num_steps == 0 and empty.total_windows == 0


def rows_of(n, words=3):
    return [np.full(words, i + 1, dtype=np.int32) for i in range(n)]


@pytest.mark.parametrize("cap, rows, start", [
    (4, 6, None), (8, 3, None), (4, 0, None), (8, 10, 2), (1, 5, None),
    (3, 9, 7)])
def test_window_batcher_buffers_match(cap, rows, start):
    got = list(plan_stream.WindowBatcher(cap, 3, start=start).wrap(
        rows_of(rows)))
    want = list(ref_stream.WindowBatcher(cap, 3, start=start).wrap(
        rows_of(rows)))
    assert len(got) == len(want)
    for (buf, real), (wbuf, wreal) in zip(got, want):
        assert real == wreal and buf.dtype == wbuf.dtype == np.int32
        np.testing.assert_array_equal(buf, wbuf)
        np.testing.assert_array_equal(buf[real:], 0)


def test_window_batcher_adapts_like_reference():
    a, b = plan_stream.WindowBatcher(8, 4), ref_stream.WindowBatcher(8, 4)
    for move in ("shrink",) * 5 + ("grow",) * 5:
        getattr(a, move)()
        getattr(b, move)()
        assert a.k == b.k
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            plan_stream.WindowBatcher(*bad)


@pytest.mark.parametrize("batch", [False, True])
def test_pipeline_delivers_every_window_once(batch):
    """Several producers, empty sources included; each window lands once,
    in its shard's order."""
    def source(s, n):
        for i in range(n):
            yield np.array([1, s, i], np.int32)

    counts = [5, 0, 3, 7]
    batcher = plan_stream.WindowBatcher(4, 3) if batch else None
    seen = {s: [] for s in range(len(counts))}
    with plan_stream.ShardStreamPipeline(
            [source(s, n) for s, n in enumerate(counts)], depth=2,
            batch=batcher) as pipe:
        for s, item in pipe:
            if batch:
                buf, real = item
                seen[s] += [int(r[2]) for r in buf[:real]]
            else:
                seen[s].append(int(item[2]))
    assert [seen[s] for s in range(4)] == [list(range(n)) for n in counts]


def test_pipeline_reraises_producer_errors():
    def bad():
        yield np.array([1], np.int32)
        raise KeyError("producer failed")

    pipe = plan_stream.ShardStreamPipeline([bad()], depth=2)
    with pytest.raises(KeyError, match="producer failed"):
        for _ in pipe:
            pass
    pipe.close()
    with pytest.raises(ValueError):
        plan_stream.ShardStreamPipeline([], depth=0)


def test_consumer_stall_shrinks_k():
    """Slow producer + fast consumer: once a batch has been consumed,
    each stall halves k."""
    b = plan_stream.WindowBatcher(8, 2, start=4)

    def slow():
        for i in range(12):
            time.sleep(0.03)
            yield np.array([1, i], np.int32)

    pipe = plan_stream.ShardStreamPipeline([slow()], depth=2, batch=b)
    got = sum(real for _, (_, real) in pipe)
    pipe.close()
    assert got == 12 and pipe.stalls > 0 and b.k < 4


def test_producer_backlog_grows_k():
    """Fast producer + slow consumer on a depth-1 queue: puts block, k
    doubles toward cap."""
    b = plan_stream.WindowBatcher(8, 2, start=1)

    def fast():
        for i in range(12):
            yield np.array([1, i], np.int32)

    pipe = plan_stream.ShardStreamPipeline([fast()], depth=1, batch=b)
    got = 0
    for _, (_, real) in pipe:
        time.sleep(0.08)
        got += real
    pipe.close()
    assert got == 12 and b.k > 1


def test_startup_latency_is_not_starvation():
    b = plan_stream.WindowBatcher(8, 2)

    def warmup():
        time.sleep(0.08)
        for i in range(4):
            yield np.array([1, i], np.int32)

    pipe = plan_stream.ShardStreamPipeline([warmup()], depth=2, batch=b)
    got = sum(real for _, (_, real) in pipe)
    pipe.close()
    assert got == 4 and pipe.stalls >= 1 and b.k == 8
