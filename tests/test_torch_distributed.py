"""The port's multi-device engine on the CPU against the JAX package's.

``CensusEngine(devices=default_devices(k, "cpu"))`` against ``repro``'s
``CensusEngine(mesh=default_mesh(k))`` at k in {1, 2, 4}: replicated,
1D-partitioned and 2D-partitioned runs, lock-step and async schedules,
both emits, both orients, megastep caps K in {1, 2, 8}, skewed
partitions and empty shards.  Every census equals ``repro``'s and the
serial Batagelj–Mrvar census bit for bit, on all three port backends
(``torch``/``hist``/``fused``; the reference runs ``jnp``, and once
``pallas-fused`` in interpret mode through its megastep).  The
deterministic stats are equal too; ``dispatches_total`` and
``stall_steps`` depend on timing under async, so there only the bounds
of ``tests/test_megastep.py`` are asserted.  All integers: the tolerance
is zero.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import census as ref_census
from repro.core import CensusEngine as RefEngine
from repro.core import build_plan as ref_build_plan
from repro.core import default_mesh
from repro.core import lpt_assign_heap as ref_lpt_assign_heap
from repro.core import pair_space as ref_pair_space
from repro.core import partition_graph as ref_partition_graph
from repro.core import triad_census_distributed as ref_census_distributed
from repro.core import triad_census_graph as ref_census_graph
from repro.core.digraph import CompactDigraph as RefDigraph
from repro_torch.core import engine as engine_mod
from repro_torch.core import partition
from repro_torch.core.planner import DESC_BYTES
from repro_torch.kernels import ops
from torch_partition_cases import SHARD_WINDOWS, windows_owner

torch.set_num_threads(1)

BACKENDS = ("torch", "hist", "fused")

#: the streamed runs' item budget: ~30 windows of the 70-vertex graph,
#: split over the shards (several megastep batches and ragged tails)
BUDGET = 240

#: stats that equal the reference's on every schedule
COMMON = ("ndev", "orient", "streamed", "max_items", "emit", "items",
          "desc_shape", "plan_upload_bytes", "peak_plan_bytes",
          "monolithic_plan_bytes", "graph_resident_bytes",
          "graph_replicated_bytes", "partitioned", "partition_shape",
          "shard_items", "schedule")
REPLICATED = COMMON + ("chunks", "chunk_shape", "chunk_items")
LOCKSTEP = REPLICATED + (
    "shard_steps", "idle_steps", "plan_upload_bytes_total",
    "plan_pad_bytes_total", "dispatches_total",
    "windows_per_dispatch_mean", "windows_per_dispatch_max",
    "dispatch_batch_limit", "pipeline_depth")
ASYNC = COMMON + ("chunks", "chunk_shape", "shard_steps", "idle_steps",
                  "plan_upload_bytes_total", "dispatch_batch_limit",
                  "pipeline_depth")


def pl_graph(n=70, deg=5, seed=13):
    return rt.scale_free_digraph(n=n, avg_degree=deg, exponent=2.2,
                                 mutual_p=0.3, seed=seed)


GRAPHS = {
    "pl70": pl_graph,
    "orkut": lambda: rt.paper_workload("orkut", 250, 12.0, seed=0),
}


@functools.lru_cache(maxsize=None)
def graph(name):
    return GRAPHS[name]()


@functools.lru_cache(maxsize=None)
def oracle(name):
    return rt.census_batagelj_mrvar(graph(name))


def to_reference(g):
    return RefDigraph(n=g.n, indptr=g.indptr.copy(), packed=g.packed.copy(),
                      num_arcs=g.num_arcs)


def mode_kwargs(mode, k):
    if mode == "replicated":
        return {}
    if mode == "1d":
        return dict(partition=True)
    return dict(partition_2d={1: (1, 1), 2: (1, 2), 4: (2, 2)}[k])


@functools.lru_cache(maxsize=None)
def reference(name, k, mode, schedule, emit, orient, max_items, cap=8,
              backend="jnp"):
    eng = RefEngine(mesh=default_mesh(k), backend=backend, emit=emit,
                    schedule=schedule, max_windows_per_dispatch=cap,
                    **mode_kwargs(mode, k))
    census = eng.run(to_reference(graph(name)), max_items=max_items,
                     orient=orient)
    return census, eng.stats


def port_run(name, k, mode, schedule, emit, orient, max_items, backend,
             cap=8, part=None):
    eng = rt.CensusEngine(devices=rt.default_devices(k, "cpu"),
                          backend=backend, emit=emit, schedule=schedule,
                          max_windows_per_dispatch=cap,
                          **mode_kwargs(mode, k))
    census = eng.run(graph(name), max_items=max_items, orient=orient,
                     part=part)
    return census, eng.stats


def assert_stats(got, want, fields):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


def assert_async_bounds(st):
    """The schedule-independent invariants of an async run
    (tests/test_megastep.py)."""
    windows = sum(st.shard_steps)
    assert st.chunks == windows == len(st.chunk_items)
    assert 1 <= st.windows_per_dispatch_max <= st.dispatch_batch_limit
    assert st.dispatches_total * st.dispatch_batch_limit >= windows
    assert st.dispatches_total <= windows
    assert st.windows_per_dispatch_mean == pytest.approx(
        windows / st.dispatches_total)
    assert st.plan_pad_bytes_total == st.plan_upload_bytes * (
        st.dispatch_batch_limit * st.dispatches_total - windows)
    assert st.stall_steps >= 0
    assert f"dispatches={st.dispatches_total}" in st.summary()


@pytest.mark.parametrize("max_items", [None, BUDGET])
@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_replicated_matches_reference(k, emit, orient, max_items):
    want, want_st = reference("pl70", k, "replicated", "async", emit,
                              orient, max_items)
    np.testing.assert_array_equal(want, oracle("pl70"))
    for backend in BACKENDS:
        got, st = port_run("pl70", k, "replicated", "async", emit, orient,
                           max_items, backend)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64
        assert_stats(st, want_st, REPLICATED)
        assert st.backend == backend and not st.partitioned
        # eager torch compiles nothing per step
        assert st.step_compiles == st.capacity_recompiles == 0


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("mode, k", [("1d", 1), ("1d", 2), ("1d", 4),
                                     ("2d", 2), ("2d", 4)])
def test_lockstep_matches_reference(mode, k, emit, orient):
    want, want_st = reference("pl70", k, mode, "lockstep", emit, orient,
                              BUDGET)
    np.testing.assert_array_equal(want, oracle("pl70"))
    for backend in BACKENDS:
        got, st = port_run("pl70", k, mode, "lockstep", emit, orient, BUDGET,
                           backend)
        np.testing.assert_array_equal(got, want)
        assert_stats(st, want_st, LOCKSTEP)


@pytest.mark.parametrize("cap, orient", [(1, "degree"), (2, "none"),
                                         (8, "none"), (8, "degree")])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("mode, k", [("1d", 1), ("1d", 2), ("1d", 4),
                                     ("2d", 4)])
def test_async_matches_reference(mode, k, emit, cap, orient):
    want, want_st = reference("pl70", k, mode, "async", emit, orient, BUDGET,
                              cap)
    np.testing.assert_array_equal(want, oracle("pl70"))
    # every backend at the default cap; the fused megastep at every cap
    for backend in BACKENDS if cap == 8 else ("fused",):
        got, st = port_run("pl70", k, mode, "async", emit, orient, BUDGET,
                           backend, cap)
        np.testing.assert_array_equal(got, want)
        assert_stats(st, want_st, ASYNC)
        # landing order is the pipeline's; the windows are the same
        assert sorted(st.chunk_items) == sorted(want_st.chunk_items)
        assert_async_bounds(st)
        if emit == "host":
            assert st.dispatch_batch_limit == 1
            assert st.dispatches_total == st.chunks


@pytest.mark.parametrize("mode, schedule", [
    ("replicated", "async"), ("1d", "lockstep"), ("1d", "async"),
    ("2d", "lockstep"), ("2d", "async")])
def test_unstreamed_and_other_graph(mode, schedule):
    """``max_items=None`` (one window per shard) on a SMALL_SIZES
    workload, both emits (a replicated run ignores the schedule)."""
    for emit in ("device", "host"):
        want, want_st = reference("orkut", 4, mode, schedule, emit,
                                  "degree", None)
        np.testing.assert_array_equal(want, oracle("orkut"))
        got, st = port_run("orkut", 4, mode, schedule, emit, "degree",
                           None, "fused")
        np.testing.assert_array_equal(got, want)
        fields = (ASYNC if schedule == "async"
                  else LOCKSTEP if mode != "replicated" else REPLICATED)
        if mode == "replicated":
            # the port counts the bytes a replicated run's dispatches
            # copied, where the JAX package leaves 0: under device
            # emission the descriptors and the valid-lane count, whose
            # anchor table each device builds
            fields = tuple(f for f in fields
                           if f != "plan_upload_bytes_total")
            per = (DESC_BYTES * st.desc_shape + 4 if emit == "device"
                   else st.plan_upload_bytes)
            assert st.plan_upload_bytes_total == (
                per * st.chunks * st.ndev) > 0
        assert_stats(st, want_st, fields)


def skewed_owner(g, num_shards, factor=4.0):
    """Shard 0 holds ``factor``x each other shard's pre-prune items; the
    rest are LPT-balanced (tests/test_megastep.py's skewed partition)."""
    space = rt.pair_space(g)
    costs = space.counts.astype(np.int64)
    order = np.argsort(-costs, kind="stable")
    target0 = int(costs.sum()) * factor / (factor + (num_shards - 1))
    k = int(np.searchsorted(np.cumsum(costs[order]), target0)) + 1
    owner = np.empty(space.num_pairs, np.int64)
    owner[order[:k]] = 0
    rest = order[k:]
    owner[rest] = 1 + ref_lpt_assign_heap(costs[rest], num_shards - 1)
    return owner


@pytest.mark.parametrize("layout", ["skewed", "one-shard"])
@pytest.mark.parametrize("schedule", ["lockstep", "async"])
@pytest.mark.parametrize("emit", ["device", "host"])
def test_prebuilt_partitions(layout, schedule, emit):
    """A skewed partition, and every pair on shard 0 (three empty
    shards), through ``part=`` on both engines."""
    g = graph("pl70")
    if layout == "skewed":
        owner = skewed_owner(g, 4)
    else:
        owner = np.zeros(rt.pair_space(g).num_pairs, np.int64)
    part = rt.partition_graph(num_shards=4, space=rt.pair_space(g),
                              owner=owner)
    ref_part = ref_partition_graph(num_shards=4,
                                   space=ref_pair_space(to_reference(g)),
                                   owner=owner)
    ref = RefEngine(mesh=default_mesh(4), backend="jnp", emit=emit,
                    partition=True, schedule=schedule)
    want = ref.run(to_reference(g), max_items=BUDGET, part=ref_part)
    np.testing.assert_array_equal(want, oracle("pl70"))
    for backend in BACKENDS:
        eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                              backend=backend, emit=emit, partition=True,
                              schedule=schedule)
        got = eng.run(g, max_items=BUDGET, part=part)
        np.testing.assert_array_equal(got, want)
        assert_stats(eng.stats, ref.stats,
                     ASYNC if schedule == "async" else LOCKSTEP)
    if layout == "one-shard":
        assert all(t == 0 for t in eng.stats.shard_steps[1:])


def test_empty_shards_never_enter_rotation(monkeypatch):
    """All pairs on shard 0 of 4 devices: the pipeline is built with ONE
    source, not four."""
    seen = []
    real = engine_mod.ShardStreamPipeline

    class Spy(real):
        def __init__(self, sources, **kw):
            sources = list(sources)
            seen.append(len(sources))
            super().__init__(sources, **kw)

    monkeypatch.setattr(engine_mod, "ShardStreamPipeline", Spy)
    g = graph("pl70")
    part = rt.partition_graph(
        num_shards=4, space=rt.pair_space(g),
        owner=np.zeros(rt.pair_space(g).num_pairs, np.int64))
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          backend="torch", partition=True)
    got = eng.run(g, max_items=100, part=part)
    np.testing.assert_array_equal(got, oracle("pl70"))
    assert seen == [1]


@pytest.mark.parametrize("cap", [2, 8])
def test_async_never_takes_the_lockstep_path(cap, monkeypatch):
    def poison(*a, **k):
        raise AssertionError("the async schedule took the lock-step path")

    monkeypatch.setattr(engine_mod.CensusEngine,
                        "_run_partitioned_lockstep", poison)
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          backend="fused", partition=True,
                          max_windows_per_dispatch=cap)
    np.testing.assert_array_equal(eng.run(graph("pl70"), max_items=BUDGET),
                                  oracle("pl70"))
    assert eng.stats.dispatch_batch_limit == cap


def test_megastep_dispatches_fewer_at_equal_windows():
    """Same windows, >= 2x fewer dispatches at K=8 than at K=1."""
    g = graph("pl70")
    part = rt.partition_graph(num_shards=4, space=rt.pair_space(g),
                              owner=skewed_owner(g, 4))
    disp, windows = {}, set()
    for cap in (1, 8):
        eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                              backend="torch", partition=True,
                              max_windows_per_dispatch=cap)
        eng.run(g, max_items=100, part=part)
        disp[cap] = eng.stats.dispatches_total
        windows.add(sum(eng.stats.shard_steps))
    assert len(windows) == 1 and disp[8] * 2 <= disp[1]


#: the reference's megastep compiled whole, as its engine runs it
ref_batch = jax.jit(ref_census.census_partials_desc_batch,
                    static_argnums=(7, 8, 9, 10))


def zero_past(words, real):
    """A copy of a (K, words) batch with every row past ``real`` zero,
    as the JAX package's batcher pads it."""
    out = np.array(words)
    out[real:] = 0
    return out


def ref_batch_partials(args, real, search_iters, desc_iters, orient,
                       prune_self):
    """The reference's per-window partials of the batch a port megastep
    was given (graph arrays, words, idx), its rows past ``real`` zero."""
    graph = [np.asarray(a) for a in args[:5]]
    hist, inter = ref_batch(*graph, zero_past(args[5], real),
                            np.asarray(args[6]), search_iters, desc_iters,
                            orient, prune_self)
    return np.asarray(hist), np.asarray(inter)


@functools.lru_cache(maxsize=None)
def partial_batch_case(orient):
    """pl70 over 4 shards of 1, 2, 3 and 5 windows, and the reference's
    async run of it (cap 8, so 5: the longest queue)."""
    g = graph("pl70")
    owner, max_items = windows_owner(rt.pair_space(g, orient=orient))
    ref_part = ref_partition_graph(
        num_shards=4, space=ref_pair_space(to_reference(g), orient=orient),
        owner=owner)
    ref = RefEngine(mesh=default_mesh(4), backend="jnp", partition=True,
                    schedule="async", max_windows_per_dispatch=8)
    want = ref.run(to_reference(g), max_items=max_items, part=ref_part)
    return owner, max_items, want, ref.stats


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_async_partial_batches_match_reference(orient, backend,
                                               monkeypatch):
    """Shards of 1, 2, 3 and 5 windows under cap 8: every shard but the
    longest ends on a partial batch.  Each megastep gets its buffer and
    its real row count, which counts the buffer's windows; its per-window
    partials equal the reference's megastep on the same windows, zero
    past the real rows; the census and the stats equal the reference
    engine's."""
    owner, max_items, want, want_st = partial_batch_case(orient)
    g = graph("pl70")
    part = rt.partition_graph(num_shards=4,
                              space=rt.pair_space(g, orient=orient),
                              owner=owner)
    calls, params = [], []
    make_step = engine_mod.desc_batch_partials_fn

    def spy(*a):
        params.extend(a[1:])  # search_iters, desc_iters, orient, prune_self
        step = make_step(*a)

        def run(*args, real=None):
            out = step(*args, real=real)
            calls.append((args, real, out))
            return out
        return run

    monkeypatch.setattr(engine_mod, "desc_batch_partials_fn", spy)
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          backend=backend, partition=True, schedule="async",
                          max_windows_per_dispatch=8)
    got = eng.run(g, max_items=max_items, part=part)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle("pl70"))
    st = eng.stats
    assert st.shard_steps == list(SHARD_WINDOWS)
    assert_stats(st, want_st, ASYNC)
    assert sorted(st.chunk_items) == sorted(want_st.chunk_items)
    assert_async_bounds(st)
    assert len(calls) == st.dispatches_total
    assert sum(real for _, real, _ in calls) == sum(SHARD_WINDOWS)
    assert params[2] == orient
    for args, real, (hist, inter) in calls:
        words = args[5].numpy()
        assert words.shape[0] == st.dispatch_batch_limit == 5
        # the real rows are the buffer's windows, in front
        assert (words[:real, 0] > 0).all() and not words[real:].any()
        want_h, want_i = ref_batch_partials(args, real, *params)
        np.testing.assert_array_equal(hist.numpy(), want_h)
        np.testing.assert_array_equal(inter.numpy(), want_i)


def shard_batch(shard=3):
    """The windows of one shard of pl70's 1, 2, 3, 5-window partition
    (shard 3: 5 windows) as a (5, words) batch, with the shard's arrays,
    the index array and the schedule."""
    space = rt.pair_space(graph("pl70"))
    owner, max_items = windows_owner(space)
    part = rt.partition_graph(num_shards=4, space=space, owner=owner)
    sched = rt.ShardSchedule([sh.space for sh in part.shards], max_items, 4)
    arrays = [a[shard] for a in rt.stacked_device_arrays(part.shards)]
    rows = np.stack([sched.descriptors(shard, j).device_words()
                     for j in range(sched.steps_for(shard))])
    idx = np.arange(sched.chunk_shape, dtype=np.int32)
    return arrays, rows, idx, (space.search_iters, sched.desc_iters)


@pytest.mark.parametrize("real", [1, 2, 4])
def test_megastep_never_reads_rows_past_real(real):
    """Rows past ``real`` holding other windows, as an earlier batch
    leaves the device buffer: the plain megastep and the fused wrapper
    (its plain version on the CPU) give the reference's partials of the
    zero-padded batch, zero past ``real``."""
    arrays, rows, idx, iters = shard_batch()
    stale = rows.copy()
    stale[real:] = rows[::-1][real:]
    assert stale[real:, 0].all()
    want = ref_batch(*arrays, zero_past(rows, real), idx, *iters, "none",
                     True)
    args = ([torch.from_numpy(a) for a in arrays], torch.from_numpy(stale),
            torch.from_numpy(idx), *iters, "none", True)
    for fn in (rt.census_partials_desc_batch,
               ops.fused_census_desc_partials_batch):
        got = fn(*args[0], *args[1:], real=real)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not got[0][real:].any() and not got[1][real:].any()


@pytest.mark.parametrize("bad", [0, -1, 6, 2.5, True])
def test_megastep_refuses_bad_real_counts(bad):
    arrays, rows, idx, iters = shard_batch()
    for fn in (rt.census_partials_desc_batch,
               ops.fused_census_desc_partials_batch):
        with pytest.raises(ValueError, match="real windows"):
            fn(*(torch.from_numpy(a) for a in arrays),
               torch.from_numpy(rows), torch.from_numpy(idx), *iters,
               "none", True, real=bad)


def test_pipeline_feeds_real_rows():
    """``_Pipeline.submit(..., real=r)`` hands the launch the whole
    buffer and ``r``; without ``real`` the launch takes the buffer
    alone."""
    pipe = engine_mod._Pipeline(torch.device("cpu"), (4, 3), rows=4)
    seen = []
    partials = (torch.ones((4, 64), dtype=torch.int32),
                torch.ones((4, 3), dtype=torch.int32))

    def launch(words, *real):
        seen.append((tuple(words.shape), real))
        return partials

    words = np.arange(12, dtype=np.int32).reshape(4, 3)
    hist, inter = pipe.land(pipe.submit(words, launch, real=2))
    pipe.submit(words, launch)
    assert seen == [((4, 3), (2,)), ((4, 3), ())]
    assert hist.shape == (4, 64) and inter.shape == (4, 3)


def test_megastep_matches_pallas_fused_in_interpret_mode():
    """The reference's megastep with ``pallas-fused`` (its Pallas kernel
    in interpret mode under the jitted scan) against the port's fused
    megastep."""
    g = pl_graph(n=40, deg=4, seed=8)
    ref = RefEngine(mesh=default_mesh(4), backend="pallas-fused",
                    partition=True, schedule="async",
                    max_windows_per_dispatch=4)
    want = ref.run(to_reference(g), max_items=80)
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          backend="fused", partition=True,
                          max_windows_per_dispatch=4)
    got = eng.run(g, max_items=80)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g))
    assert_stats(eng.stats, ref.stats, ASYNC)


@pytest.mark.parametrize("schedule", ["lockstep", "async"])
def test_progress_calls_match(schedule):
    """Lock-step progress is per step, in order, as the reference's;
    async progress counts every window once (landing order)."""
    g = graph("pl70")
    got, want = [], []
    rt.CensusEngine(devices=rt.default_devices(2, "cpu"), backend="torch",
                    partition=True, schedule=schedule).run(
        g, max_items=BUDGET, progress=lambda *a: got.append(a))
    RefEngine(mesh=default_mesh(2), partition=True,
              schedule=schedule).run(
        to_reference(g), max_items=BUDGET, progress=lambda *a: want.append(a))
    if schedule == "lockstep":
        assert got == want
    else:
        assert sorted(a[2] for a in got) == sorted(a[2] for a in want)
        assert [a[:2] for a in got] == [(i, len(want))
                                        for i in range(len(want))]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_distributed_entry_points(k):
    g = graph("orkut")
    plan = rt.build_plan(g, pad_to=k, orient="degree")
    ref_plan = ref_build_plan(to_reference(g), pad_to=k, orient="degree")
    devices = rt.default_devices(k, "cpu")
    for backend in BACKENDS:
        got = rt.triad_census_distributed(plan, devices, backend=backend)
        np.testing.assert_array_equal(
            got, ref_census_distributed(ref_plan, default_mesh(k)))
    eng = rt.CensusEngine(devices=devices, emit="host")
    ref = RefEngine(mesh=default_mesh(k), emit="host")
    np.testing.assert_array_equal(eng.run_plan(plan), ref.run_plan(ref_plan))
    assert_stats(eng.stats, ref.stats, REPLICATED)
    for kw in (dict(), dict(partition=True, schedule="lockstep")):
        got = rt.triad_census_graph(g, devices, max_items=3000, **kw)
        want = ref_census_graph(to_reference(g), default_mesh(k),
                                max_items=3000, **kw)
        np.testing.assert_array_equal(got, want)
    if k > 1:
        ragged = dataclasses.replace(plan, item_sp=plan.item_sp[:-1],
                                     item_pv=plan.item_pv[:-1])
        with pytest.raises(ValueError, match="multiple"):
            eng.run_plan(ragged)


def test_default_devices():
    devs = rt.default_devices(3, "cpu")
    assert [d.index for d in devs] == [0, 1, 2]
    assert all(d.device == torch.device("cpu") and d.stream is None
               for d in devs)
    assert len(rt.default_devices(device="cpu")) == 1
    with pytest.raises(ValueError):
        rt.default_devices(0, "cpu")


def test_no_cuda_device_raises(monkeypatch):
    """No silent move to the CPU: a listed CUDA device that is missing
    raises, as ``resolve_device`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.default_devices(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.CensusEngine(devices=["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_mod.resolve_device("cuda:1")


def test_rejects_bad_options():
    cpu2 = rt.default_devices(2, "cpu")
    with pytest.raises(ValueError, match="devices"):
        rt.CensusEngine(device="cpu", partition=True)
    with pytest.raises(ValueError):
        rt.CensusEngine(device="cpu", devices=cpu2)
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2, partition_2d=(2, 2))
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2, partition_2d=(0, 2))
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2, partition=True, pipeline_depth=0)
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2, partition=True,
                        max_windows_per_dispatch=0)
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2, schedule="barrier")
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=[])
    eng = rt.CensusEngine(devices=cpu2, partition=True, pipeline_depth=3)
    assert eng.ndev == 2 and eng.pipeline_depth == 3
    g = graph("pl70")
    with pytest.raises(ValueError):
        eng.run_plan(rt.build_plan(g, pad_to=2))
    # sessions of multi-device engines open (tests/test_torch_multidevice_
    # session.py holds them to the reference); bad session options raise
    assert isinstance(eng.session(g), rt.PartitionedEngineSession)
    assert isinstance(rt.CensusEngine(devices=cpu2).session(g),
                      rt.EngineSession)
    with pytest.raises(ValueError):
        eng.session(g, auto_rebalance_threshold=0.5)
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2).session(
            g, auto_rebalance_threshold=1.2)
    with pytest.raises(ValueError):
        rt.CensusEngine(devices=cpu2).run(
            g, part=partition.partition_graph(g, num_shards=2))
    with pytest.raises(ValueError):
        eng.run(g, part=partition.partition_graph(g, num_shards=3))
    with pytest.raises(ValueError):
        eng.run(g, schedule="barrier")


def test_pipeline_depth_surfaced():
    eng = rt.CensusEngine(devices=rt.default_devices(2, "cpu"),
                          backend="torch", partition=True, pipeline_depth=3)
    np.testing.assert_array_equal(eng.run(graph("pl70"), max_items=80),
                                  oracle("pl70"))
    assert eng.stats.pipeline_depth == 3
    assert eng.stats.host_partition_seconds > 0
