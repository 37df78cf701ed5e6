"""The port's resident census session against the JAX package's.

``CensusEngine(device="cpu").session(...)`` and ``repro``'s
``CensusEngine(mesh=None).session(...)`` are given the same graph and the
same delta stream (an empty delta, a random one, a deletion-heavy one and
one that grows a row past the initial largest degree).  After the
baseline census and after every update the census and the EngineStats
fields equal the reference's, and the census equals the serial
Batagelj–Mrvar oracle — for 3 backends × 2 orients × 2 emits ×
``index=True/False`` and budgets from one dispatch down to 16 items
(down to 1 item on the one-item-pair graph).
``repro``'s sessions run their jitted ``jnp`` steps (its backends are
bit-identical by its own tests) and, in one test, its Pallas kernels in
interpret mode.  Everything is integer: the tolerance is zero.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import CensusEngine as RefEngine
from repro.core import digraph as ref_digraph

torch.set_num_threads(1)

#: stats fields the two sessions must agree on, step by step
STATS_FIELDS = ("orient", "streamed", "max_items", "chunks", "chunk_shape",
                "items", "chunk_items", "full_items", "affected_pairs",
                "desc_shape", "plan_upload_bytes", "peak_plan_bytes",
                "monolithic_plan_bytes", "graph_resident_bytes",
                "graph_replicated_bytes", "emit", "indexed")


def arcs_of(g):
    return np.nonzero(rt.to_dense(g))


def delta_stream(g, seed, steps=4):
    """Deltas as (add_src, add_dst, del_src, del_dst): empty, random,
    deletion-heavy, and one growing a row past the largest degree."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(steps):
        kind = step % 4
        empty = np.zeros(0, np.int64)
        if kind == 0:
            delta = (empty, empty, empty, empty)
        elif kind == 1:
            delta = (rng.integers(0, g.n, 6), rng.integers(0, g.n, 6),
                     rng.integers(0, g.n, 6), rng.integers(0, g.n, 6))
        elif kind == 2:
            src, dst = arcs_of(g)
            take = rng.random(src.shape[0]) < 0.4
            delta = (rng.integers(0, g.n, 2), rng.integers(0, g.n, 2),
                     src[take], dst[take])
        else:
            hub = int(rng.integers(0, g.n))
            grow = int(g.degrees.max()) + 3
            spokes = rng.choice(g.n, min(grow, g.n), replace=False)
            delta = (np.full(spokes.shape[0], hub), spokes, empty, empty)
        out.append(delta)
        g, _ = rt.apply_delta(g, *delta)
    return out


def random_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    np.fill_diagonal(a, False)
    return np.nonzero(a) + (n,)


def star_with_pendants(k=12):
    """Hub 0 with leaves 1..k, each leaf with a pendant k+i: every
    leaf–pendant pair keeps one item after pruning."""
    leaves = np.arange(1, k + 1)
    return (np.concatenate([np.zeros(k, np.int64), leaves]),
            np.concatenate([leaves, leaves + k]), 2 * k + 1)


GRAPHS = {
    "random40": lambda: random_graph(40, 0.1, seed=0),
    "orkut60": lambda: tuple(
        arcs_of(rt.paper_workload("orkut", 60, 8.0, seed=0))) + (60,),
    "star": star_with_pendants,
}


@functools.lru_cache(maxsize=None)
def arcs(name):
    return GRAPHS[name]()


@functools.lru_cache(maxsize=None)
def stream(name, seed=1):
    src, dst, n = arcs(name)
    return tuple(delta_stream(rt.from_edges(src, dst, n=n), seed))


@functools.lru_cache(maxsize=None)
def oracle_steps(name):
    """The oracle census before and after each delta of the stream."""
    src, dst, n = arcs(name)
    g = rt.from_edges(src, dst, n=n)
    out = [rt.census_batagelj_mrvar(g)]
    for delta in stream(name):
        g, _ = rt.apply_delta(g, *delta)
        out.append(rt.census_batagelj_mrvar(g))
    return out


def drive(session, deltas):
    """Baseline census, then each update: [(census, stats), ...]."""
    steps = [(session.census(), session.stats)]
    for delta in deltas:
        steps.append((session.update(*delta), session.stats))
    return steps


@functools.lru_cache(maxsize=None)
def reference(name, orient, emit, index, max_items, backend="jnp"):
    src, dst, n = arcs(name)
    eng = RefEngine(mesh=None, backend=backend, emit=emit)
    session = eng.session(ref_digraph.from_edges(src, dst, n=n),
                          orient=orient, max_items=max_items, index=index)
    return drive(session, stream(name))


def port(name, backend, orient, emit, index, max_items):
    src, dst, n = arcs(name)
    eng = rt.CensusEngine(device="cpu", backend=backend, emit=emit)
    session = eng.session(rt.from_edges(src, dst, n=n), orient=orient,
                          max_items=max_items, index=index)
    steps = drive(session, stream(name))
    assert eng.stats is session.stats
    return session, steps


def assert_steps_equal(name, got, want):
    assert len(got) == len(want)
    for k, ((census, st), (ref_census, ref_st)) in enumerate(zip(got,
                                                                want)):
        np.testing.assert_array_equal(census, ref_census)
        np.testing.assert_array_equal(census, oracle_steps(name)[k])
        assert census.dtype == np.int64
        for field in STATS_FIELDS:
            assert getattr(st, field) == getattr(ref_st, field), \
                (k, field)
        assert st.step_compiles == st.capacity_recompiles == 0
        assert st.plan_host_seconds >= 0


@pytest.mark.parametrize("name, max_items", [
    ("random40", None), ("random40", 16), ("orkut60", 64)])
@pytest.mark.parametrize("index", [True, False])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("backend", ["torch", "hist", "fused"])
def test_session_matches_reference(backend, orient, emit, index, name,
                                   max_items):
    _, got = port(name, backend, orient, emit, index, max_items)
    assert_steps_equal(name, got, reference(name, orient, emit, index,
                                            max_items))
    assert all(st.backend == backend for _, st in got)


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("backend, ref_backend", [
    ("hist", "pallas"), ("fused", "pallas-fused")])
def test_session_matches_reference_pallas(backend, ref_backend, emit):
    """The reference session through its Pallas kernels (interpret
    mode), one dispatch per recount."""
    name = "random40"
    _, got = port(name, backend, "degree", emit, True, None)
    assert_steps_equal(name, got, reference(name, "degree", emit, True,
                                            None, ref_backend))


@pytest.mark.parametrize("max_items", [1, 3, 5])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_one_item_pairs_at_tiny_budgets(orient, emit, max_items):
    """Descriptor capacity: a star with pendant paths (many pairs with
    one post-prune item) at budgets of 1–5 items.  The session's
    capacity is capped at ``budget // 2 + 1`` descriptors; windows stop
    at that many pairs, and every recount stays exact."""
    session, got = port("star", "torch", orient, emit, True, max_items)
    assert_steps_equal("star", got, reference("star", orient, emit, True,
                                              max_items))
    if emit == "device":
        assert session.desc_shape == max_items // 2 + 1


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("backend", ["torch", "hist"])
def test_row_grown_past_initial_degree(backend, emit):
    """Search depth: a ring (largest degree 2) whose vertex 0 gains 50
    neighbours.  The plain versions search to ``ceil(log2 n)``, pinned
    at open, not to the initial graph's depth."""
    n = 64
    ring = np.arange(n)
    g = rt.from_edges(ring, (ring + 1) % n, n=n)
    session = rt.CensusEngine(device="cpu", backend=backend).session(
        g, max_items=16, emit=emit, orient="degree")
    assert session.search_iters == 6
    assert rt.pair_space(g).search_iters == 2
    session.census()
    add = (np.zeros(50, np.int64), np.arange(5, 55))
    got = session.update(*add)
    g2, _ = rt.apply_delta(g, *add)
    assert int(g2.degrees.max()) == 52
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g2))
    ref = RefEngine(mesh=None, emit=emit).session(
        ref_digraph.from_edges(ring, (ring + 1) % n, n=n), max_items=16,
        orient="degree")
    ref.census()
    np.testing.assert_array_equal(got, ref.update(*add))


def test_set_graph_rebases():
    src, dst, n = arcs("random40")
    g1 = rt.from_edges(src, dst, n=n)
    g2 = rt.from_edges(*random_graph(n, 0.2, seed=7))
    session = rt.CensusEngine(device="cpu").session(g1, max_items=32)
    ref = RefEngine(mesh=None).session(
        ref_digraph.from_edges(src, dst, n=n), max_items=32)
    session.census()
    ref.census()
    session.set_graph(g2)
    ref.set_graph(ref_digraph.from_edges(*random_graph(n, 0.2, seed=7)))
    assert session.counts is None and session.last_delta is None
    assert session.graph is g2
    np.testing.assert_array_equal(session.census(), ref.census())
    np.testing.assert_array_equal(session.counts,
                                  rt.census_batagelj_mrvar(g2))
    for field in STATS_FIELDS:
        assert getattr(session.stats, field) == getattr(ref.stats, field)
    with pytest.raises(ValueError):
        session.set_graph(rt.from_edges([0], [1], n=n + 1))


def test_update_requires_baseline():
    session = rt.CensusEngine(device="cpu").session(
        rt.from_edges([0], [1], n=3))
    with pytest.raises(RuntimeError, match="census"):
        session.update([1], [2])


@pytest.mark.parametrize("emit", ["device", "host"])
def test_empty_delta_dispatches_nothing(emit):
    from repro_torch.kernels import ops
    src, dst, n = arcs("random40")
    session = rt.CensusEngine(device="cpu", backend="fused").session(
        rt.from_edges(src, dst, n=n), emit=emit, max_items=32)
    c0 = session.census()
    calls = []
    step = session._step
    session._step = lambda *a: calls.append(1) or step(*a)
    ops.reset_launch_counts()
    got = session.update([int(src[0])], [int(dst[0])])   # already present
    np.testing.assert_array_equal(got, c0)
    assert session.last_delta.num_changed == 0
    assert calls == [] and session.stats.chunks == 0
    assert session.stats.items == 0 and session.stats.affected_pairs == 0
    assert session.stats.full_items > 0
    assert ops.fused_census_desc_partials.launches == 0
    assert ops.fused_census_partials.launches == 0
    session.update([0], [int(n - 1)] if src[0] else [1])
    assert calls and session.stats.chunks == len(calls)


def test_close_and_context_manager():
    g = rt.from_edges([0, 1], [1, 2], n=4)
    with rt.CensusEngine(device="cpu").session(g) as session:
        session.census()
    with pytest.raises(RuntimeError, match="closed"):
        session.census()
    with pytest.raises(RuntimeError, match="closed"):
        session.update([0], [3])
    session.close()                      # idempotent


def test_session_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.CensusEngine().session(rt.from_edges([0], [1], n=3))


def test_session_rejects_what_reference_rejects():
    g = rt.from_edges([0], [1], n=3)
    eng = rt.CensusEngine(device="cpu")
    with pytest.raises(ValueError):
        eng.session(g, auto_rebalance_threshold=1.2)
    with pytest.raises(ValueError):
        eng.session(g, max_items=0)
    with pytest.raises(ValueError):
        eng.session(g, emit="both")
    with pytest.raises(ValueError):
        eng.session(g, orient="random")
