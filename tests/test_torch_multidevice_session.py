"""The port's sessions of a multi-device engine against the JAX package's.

``CensusEngine(devices=default_devices(k, "cpu")).session(...)`` against
``repro``'s ``CensusEngine(mesh=default_mesh(k)).session(...)``:
replicated sessions at k in {2, 4}, ``PartitionedEngineSession`` at k in
{1, 2, 4} and ``PartitionedEngineSession2D`` at (2, 2), (1, 2) and
(2, 1), both emits, ``index`` on and off (orient ``none`` with the
index, ``degree`` without).  Both get the same graph and the same delta
stream; after the baseline census and after every update the census and
the EngineStats fields equal the reference's, the census equals the
serial Batagelj–Mrvar oracle, and a partitioned session's
``load_max_over_mean`` equals the reference's.  Also: an update that
touches one shard's pairs dispatches on that shard only, ``set_graph``,
``rebalance`` and ``auto_rebalance_threshold``, and 2D session tiles
whose pairs keep one item, at budgets of 1–5 items.  The reference runs
its jitted ``jnp`` steps; the port its ``fused`` backend (the plain
version on the CPU).  All integers: the tolerance is zero.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import CensusEngine as RefEngine
from repro.core import default_mesh
from repro.core.digraph import CompactDigraph as RefDigraph
from repro_torch.core import engine as engine_mod

torch.set_num_threads(1)

#: the sessions' item budget: several windows per shard on the graph
BUDGET = 240

#: stats fields the two sessions must agree on, step by step
STATS_FIELDS = ("ndev", "orient", "streamed", "max_items", "chunks",
                "chunk_shape", "items", "chunk_items", "full_items",
                "affected_pairs", "desc_shape", "plan_upload_bytes",
                "peak_plan_bytes", "monolithic_plan_bytes",
                "graph_resident_bytes", "graph_replicated_bytes", "emit",
                "indexed", "partitioned", "partition_shape", "shard_items",
                "retries", "failovers", "retired_devices")

#: layout -> (engine keyword arguments, logical devices)
LAYOUTS = {
    "replicated-2": (dict(), 2),
    "replicated-4": (dict(), 4),
    "1d-1": (dict(partition=True), 1),
    "1d-2": (dict(partition=True), 2),
    "1d-4": (dict(partition=True), 4),
    "2d-2x2": (dict(partition_2d=(2, 2)), 4),
    "2d-1x2": (dict(partition_2d=(1, 2)), 2),
    "2d-2x1": (dict(partition_2d=(2, 1)), 2),
}


def pl_graph(n=70, deg=5, seed=13):
    return rt.scale_free_digraph(n=n, avg_degree=deg, exponent=2.2,
                                 mutual_p=0.3, seed=seed)


def to_reference(g):
    return RefDigraph(n=g.n, indptr=g.indptr.copy(), packed=g.packed.copy(),
                      num_arcs=g.num_arcs)


def delta_stream(g, seed):
    """An empty delta, a random one, a deletion-heavy one and one growing
    a row past the largest degree, as (add_src, add_dst, del_src,
    del_dst)."""
    rng = np.random.default_rng(seed)
    empty = np.zeros(0, np.int64)
    out = [(empty, empty, empty, empty),
           (rng.integers(0, g.n, 6), rng.integers(0, g.n, 6),
            rng.integers(0, g.n, 6), rng.integers(0, g.n, 6))]
    g, _ = rt.apply_delta(g, *out[-1])
    src, dst = np.nonzero(rt.to_dense(g))
    take = rng.random(src.shape[0]) < 0.3
    out.append((rng.integers(0, g.n, 2), rng.integers(0, g.n, 2),
                src[take], dst[take]))
    g, _ = rt.apply_delta(g, *out[-1])
    hub = int(rng.integers(0, g.n))
    spokes = rng.choice(g.n, int(g.degrees.max()) + 3, replace=False)
    out.append((np.full(spokes.shape[0], hub), spokes, empty, empty))
    return out


@functools.lru_cache(maxsize=None)
def graph():
    return pl_graph()


@functools.lru_cache(maxsize=None)
def stream():
    return delta_stream(graph(), seed=5)


@functools.lru_cache(maxsize=None)
def oracle_steps():
    out = [rt.census_batagelj_mrvar(graph())]
    g = graph()
    for delta in stream():
        g, _ = rt.apply_delta(g, *delta)
        out.append(rt.census_batagelj_mrvar(g))
    return out


def drive(session):
    """Census then every delta of the stream: per step (census, stats,
    load_max_over_mean or None)."""
    load = lambda: getattr(session, "load_max_over_mean", None)  # noqa: E731
    steps = [(session.census(), session.stats, load())]
    for delta in stream():
        steps.append((session.update(*delta), session.stats, load()))
    return steps


@functools.lru_cache(maxsize=None)
def reference(layout, emit, index):
    kw, k = LAYOUTS[layout]
    orient = "none" if index else "degree"
    eng = RefEngine(mesh=default_mesh(k), emit=emit, **kw)
    with eng.session(to_reference(graph()), orient=orient,
                     max_items=BUDGET, index=index) as s:
        return drive(s)


def port_session(layout, emit, index, backend="fused", **extra):
    kw, k = LAYOUTS[layout]
    orient = "none" if index else "degree"
    eng = rt.CensusEngine(devices=rt.default_devices(k, "cpu"),
                          backend=backend, emit=emit, **kw)
    return eng.session(graph(), orient=orient, max_items=BUDGET,
                       index=index, **extra)


def assert_steps_equal(got, want):
    assert len(got) == len(want)
    for step, ((c, st, load), (rc, rst, rload), oracle) in enumerate(
            zip(got, want, oracle_steps())):
        np.testing.assert_array_equal(c, rc, err_msg=f"step {step}")
        np.testing.assert_array_equal(c, oracle, err_msg=f"step {step}")
        assert c.dtype == np.int64
        for f in STATS_FIELDS:
            assert getattr(st, f) == getattr(rst, f), (step, f)
        assert load == rload, step


@pytest.mark.parametrize("index", [True, False])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_session_matches_reference(layout, emit, index):
    want = reference(layout, emit, index)
    with port_session(layout, emit, index) as s:
        kind = (engine_mod.PartitionedEngineSession2D
                if layout.startswith("2d")
                else engine_mod.PartitionedEngineSession
                if layout.startswith("1d") else engine_mod.EngineSession)
        assert type(s) is kind
        got = drive(s)
    assert_steps_equal(got, want)
    # eager torch compiles nothing per step
    assert all(st.step_compiles == st.capacity_recompiles == 0
               for _, st, _ in got)


@pytest.mark.parametrize("layout", ["replicated-2", "1d-2", "2d-2x2"])
@pytest.mark.parametrize("backend", ["torch", "hist"])
def test_other_backends_match(layout, backend):
    want = reference(layout, "device", True)
    with port_session(layout, "device", True, backend=backend) as s:
        got = drive(s)
    assert_steps_equal(got, want)


def test_replicated_chunk_shape_is_padded_to_devices():
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"))
    with eng.session(graph(), max_items=BUDGET + 1) as s:
        assert s.chunk_shape % 4 == 0 and s.chunk_shape >= BUDGET + 1
        np.testing.assert_array_equal(s.census(), oracle_steps()[0])
        assert s.stats.ndev == 4 and not s.stats.partitioned


def island_graph():
    """A 30-vertex component on 0..29 and isolated vertices 30..33."""
    base = pl_graph(n=30, deg=3, seed=3)
    src, dst = np.nonzero(rt.to_dense(base))
    return rt.from_edges(src, dst, n=34)


def test_one_shard_delta_other_shards_dispatch_nothing(monkeypatch):
    """A delta confined to one shard's pairs uploads and launches on that
    shard's device ONLY (every launch is recorded by shard)."""
    g = island_graph()
    session = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                              partition=True).session(g)
    session.census()
    # a fresh 3-vertex component: all of its pairs join ONE shard
    got = session.update([30, 30, 31], [31, 32, 32])
    g, _ = rt.apply_delta(g, [30, 30, 31], [31, 32, 32])
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g))
    new_keys = [30 * 34 + 31, 30 * 34 + 32, 31 * 34 + 32]
    owners = {s for s in range(4)
              if np.isin(new_keys, session._keys[s]).any()}
    assert len(owners) == 1
    (owner,) = owners
    # flip one arc inside the component: every affected pair is owner's
    calls = []
    real = engine_mod.PartitionedEngineSession._launch

    def spy(self, s, words):
        calls.append(s)
        return real(self, s, words)

    monkeypatch.setattr(engine_mod.PartitionedEngineSession, "_launch", spy)
    got = session.update([32], [30])
    g, _ = rt.apply_delta(g, [32], [30])
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g))
    assert calls and set(calls) == {owner}
    nz = [i for i, x in enumerate(session.stats.shard_items) if x]
    assert nz == [owner] and session.stats.items > 0
    # an arc already present changes nothing: no launch at all
    calls.clear()
    session.update([32], [30])
    assert calls == [] and session.stats.chunks == 0


def churn(g, rounds, seed):
    """Deltas that keep adding arcs around a few vertices."""
    rng = np.random.default_rng(seed)
    hubs = rng.choice(g.n, 3, replace=False)
    return [(np.repeat(hubs, 6), rng.integers(0, g.n, 18),
             rng.integers(0, g.n, 2), rng.integers(0, g.n, 2))
            for _ in range(rounds)]


@pytest.mark.parametrize("layout", ["1d-4", "2d-2x2"])
def test_set_graph_and_rebalance_match_reference(layout):
    kw, k = LAYOUTS[layout]
    g = graph()
    deltas = churn(g, 4, seed=9)
    other = pl_graph(seed=21)
    ref = RefEngine(mesh=default_mesh(k), **kw).session(
        to_reference(g), max_items=BUDGET)
    port = rt.CensusEngine(devices=rt.default_devices(k, "cpu"),
                           **kw).session(g, max_items=BUDGET)
    for s in (ref, port):
        s.census()
    for delta in deltas:
        np.testing.assert_array_equal(port.update(*delta),
                                      ref.update(*delta))
        assert port.load_max_over_mean == ref.load_max_over_mean
        assert port.stats.shard_items == ref.stats.shard_items
    for s in (ref, port):
        s.rebalance()
    assert port.rebalances == ref.rebalances == 1
    assert port.load_max_over_mean == ref.load_max_over_mean
    np.testing.assert_array_equal(port.update(*deltas[0]),
                                  ref.update(*deltas[0]))
    assert port.stats.shard_items == ref.stats.shard_items
    for s in (ref, port):
        s.set_graph(to_reference(other) if s is ref else other)
    assert port.counts is None and ref.counts is None
    assert port.load_max_over_mean == ref.load_max_over_mean
    np.testing.assert_array_equal(port.census(), ref.census())
    np.testing.assert_array_equal(port.census(),
                                  rt.census_batagelj_mrvar(other))
    assert port.stats.shard_items == ref.stats.shard_items
    with pytest.raises(ValueError, match="pinned"):
        port.set_graph(pl_graph(n=50))
    port.close()
    ref.close()


@pytest.mark.parametrize("threshold", [1.05, 1.3])
def test_auto_rebalance_matches_reference(threshold):
    g = graph()
    deltas = churn(g, 5, seed=4)
    ref = RefEngine(mesh=default_mesh(4), partition=True).session(
        to_reference(g), max_items=BUDGET,
        auto_rebalance_threshold=threshold)
    port = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                           partition=True).session(
        g, max_items=BUDGET, auto_rebalance_threshold=threshold)
    np.testing.assert_array_equal(port.census(), ref.census())
    h = g
    for delta in deltas:
        h, _ = rt.apply_delta(h, *delta)
        got = port.update(*delta)
        np.testing.assert_array_equal(got, ref.update(*delta))
        np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(h))
        assert port.rebalances == ref.rebalances
        assert port.load_max_over_mean == ref.load_max_over_mean
        assert port.load_max_over_mean <= threshold
    if threshold < 1.1:
        assert port.rebalances >= 1


def test_session_validation():
    devices = rt.default_devices(2, "cpu")
    g = pl_graph(n=20)
    with pytest.raises(ValueError, match="auto_rebalance_threshold"):
        rt.CensusEngine(devices=devices, partition=True).session(
            g, auto_rebalance_threshold=0.5)
    with pytest.raises(ValueError, match="partition=True"):
        rt.CensusEngine(devices=devices).session(
            g, auto_rebalance_threshold=1.2)
    with pytest.raises(ValueError, match="max_items"):
        rt.CensusEngine(devices=devices, partition=True).session(
            g, max_items=0)
    with pytest.raises(ValueError, match="mesh_shape"):
        engine_mod.PartitionedEngineSession2D(
            rt.CensusEngine(devices=devices, partition=True), g,
            mesh_shape=(2, 2))


def star_with_pendants(k=12):
    """Hub 0 with leaves 1..k, each leaf with a pendant k+i: every
    leaf–pendant pair keeps one item after pruning."""
    leaves = np.arange(1, k + 1)
    return rt.from_edges(np.concatenate([np.zeros(k, np.int64), leaves]),
                         np.concatenate([leaves, leaves + k]),
                         n=2 * k + 1)


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("max_items", [1, 2, 3, 4, 5])
def test_2d_tiles_one_item_pairs_tiny_budgets(max_items, emit):
    """2D session tiles hold pairs with a single in-slice item; the
    session's descriptor capacity rests on the window iterator, not on
    the two-items-per-pair bound (every window stays inside
    ``desc_shape``)."""
    g = star_with_pendants()
    delta = ([0, 3], [13, 20], [2], [14])
    h, _ = rt.apply_delta(g, *delta)
    ref = RefEngine(mesh=default_mesh(4), partition_2d=(2, 2),
                    emit=emit).session(to_reference(g), max_items=max_items)
    port = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                           partition_2d=(2, 2), emit=emit).session(
        g, max_items=max_items)
    np.testing.assert_array_equal(port.census(), ref.census())
    np.testing.assert_array_equal(port.stats.chunk_items,
                                  ref.stats.chunk_items)
    got = port.update(*delta)
    np.testing.assert_array_equal(got, ref.update(*delta))
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(h))
    for f in STATS_FIELDS:
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    if emit == "device":
        assert port.desc_shape <= port.chunk_shape // 2 + 1
