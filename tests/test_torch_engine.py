"""The port's CensusEngine on the CPU against the JAX package's.

For every backend × orient × emit × ``max_items`` budget (monolithic,
mid-size windows, and budgets of 3 items that split every pair across
windows), the census and the EngineStats fields equal those of
``repro``'s ``CensusEngine(mesh=None, backend="jnp")`` on the identical
graph, and the census equals the serial Batagelj–Mrvar oracle.  All
integers: the tolerance is zero.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import CensusEngine as RefEngine
from repro.core import build_plan as ref_build_plan
from repro.core import triad_census as ref_triad_census
from repro.core.digraph import CompactDigraph as RefDigraph
from repro_torch import convert

torch.set_num_threads(1)

STATS_FIELDS = ("orient", "streamed", "max_items", "chunks", "chunk_shape",
                "items", "chunk_items", "desc_shape", "plan_upload_bytes",
                "peak_plan_bytes", "monolithic_plan_bytes", "emit",
                "graph_resident_bytes", "graph_replicated_bytes")


def hub_graph(n=24, hub_out=16, extra=40, seed=0):
    rng = np.random.default_rng(seed)
    src = [0] * hub_out + list(rng.integers(0, n, extra))
    dst = list(range(1, hub_out + 1)) + list(rng.integers(0, n, extra))
    return rt.from_edges(src, dst, n=max(n, hub_out + 1))


GRAPHS = {
    "hub": hub_graph,
    "orkut60": lambda: rt.paper_workload("orkut", 60, 8.0, seed=0),
}


@functools.lru_cache(maxsize=None)
def graph(name):
    return GRAPHS[name]()


@functools.lru_cache(maxsize=None)
def oracle(name):
    return rt.census_batagelj_mrvar(graph(name))


def convert_to_reference(g):
    """The JAX package's copy of a port graph (the same CSR arrays)."""
    return RefDigraph(n=g.n, indptr=g.indptr.copy(), packed=g.packed.copy(),
                      num_arcs=g.num_arcs)


@functools.lru_cache(maxsize=None)
def reference(name, orient, emit, max_items):
    """The JAX package's single-device jnp engine on the same graph."""
    eng = RefEngine(mesh=None, backend="jnp", emit=emit)
    census = eng.run(convert_to_reference(graph(name)),
                     max_items=max_items, orient=orient)
    return census, eng.stats


CASES = [("hub", None), ("hub", 64), ("hub", 3),
         ("orkut60", None), ("orkut60", 1000), ("orkut60", 97)]


@pytest.mark.parametrize("name, max_items", CASES)
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("backend", ["torch", "hist", "fused"])
def test_engine_matches_reference(backend, orient, emit, name, max_items):
    eng = rt.CensusEngine(device="cpu", backend=backend, emit=emit)
    census = eng.run(graph(name), max_items=max_items, orient=orient)
    want, want_stats = reference(name, orient, emit, max_items)
    np.testing.assert_array_equal(census, want)
    np.testing.assert_array_equal(census, oracle(name))
    assert census.dtype == np.int64
    for field in STATS_FIELDS:
        assert getattr(eng.stats, field) == getattr(want_stats, field), \
            field
    assert eng.stats.backend == backend
    assert eng.stats.step_compiles == eng.stats.capacity_recompiles == 0


@pytest.mark.parametrize("emit", ["device", "host"])
def test_progress_calls_match(emit):
    got, want = [], []
    g = graph("hub")
    rt.CensusEngine(device="cpu", emit=emit).run(
        g, max_items=40, orient="degree",
        progress=lambda *a: got.append(a))
    RefEngine(mesh=None, emit=emit).run(
        convert_to_reference(g), max_items=40, orient="degree",
        progress=lambda *a: want.append(a))
    assert got == want and len(got) > 1


@pytest.mark.parametrize("backend", ["torch", "hist", "fused"])
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_triad_census_of_reference_plan(backend, orient):
    """A plan built by the JAX package, carried across by ``convert``,
    counts the same on every port backend."""
    for name in ("patents", "webgraph"):
        n, deg = {"patents": (600, 3.0), "webgraph": (400, 6.0)}[name]
        g = rt.paper_workload(name, n, deg, seed=2)
        ref_plan = ref_build_plan(convert_to_reference(g), orient=orient)
        plan = convert.plan_from_reference(ref_plan)
        got = rt.triad_census(plan, backend=backend, device="cpu")
        np.testing.assert_array_equal(got, ref_triad_census(ref_plan))
        np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g))


@pytest.mark.parametrize("edges", [
    ([], [], 10),                       # no pairs at all
    ([0], [1], 5),                      # one arc: three 012 triads
    ([0, 1], [1, 0], 4),                # one mutual dyad: no items left
])
@pytest.mark.parametrize("emit", ["device", "host"])
def test_zero_and_tiny_work(edges, emit):
    src, dst, n = edges
    g = rt.from_edges(src, dst, n=n)
    for max_items in (None, 2):
        eng = rt.CensusEngine(device="cpu", emit=emit)
        got = eng.run(g, max_items=max_items)
        ref = RefEngine(mesh=None, emit=emit)
        want = ref.run(convert_to_reference(g), max_items=max_items)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rt.census_bruteforce(g))
        for field in STATS_FIELDS:
            assert getattr(eng.stats, field) == getattr(ref.stats, field)


def test_no_cuda_device_raises(monkeypatch):
    """The engine runs on the card by default and never drops to the CPU
    on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.CensusEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.CensusEngine(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.triad_census(rt.build_plan(hub_graph()))
    assert rt.CensusEngine(device="cpu").device == torch.device("cpu")


def test_rejects_unknown_options():
    with pytest.raises(ValueError):
        rt.CensusEngine(device="cpu", backend="pallas-fused")
    with pytest.raises(ValueError):
        rt.CensusEngine(device="cpu", emit="both")
    with pytest.raises(ValueError):
        rt.CensusEngine(device="meta")
    with pytest.raises(ValueError):
        rt.CensusEngine(device="cpu").run(hub_graph(), emit="both")
    with pytest.raises(ValueError):
        rt.CensusEngine(device="cpu").run(hub_graph(), orient="random")
