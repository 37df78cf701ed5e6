"""The port's host layer against the JAX package's: generators, CSR
construction, pair spaces, plans, descriptor windows and chunkers are
array-equal on the same inputs, and ``convert`` carries state across.

Everything here is numpy on both sides; the tolerance is zero."""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import digraph as ref_digraph
from repro.core import generators as ref_generators
from repro.core import plan_stream as ref_stream
from repro.core import planner as ref_planner
from repro_torch import convert
from repro_torch.core import digraph, planner, plan_stream

torch.set_num_threads(1)

#: as tests/test_census_fused.py
SMALL_SIZES = {"patents": (600, 3.0), "orkut": (250, 12.0),
               "webgraph": (400, 6.0)}
ORIENTS = ("none", "degree")


def hub_graph(mod, n=24, hub_out=16, extra=40, seed=0):
    """A graph whose hub pair costs more items than small budgets, so
    chunking splits it (``mod`` is either package's digraph module)."""
    rng = np.random.default_rng(seed)
    src = [0] * hub_out + list(rng.integers(0, n, extra))
    dst = list(range(1, hub_out + 1)) + list(rng.integers(0, n, extra))
    return mod.from_edges(src, dst, n=max(n, hub_out + 1))


def assert_fields_equal(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def small_graphs(seed=0):
    for name, (n, deg) in SMALL_SIZES.items():
        yield (name, ref_generators.paper_workload(name, n, deg, seed=seed),
               rt.paper_workload(name, n, deg, seed=seed))


GRAPH_FIELDS = ("n", "indptr", "packed", "num_arcs")


@pytest.mark.parametrize("seed", [0, 1])
def test_generators_match(seed):
    for _, want, got in small_graphs(seed):
        assert_fields_equal(got, want, GRAPH_FIELDS)
    a = ref_generators.erdos_renyi_digraph(50, 0.1, seed=seed)
    b = rt.erdos_renyi_digraph(50, 0.1, seed=seed)
    assert_fields_equal(b, a, GRAPH_FIELDS)


@pytest.mark.parametrize("seed", range(3))
def test_from_edges_and_canonical_pairs_match(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 70, 400)
    dst = rng.integers(0, 70, 400)           # self-loops and duplicates
    want = ref_digraph.from_edges(src, dst, n=75)
    got = digraph.from_edges(src, dst, n=75)
    assert_fields_equal(got, want, GRAPH_FIELDS)
    got.validate()
    for a, b in zip(digraph.canonical_pairs(got),
                    ref_digraph.canonical_pairs(want)):
        np.testing.assert_array_equal(a, b)
    dense = ref_digraph.to_dense(want)
    np.testing.assert_array_equal(digraph.to_dense(got), dense)
    assert_fields_equal(digraph.from_dense(dense),
                        ref_digraph.from_dense(dense), GRAPH_FIELDS)


@pytest.mark.parametrize("seed", range(2))
def test_from_edges_matches_on_wide_ids(seed):
    """Rows sort on one int64 key (row << 31 | packed entry): equal to
    the reference's two-column sort where ids use many bits."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 2**20, 20_000)
    dst = np.where(rng.random(20_000) < 0.5, src ^ 1,
                   rng.integers(0, 2**20, 20_000))
    assert_fields_equal(digraph.from_edges(src, dst, n=2**20),
                        ref_digraph.from_edges(src, dst, n=2**20),
                        GRAPH_FIELDS)


@pytest.mark.parametrize("src, dst, n", [
    ([[0, 1], [2]], [[1, 2], [0]], None),     # ragged
    ([0.0, np.nan], [1.0, 2.0], None),         # non-finite
    ([0, 9], [1, 2], 5),                       # out of range
    ([0, 1], [1], None),                       # length mismatch
])
def test_clean_arcs_rejects_what_the_reference_rejects(src, dst, n):
    with pytest.raises(ValueError):
        ref_digraph.clean_arcs(src, dst, n)
    with pytest.raises(ValueError):
        digraph.clean_arcs(src, dst, n)


SPACE_FIELDS = ("n", "orient", "prune_self", "max_degree", "search_iters",
                "indptr", "packed", "nbr", "deg", "pair_u", "pair_v",
                "pair_code", "counts", "offsets", "pair_term", "pair_mut")


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("prune_self", [True, False])
def test_pair_space_matches(orient, prune_self):
    for _, want_g, got_g in small_graphs():
        want = ref_planner.pair_space(want_g, orient, prune_self)
        got = planner.pair_space(got_g, orient, prune_self)
        assert_fields_equal(got, want, SPACE_FIELDS)
        np.testing.assert_array_equal(
            planner.postprune_pair_counts(got),
            ref_planner.postprune_pair_counts(want))
        assert got.num_items_postprune() == want.num_items_postprune()
        starts = np.arange(0, got.num_items_preprune, 997)
        for a, b in zip(got.base_slices(starts), want.base_slices(starts)):
            np.testing.assert_array_equal(a, b)
        ids = np.arange(0, got.num_pairs, 3)
        assert planner.base_for_pairs(got, ids) == \
            ref_planner.base_for_pairs(want, ids)


PLAN_FIELDS = ("n", "num_pairs", "num_items", "max_degree", "search_iters",
               "orient", "indptr", "packed", "pair_u", "pair_v",
               "pair_code", "item_sp", "item_pv", "base_asym", "base_mut")


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("pad_to", [1, 64])
def test_build_plan_matches(orient, pad_to):
    for _, want_g, got_g in small_graphs():
        want = ref_planner.build_plan(want_g, pad_to=pad_to, orient=orient)
        got = planner.build_plan(got_g, pad_to=pad_to, orient=orient)
        assert_fields_equal(got, want, PLAN_FIELDS)


def test_pack_items_round_trip_matches():
    rng = np.random.default_rng(0)
    slot = rng.integers(0, 2**30, 1000)
    side = rng.integers(0, 2, 1000)
    pair = rng.integers(0, 2**30, 1000)
    valid = rng.integers(0, 2, 1000).astype(bool)
    got = planner.pack_items(slot, side, pair, valid)
    want = ref_planner.pack_items(slot, side, pair, valid)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(planner.unpack_items(*got),
                    ref_planner.unpack_items(*want)):
        np.testing.assert_array_equal(a, b)


WINDOW_FIELDS = ("start", "stop", "num_preprune", "num_descs",
                 "desc_pair", "desc_cum", "desc_within0", "anchors")
CHUNK_FIELDS = ("index", "num_chunks", "start", "stop", "num_items",
                "item_sp", "item_pv", "base_asym", "base_mut")


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("max_items", [1, 2, 3, 17, 101, None])
def test_chunker_windows_and_chunks_match(orient, max_items):
    """Windows (words, anchors, bases) and packed chunks are equal,
    including budgets of 1-3 items that split every pair."""
    want_c = ref_stream.PlanChunker(hub_graph(ref_digraph), max_items,
                                    orient=orient, pad_to=8)
    got_c = plan_stream.PlanChunker(hub_graph(digraph), max_items,
                                    orient=orient, pad_to=8)
    for name in ("max_items", "num_chunks", "chunk_shape", "desc_shape",
                 "desc_iters", "num_anchors"):
        assert getattr(got_c, name) == getattr(want_c, name), name
    for a, b in zip(got_c.device_arrays(), want_c.device_arrays()):
        np.testing.assert_array_equal(a, b)
    for k in range(got_c.num_chunks):
        got_w, want_w = got_c.descriptors(k), want_c.descriptors(k)
        assert_fields_equal(got_w, want_w, WINDOW_FIELDS)
        np.testing.assert_array_equal(got_w.device_words(),
                                      want_w.device_words())
        assert got_w.upload_bytes == want_w.upload_bytes
        assert got_c.bases(k) == want_c.bases(k)
        assert_fields_equal(got_c.chunk(k), want_c.chunk(k), CHUNK_FIELDS)
    if max_items is not None:
        for got_k, want_k in zip(
                plan_stream.iter_plan_chunks(hub_graph(digraph), max_items,
                                             orient=orient),
                ref_stream.iter_plan_chunks(hub_graph(ref_digraph),
                                            max_items, orient=orient)):
            assert_fields_equal(got_k, want_k, CHUNK_FIELDS)


@pytest.mark.parametrize("desc_shape", [1, 2, 5])
def test_iter_descriptor_windows_shrinks_like_reference(desc_shape):
    want_s = ref_planner.pair_space(hub_graph(ref_digraph, seed=2))
    got_s = planner.pair_space(hub_graph(digraph, seed=2))
    anchors = planner.num_desc_anchors(40)
    got = list(planner.iter_descriptor_windows(got_s.offsets, 40,
                                               desc_shape, anchors))
    want = list(ref_planner.iter_descriptor_windows(want_s.offsets, 40,
                                                    desc_shape, anchors))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_fields_equal(a, b, WINDOW_FIELDS)
    ids = np.arange(got_s.num_pairs)[::-1].copy()
    sub = np.concatenate([[0], np.cumsum(got_s.counts[ids])])
    assert_fields_equal(
        planner.descriptor_window(sub, 5, 60, 20, anchors, pair_ids=ids),
        ref_planner.descriptor_window(sub, 5, 60, 20, anchors,
                                      pair_ids=ids), WINDOW_FIELDS)


def test_emit_items_matches_and_rejects_bad_slices():
    got_s = planner.pair_space(hub_graph(digraph), orient="degree")
    want_s = ref_planner.pair_space(hub_graph(ref_digraph), orient="degree")
    for lo, hi in [(0, 0), (3, 40), (0, got_s.num_items_preprune)]:
        for a, b in zip(planner.emit_items(got_s, lo, hi),
                        ref_planner.emit_items(want_s, lo, hi)):
            np.testing.assert_array_equal(a, b)
    for lo, hi in [(-1, 5), (0, got_s.num_items_preprune + 1)]:
        with pytest.raises(ValueError):
            planner.emit_items(got_s, lo, hi)


def test_chunker_guards_like_reference():
    for mod, stream in ((digraph, plan_stream), (ref_digraph, ref_stream)):
        g = hub_graph(mod)
        with pytest.raises(ValueError):
            stream.PlanChunker(g, max_items=0)
        with pytest.raises(ValueError):
            stream.PlanChunker(g, max_items=8, pad_to=0)
        # a dispatch of 2**31 lanes would wrap the int32 accumulators
        with pytest.raises(ValueError) as err:
            stream.PlanChunker(g, max_items=8, pad_to=2**31)
        assert type(err.value).__name__ == "PlanOverflowError"
    assert issubclass(planner.PlanOverflowError, ValueError)


def test_convert_round_trip():
    for _, want_g, _ in small_graphs():
        got_g = convert.graph_from_reference(want_g)
        assert_fields_equal(got_g, want_g, GRAPH_FIELDS)
        assert got_g.packed is not want_g.packed      # copied, not shared
        assert_fields_equal(
            convert.graph_from_arrays(want_g.n, want_g.indptr,
                                      want_g.packed, want_g.num_arcs),
            want_g, GRAPH_FIELDS)
        want_c = ref_stream.PlanChunker(want_g, 500, orient="degree")
        got_c = plan_stream.PlanChunker(got_g, 500, orient="degree")
        for k in (0, want_c.num_chunks - 1):
            assert_fields_equal(
                convert.window_from_reference(want_c.descriptors(k)),
                got_c.descriptors(k), WINDOW_FIELDS)
        assert_fields_equal(
            convert.plan_from_reference(ref_planner.build_plan(want_g)),
            planner.build_plan(got_g), PLAN_FIELDS)
    with pytest.raises(ValueError):
        convert.graph_from_arrays(3, [0, 1], [4], 1)
