"""The port's persistent pair-space index against the JAX package's.

Over random churn streams, in both orients, the port's ``PairSpaceIndex``
holds the same keys, maintained costs, affected-pair answers and pair
space (array for array, dtype for dtype) as ``repro``'s index given the
same deltas, and the same as a from-scratch ``pair_space`` of each
revision.  The corruption contract is the reference's: a mutated,
mismatched, stale or drifted index raises ``IndexCorruptionError``.
"""

import numpy as np
import pytest

from repro.core import digraph as ref_digraph
from repro.core import pair_index as ref_pair_index
from repro_torch.core import digraph, incremental, planner
from repro_torch.core.pair_index import IndexCorruptionError, PairSpaceIndex

SPACE_ARRAYS = ("indptr", "packed", "nbr", "deg", "pair_u", "pair_v",
                "pair_code", "counts", "offsets", "pair_term", "pair_mut")
SPACE_SCALARS = ("n", "orient", "prune_self", "max_degree", "search_iters")


def random_graph(rng, n=None, p=None):
    n = n or int(rng.integers(3, 40))
    a = rng.random((n, n)) < (p or float(rng.uniform(0.05, 0.4)))
    np.fill_diagonal(a, False)
    src, dst = np.nonzero(a)
    return (ref_digraph.from_edges(src, dst, n=n),
            digraph.from_edges(src, dst, n=n))


def random_arcs(rng, n, k):
    return rng.integers(0, n, k), rng.integers(0, n, k)


def assert_space_equal(got, want):
    for name in SPACE_SCALARS:
        assert getattr(got, name) == getattr(want, name), name
    for name in SPACE_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, f"{name}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_indexes_agree(index, ref_index, g, touched):
    assert_space_equal(index.space, ref_index.space)
    np.testing.assert_array_equal(index.keys, ref_index.keys)
    np.testing.assert_array_equal(index.costs, ref_index.costs)
    assert index.fingerprint == ref_index.fingerprint
    rebuilt = planner.pair_space(g, orient=index.space.orient,
                                 prune_self=index.space.prune_self)
    assert_space_equal(index.space, rebuilt)
    np.testing.assert_array_equal(index.costs,
                                  planner.postprune_pair_counts(rebuilt))
    np.testing.assert_array_equal(
        index.affected_pair_ids(touched),
        incremental.affected_pair_ids(rebuilt, touched))
    np.testing.assert_array_equal(index.affected_pair_ids(touched),
                                  ref_index.affected_pair_ids(touched))
    index.verify(g)


@pytest.mark.parametrize("prune_self", [True, False])
@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("seed", range(3))
def test_churn_stream_matches_reference(seed, orient, prune_self):
    rng = np.random.default_rng(seed)
    ref_g, g = random_graph(rng, n=int(rng.integers(10, 60)))
    index = PairSpaceIndex(g, orient=orient, prune_self=prune_self)
    ref_index = ref_pair_index.PairSpaceIndex(ref_g, orient=orient,
                                              prune_self=prune_self)
    assert_indexes_agree(index, ref_index, g, np.arange(g.n))
    for _ in range(5):
        arcs = (*random_arcs(rng, g.n, int(rng.integers(0, 15))),
                *random_arcs(rng, g.n, int(rng.integers(0, 15))))
        g_new, delta = digraph.apply_delta(g, *arcs)
        ref_new, ref_delta = ref_digraph.apply_delta(ref_g, *arcs)
        space = index.apply(delta, g_new)
        ref_index.apply(ref_delta, ref_new)
        assert space is index.space
        g, ref_g = g_new, ref_new
        assert_indexes_agree(index, ref_index, g, delta.touched)


@pytest.mark.parametrize("orient", ["none", "degree"])
def test_hub_growth_and_drain(orient):
    """A hub row grows past the largest degree, then empties again."""
    ref_g, g = random_graph(np.random.default_rng(9), n=30, p=0.05)
    index = PairSpaceIndex(g, orient=orient)
    ref_index = ref_pair_index.PairSpaceIndex(ref_g, orient=orient)
    hub = np.zeros(29, dtype=np.int64)
    spokes = np.arange(1, 30)
    for arcs in ((hub, spokes), (spokes, hub),
                 (None, None, hub, spokes), (None, None, spokes, hub)):
        g_new, delta = digraph.apply_delta(g, *arcs)
        ref_new, ref_delta = ref_digraph.apply_delta(ref_g, *arcs)
        index.apply(delta, g_new)
        ref_index.apply(ref_delta, ref_new)
        g, ref_g = g_new, ref_new
        assert_indexes_agree(index, ref_index, g, delta.touched)


def test_grow_from_empty_and_back():
    ref_g, g = (ref_digraph.from_edges([], [], n=8),
                digraph.from_edges([], [], n=8))
    index = PairSpaceIndex(g)
    ref_index = ref_pair_index.PairSpaceIndex(ref_g)
    for arcs in (([0, 1, 2], [1, 2, 3]), (None, None, [0, 1, 2],
                                          [1, 2, 3])):
        g_new, delta = digraph.apply_delta(g, *arcs)
        ref_new, ref_delta = ref_digraph.apply_delta(ref_g, *arcs)
        index.apply(delta, g_new)
        ref_index.apply(ref_delta, ref_new)
        g, ref_g = g_new, ref_new
        assert_indexes_agree(index, ref_index, g, delta.touched)
    assert index.space.num_pairs == 0


def test_touched_pair_keys_match_reference():
    rng = np.random.default_rng(11)
    _, g = random_graph(rng, n=25, p=0.2)
    touched = np.unique(rng.integers(0, g.n, 6))
    from repro_torch.core.pair_index import _touched_pair_keys
    np.testing.assert_array_equal(
        _touched_pair_keys(g.indptr, g.packed >> 2, g.n, touched),
        ref_pair_index._touched_pair_keys(g.indptr, g.packed >> 2, g.n,
                                          touched))


def test_prebuilt_space_must_match_policy():
    _, g = random_graph(np.random.default_rng(2), n=12, p=0.3)
    space = planner.pair_space(g, orient="degree")
    assert PairSpaceIndex(g, orient="degree", space=space).space is space
    with pytest.raises(ValueError):
        PairSpaceIndex(g, orient="none", space=space)


# ---------------------------------------- corruption (the reference's four)

def test_external_mutation_detected():
    _, g = random_graph(np.random.default_rng(3), n=15, p=0.3)
    index = PairSpaceIndex(g)
    index.verify(g)
    index.space.packed[0] ^= 1      # bit rot / external mutation
    with pytest.raises(IndexCorruptionError):
        index.verify()


def test_wrong_graph_detected():
    rng = np.random.default_rng(4)
    _, g1 = random_graph(rng, n=15, p=0.3)
    _, g2 = random_graph(rng, n=15, p=0.3)
    index = PairSpaceIndex(g1)
    with pytest.raises(IndexCorruptionError):
        index.verify(g2)


def test_stale_delta_detected():
    rng = np.random.default_rng(5)
    _, g = random_graph(rng, n=15, p=0.3)
    index = PairSpaceIndex(g)
    g2, delta = digraph.apply_delta(g, *random_arcs(rng, g.n, 8))
    index.apply(delta, g2)
    with pytest.raises(IndexCorruptionError):
        index.apply(delta, g2)       # applying the same delta twice


def test_key_cache_drift_detected():
    g = digraph.from_edges([0, 1], [1, 2], n=4)
    index = PairSpaceIndex(g)
    index._keys = index._keys.copy()
    index._keys[0] += 1
    with pytest.raises(IndexCorruptionError):
        index.verify()
