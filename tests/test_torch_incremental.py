"""The port's graph edits and delta algebra against the JAX package's.

``apply_delta`` (CSR, arc count, every ``GraphDelta`` array and the
spliced entry-key cache), ``SplicePlan``, the pair-subset planner
(``emit_items_for_pairs``, ``base_for_pairs``,
``subset_descriptor_windows``), the closure invariant and the host-side
incremental update are array-equal to ``repro``'s on the same numpy
inputs.  Everything is integer: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import digraph as ref_digraph
from repro.core import incremental as ref_incremental
from repro.core import planner as ref_planner
from repro_torch.core import digraph, incremental, planner

torch.set_num_threads(1)

ORIENTS = ("none", "degree")
GRAPH_FIELDS = ("n", "indptr", "packed", "num_arcs")
DELTA_FIELDS = ("n", "pair_lo", "pair_hi", "old_code", "new_code",
                "touched")


def dense_arcs(rng, n=None, p=None):
    n = n or int(rng.integers(3, 40))
    a = rng.random((n, n)) < (p or float(rng.uniform(0.05, 0.4)))
    np.fill_diagonal(a, False)
    src, dst = np.nonzero(a)
    return src, dst, n


def both_graphs(src, dst, n):
    """The same graph in both packages, from the same numpy arcs."""
    return (ref_digraph.from_edges(src, dst, n=n),
            digraph.from_edges(src, dst, n=n))


def random_arcs(rng, n, k):
    return rng.integers(0, n, k), rng.integers(0, n, k)


def assert_fields_equal(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def assert_delta_applies_alike(ref_g, g, *arcs):
    """One delta on both packages' graphs; returns the edited pair."""
    ref_new, ref_delta = ref_digraph.apply_delta(ref_g, *arcs)
    new, delta = digraph.apply_delta(g, *arcs)
    assert_fields_equal(new, ref_new, GRAPH_FIELDS)
    assert_fields_equal(delta, ref_delta, DELTA_FIELDS)
    assert delta.num_changed == ref_delta.num_changed
    assert (new is g) == (ref_new is ref_g)
    if ref_new.ekey_cache is None:
        assert new.ekey_cache is None
    else:
        np.testing.assert_array_equal(new.ekey_cache, ref_new.ekey_cache)
        # the spliced cache is what a rebuild would give
        np.testing.assert_array_equal(
            new.ekey_cache, digraph.entry_keys(digraph.CompactDigraph(
                n=new.n, indptr=new.indptr, packed=new.packed,
                num_arcs=new.num_arcs)))
    new.validate()
    return ref_new, new


@pytest.mark.parametrize("seed", range(6))
def test_apply_delta_chain_matches_reference(seed):
    """Random streams of three deltas: each step splices the CSR and the
    entry-key cache forward exactly as the reference does."""
    rng = np.random.default_rng(seed)
    ref_g, g = both_graphs(*dense_arcs(rng))
    for _ in range(3):
        arcs = (*random_arcs(rng, g.n, int(rng.integers(0, 25))),
                *random_arcs(rng, g.n, int(rng.integers(0, 25))))
        ref_g, g = assert_delta_applies_alike(ref_g, g, *arcs)
    np.testing.assert_array_equal(rt.census_batagelj_mrvar(g),
                                  rt.census_bruteforce(g))


@pytest.mark.parametrize("arcs", [
    (),                                  # nothing at all
    ([0], [1]),                          # existing arc added
    (None, None, [3], [2]),              # absent arc removed
    ([2], [2]),                          # self-loop dropped
    ([0], [1], [0], [1]),                # removed, then added back
], ids=["empty", "add-existing", "del-absent", "self-loop",
        "remove-then-add"])
def test_noop_deltas_match_reference(arcs):
    ref_g, g = both_graphs([0, 1], [1, 2], 4)
    _, new = assert_delta_applies_alike(ref_g, g, *arcs)
    assert new is g


def test_delete_everything_matches_reference():
    ref_g, g = both_graphs([0, 1, 2], [1, 2, 0], 3)
    _, new = assert_delta_applies_alike(ref_g, g, None, None,
                                        [0, 1, 2], [1, 2, 0])
    assert new.num_arcs == 0 and new.num_pairs == 0


def test_empty_graph_insert_matches_reference():
    ref_g, g = both_graphs([], [], 5)
    _, new = assert_delta_applies_alike(ref_g, g, [0, 1, 4], [1, 0, 2])
    assert new.num_arcs == 3


def test_recode_only_delta_matches_reference():
    """Only existing pairs change code: the CSR is rewritten in place."""
    ref_g, g = both_graphs([0, 1, 2], [1, 2, 3], 5)
    assert_delta_applies_alike(ref_g, g, [1, 3], [0, 2])


@pytest.mark.parametrize("bad", [
    ([0], [3]), ([-1], [1]), ([np.nan], [1.0]), ([0, 1], [1])],
    ids=["out-of-range", "negative", "nan", "length-mismatch"])
def test_rejects_what_reference_rejects(bad):
    ref_g, g = both_graphs([0], [1], 3)
    with pytest.raises(ValueError):
        ref_digraph.apply_delta(ref_g, *bad)
    with pytest.raises(ValueError):
        digraph.apply_delta(g, *bad)
    with pytest.raises(ValueError):
        digraph.apply_delta(g, None, None, *bad)


@pytest.mark.parametrize("seed", range(4))
def test_splice_plan_is_delete_then_insert(seed):
    rng = np.random.default_rng(seed)
    num = int(rng.integers(0, 60))
    arr = np.sort(rng.integers(0, 1000, num))
    del_pos = np.sort(rng.choice(num, int(rng.integers(0, num + 1)),
                                 replace=False)).astype(np.int64)
    ins_pos = np.sort(rng.integers(0, num + 1, int(rng.integers(0, 12))))
    vals = rng.integers(0, 1000, ins_pos.shape[0])
    plan = digraph.SplicePlan(num, del_pos, ins_pos)
    ref_plan = ref_digraph.SplicePlan(num, del_pos, ins_pos)
    got = plan.splice(arr, vals)
    want = np.insert(np.delete(arr, del_pos),
                     ins_pos - np.searchsorted(del_pos, ins_pos), vals)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_plan.splice(arr, vals))
    keep = np.setdiff1d(np.arange(num), del_pos)
    np.testing.assert_array_equal(plan.readdress(keep),
                                  ref_plan.readdress(keep))
    np.testing.assert_array_equal(got[plan.readdress(keep)], arr[keep])


def spaces(seed, orient):
    rng = np.random.default_rng(seed)
    src, dst, n = dense_arcs(rng, n=30, p=0.15)
    ref_g, g = both_graphs(src, dst, n)
    return (rng, ref_planner.pair_space(ref_g, orient=orient),
            planner.pair_space(g, orient=orient))


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("seed", range(3))
def test_subset_planning_matches_reference(seed, orient):
    rng, ref_space, space = spaces(seed, orient)
    ids = np.sort(rng.choice(space.num_pairs,
                             int(rng.integers(0, space.num_pairs)),
                             replace=False))
    for got, want in zip(planner.emit_items_for_pairs(space, ids),
                         ref_planner.emit_items_for_pairs(ref_space, ids)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert planner.base_for_pairs(space, ids) == \
        ref_planner.base_for_pairs(ref_space, ids)
    for max_items, desc_shape in ((64, 8), (5, 3), (1, 1), (10**6, 64)):
        got = list(incremental.subset_descriptor_windows(
            space, ids, max_items, desc_shape,
            planner.num_desc_anchors(max_items)))
        want = list(ref_incremental.subset_descriptor_windows(
            ref_space, ids, max_items, desc_shape,
            ref_planner.num_desc_anchors(max_items)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.device_words(),
                                          b.device_words())
    with pytest.raises(ValueError):
        planner.emit_items_for_pairs(space, [space.num_pairs])
    with pytest.raises(ValueError):
        list(incremental.subset_descriptor_windows(space, [-1], 8, 4, 2))


@pytest.mark.parametrize("orient", ORIENTS)
@pytest.mark.parametrize("seed", range(3))
def test_delta_closure_and_affected_pairs(seed, orient):
    rng, _, _ = spaces(seed, orient)
    src, dst, n = dense_arcs(rng)
    ref_g, g = both_graphs(src, dst, n)
    arcs = (*random_arcs(rng, n, int(rng.integers(1, 20))),
            *random_arcs(rng, n, int(rng.integers(1, 20))))
    g2, delta = digraph.apply_delta(g, *arcs)
    ref_g2, ref_delta = ref_digraph.apply_delta(ref_g, *arcs)
    old = planner.pair_space(g, orient=orient)
    new = planner.pair_space(g2, orient=orient)
    incremental.verify_delta_closure(old, new, delta)
    for sp, ref_sp in ((old, ref_planner.pair_space(ref_g, orient=orient)),
                       (new, ref_planner.pair_space(ref_g2,
                                                    orient=orient))):
        np.testing.assert_array_equal(
            incremental.affected_pair_ids(sp, delta.touched),
            ref_incremental.affected_pair_ids(ref_sp, ref_delta.touched))
    if delta.num_changed:
        # a delta that hides a changed pair breaks the invariant
        stale = digraph.GraphDelta(
            n=delta.n, pair_lo=delta.pair_lo[1:], pair_hi=delta.pair_hi[1:],
            old_code=delta.old_code[1:], new_code=delta.new_code[1:])
        with pytest.raises(AssertionError):
            incremental.verify_delta_closure(old, new, stale)


@pytest.mark.parametrize("backend", rt.BACKENDS)
@pytest.mark.parametrize("orient", ORIENTS)
def test_host_incremental_update_matches_reference(orient, backend):
    """The algebra alone, no session: the old census minus the affected
    pairs' old contribution plus their new one, through ``host_runner``
    on the CPU, equals the reference's update and the oracle."""
    rng = np.random.default_rng(23)
    src, dst, n = dense_arcs(rng, n=30, p=0.2)
    ref_g, g = both_graphs(src, dst, n)
    arcs = (*random_arcs(rng, n, 8), *random_arcs(rng, n, 8))
    g2, delta = digraph.apply_delta(g, *arcs)
    ref_g2, ref_delta = ref_digraph.apply_delta(ref_g, *arcs)

    def update(mod, inc, old_g, new_g, d, runner):
        sp_old = mod.pair_space(old_g, orient=orient)
        sp_new = mod.pair_space(new_g, orient=orient)
        c_old, n_old = inc.subset_contribution(
            sp_old, inc.affected_pair_ids(sp_old, d.touched),
            runner(sp_old))
        c_new, n_new = inc.subset_contribution(
            sp_new, inc.affected_pair_ids(sp_new, d.touched),
            runner(sp_new))
        return (inc.combine(rt.census_batagelj_mrvar(g), c_old, c_new, n),
                c_old, c_new, n_old, n_new)

    got = update(planner, incremental, g, g2, delta,
                 lambda sp: incremental.host_runner(sp, backend,
                                                    device="cpu"))
    want = update(ref_planner, ref_incremental, ref_g, ref_g2, ref_delta,
                  ref_incremental.host_runner)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], rt.census_batagelj_mrvar(g2))


def test_host_runner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = planner.pair_space(digraph.from_edges([0], [1], n=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        incremental.host_runner(space)
