"""The benchmark's seeded inputs: the generator copy's distribution and
the citation deltas."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import graphs, reference  # noqa: E402


def test_same_seed_same_graph_other_seed_other_graph():
    a = graphs.scale_free_edges(2000, 6.0, 2.1, 0.3, graphs.generator(5, "cpu"))
    b = graphs.scale_free_edges(2000, 6.0, 2.1, 0.3, graphs.generator(5, "cpu"))
    c = graphs.scale_free_edges(2000, 6.0, 2.1, 0.3,
                                graphs.generator(2**31 + 9, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1][:100], c[1][:100])


@pytest.mark.parametrize("exponent, avg, mutual, pref", [
    (3.126, 4.38, 0.0, False), (2.127, 20.0, 0.5, True)])
def test_degrees_and_arcs_follow_the_stated_distribution(exponent, avg,
                                                         mutual, pref):
    n = 20000
    gen = graphs.generator(11, "cpu")
    deg = graphs.powerlaw_outdegrees(n, exponent, avg, gen).numpy()
    # the rescaled mean is the target average (rounding moves it < 0.5)
    assert abs(deg.mean() - avg) < 0.5
    # before rescaling, P(k = 1) of a bounded Zipf on 1..4*sqrt(n)
    ks = np.arange(1, int(np.sqrt(n) * 4) + 1, dtype=np.float64)
    p1 = 1.0 / (ks ** -exponent).sum()
    # k = 1 rescales to the smallest degree, k = 2 to a larger one
    share = (deg == deg.min()).mean()
    assert abs(share - p1) < 4 * np.sqrt(p1 * (1 - p1) / n) + 0.01
    src, dst = graphs.scale_free_edges(n, avg, exponent, mutual,
                                       graphs.generator(12, "cpu"), pref)
    m = int(graphs.powerlaw_outdegrees(
        n, exponent, avg, graphs.generator(12, "cpu")).sum())
    assert abs(src.numel() - m * (1 + mutual)) < 5 * np.sqrt(m) + 1
    indeg = torch.bincount(dst, minlength=n).double()
    if pref:
        # the Zipf head: the top vertex draws about m / H_n of the arcs
        top = float(indeg.max())
        expect = m / (np.log(n) + 0.5772)
        assert 0.8 * expect < top < 1.3 * expect
    else:
        assert float(indeg.max()) < 8 * avg
    assert int(src.max()) < n and int(dst.max()) < n


def test_citation_delta_deletes_distinct_arcs_and_adds_cited_heads():
    n = 3000
    src, dst = graphs.scale_free_edges(n, 4.0, 3.0, 0.0,
                                       graphs.generator(3, "cpu"), False)
    keys = reference.arc_keys(src, dst, n).numpy()
    order = torch.randperm(keys.shape[0],
                           generator=graphs.generator(3, "cpu")).numpy()
    heads = set((keys % n).tolist())
    gone = set()
    for i in range(4):
        a_s, a_d, d_s, d_d = graphs.citation_delta(keys, order, n, 50, 3, i)
        assert len(a_s) == len(a_d) == len(d_s) == len(d_d) == 50
        deleted = set((d_s * n + d_d).tolist())
        assert deleted <= set(keys.tolist()) and not deleted & gone
        gone |= deleted
        assert set(a_d.tolist()) <= heads
        again = graphs.citation_delta(keys, order, n, 50, 3, i)
        assert all(np.array_equal(x, y) for x, y in
                   zip((a_s, a_d, d_s, d_d), again))
    # past the arcs the stream wraps round the permutation
    m = keys.shape[0]
    wrapped = graphs.citation_delta(keys, order, n, m, 3, 1)
    assert set((wrapped[2] * n + wrapped[3]).tolist()) == set(keys.tolist())


def test_bounded_targets_expect_their_top_in_degree():
    n, arcs = 20000, 80000
    r0 = graphs.zipf_offset(n, arcs, 40.0)
    w = 1.0 / (r0 + 1.0 + np.arange(n))
    assert r0 > 0 and abs(arcs * w[0] / w.sum() - 40.0) < 1e-6
    # a bound above the unbounded top leaves the port's weights
    assert graphs.zipf_offset(n, arcs, 1e6) == 0.0
    _, dst = graphs.scale_free_edges(n, 4.0, 3.0, 0.0,
                                     graphs.generator(4, "cpu"), True, r0)
    top = float(torch.bincount(dst, minlength=n).max())
    # the largest of some hundreds of near-top vertices, each Poisson
    assert 40 < top < 40 + 6 * np.sqrt(40)


def test_a_published_arc_count_is_drawn_exactly():
    cfg = dict(n=5000, arcs=21000, avg_degree=4.0, exponent=3.126,
               mutual_p=0.0, preferential=True, top_indegree=30)
    src, dst = graphs.config_edges(cfg, 2**31 + 3, "cpu")
    keys = src * cfg["n"] + dst
    assert keys.numel() == 21000 and not bool((src == dst).any())
    assert torch.equal(keys, torch.unique(keys))
    again = graphs.config_edges(cfg, 2**31 + 3, "cpu")
    assert torch.equal(again[0], src) and torch.equal(again[1], dst)
