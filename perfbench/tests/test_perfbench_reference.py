"""The plain reference against a brute-force count of every triple, and
its int32 control."""

import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import graphs, reference  # noqa: E402


def brute_force(keys: torch.Tensor, n: int) -> list[int]:
    """O(n^3): every triple typed by the reference's tricode table."""
    arcs = {(int(k) // n, int(k) % n) for k in keys}
    out = [0] * 16
    for u, v, w in itertools.combinations(range(n), 3):
        out[reference.TYPE_OF[reference.tricode(arcs, u, v, w)]] += 1
    return out


CASES = {
    "citations": (40, 3.0, 3.126, 0.0, False),
    "mutual-hubs": (36, 6.0, 2.127, 0.5, True),
    "dense-mutual": (24, 10.0, 1.516, 0.25, True),
    "sparse": (45, 1.0, 2.5, 0.1, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("block", [1, 5, 2**24])
def test_census_equals_brute_force(case, block):
    n, avg, exponent, mutual, pref = CASES[case]
    src, dst = graphs.scale_free_edges(n, avg, exponent, mutual,
                                       graphs.generator(len(case), "cpu"),
                                       pref)
    keys = reference.arc_keys(src, dst, n)
    got = reference.census(keys, n, block=block)
    assert got == brute_force(keys, n)
    assert sum(got) == math.comb(n, 3)


def test_star_hub_and_complete_graph():
    n = 30
    hub = torch.tensor([0] * (n - 1)), torch.arange(1, n)
    keys = reference.arc_keys(*hub, n)
    assert reference.census(keys, n) == brute_force(keys, n)
    src, dst = zip(*[(a, b) for a in range(8) for b in range(8) if a != b])
    keys = reference.arc_keys(torch.tensor(src), torch.tensor(dst), 8)
    want = [0] * 16
    want[15] = math.comb(8, 3)
    assert reference.census(keys, 8) == want


def test_type_table_names_one_drawing_of_each_type():
    assert sorted(set(reference.TYPE_OF)) == list(range(16))
    assert reference.TYPE_OF[0] == 0 and reference.TYPE_OF[63] == 15
    # 111D: the asymmetric arc points into the mutual dyad (A<->B<-C)
    arcs = {(0, 1), (1, 0), (2, 1)}
    assert reference.TRIAD_NAMES[reference.TYPE_OF[
        reference.tricode(arcs, 0, 1, 2)]] == "111D"


def test_type_table_agrees_with_the_port():
    from repro_torch.core.tricode import TRICODE_TO_CLASS, TRIAD_NAMES
    assert list(TRICODE_TO_CLASS) == list(reference.TYPE_OF)
    assert tuple(TRIAD_NAMES) == reference.TRIAD_NAMES


def test_apply_delta_deletes_first_then_adds():
    n = 10
    keys = reference.arc_keys(torch.tensor([0, 1, 2, 3]),
                              torch.tensor([1, 2, 3, 4]), n)
    out = reference.apply_delta(
        keys, n, add_src=[1, 5, 6, 0], add_dst=[2, 5, 7, 1],
        del_src=[1, 3, 8], del_dst=[2, 4, 9])
    # 1->2 deleted and re-added, 3->4 gone, 8->9 absent, 5->5 a self-loop
    assert sorted(out.tolist()) == sorted([0 * n + 1, 1 * n + 2, 2 * n + 3,
                                           6 * n + 7])


def test_delta_stream_census_equals_brute_force():
    n = 40
    src, dst = graphs.scale_free_edges(n, 4.0, 2.1, 0.3,
                                       graphs.generator(21, "cpu"), True)
    keys = reference.arc_keys(src, dst, n)
    base = keys.numpy()
    order = np.random.default_rng(0).permutation(base.shape[0])
    for i in range(3):
        keys = reference.apply_delta(
            keys, n, *graphs.citation_delta(base, order, n, 6, 21, i))
        assert reference.census(keys, n, block=3) == brute_force(keys, n)


def test_int32_control_is_not_exact_where_counts_pass_int32():
    # C(3000, 3) = 4.5e9 > 2**31: the control's 003 wraps
    n = 3000
    src, dst = graphs.scale_free_edges(n, 4.0, 3.126, 0.0,
                                       graphs.generator(1, "cpu"), False)
    keys = reference.arc_keys(src, dst, n)
    exact = reference.census(keys, n)
    low = reference.census(keys, n, acc=torch.int32)
    assert sum(exact) == math.comb(n, 3)
    assert max(abs(a - b) for a, b in zip(exact, low)) > 0
