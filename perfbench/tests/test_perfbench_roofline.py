"""The frozen work counts of the census roofline, pinned on small graphs."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import reference, roofline  # noqa: E402


def work(arcs, n):
    src, dst = zip(*arcs)
    keys = reference.arc_keys(torch.tensor(src), torch.tensor(dst), n)
    return roofline.census_work(keys, n)


def test_star():
    # 4 pairs, each with a leaf of degree 1
    assert work([(0, k) for k in range(1, 5)], 5) == dict(
        bytes=4 * 8 + 4 * 6, ops=4, pairs=4)


def test_mutual_arcs_make_one_pair():
    assert work([(0, 1), (1, 0), (1, 2)], 3) == dict(
        bytes=4 * 4 + 4 * 4, ops=2, pairs=2)


def test_clique_and_isolated_vertices():
    arcs = [(a, b) for a in range(4) for b in range(4) if a < b]
    # K4 among 10 vertices: 6 pairs, each end of degree 3
    assert work(arcs, 10) == dict(bytes=4 * 12 + 4 * 11, ops=18, pairs=6)


def test_least_seconds_is_the_larger_bound():
    assert roofline.INT32_OPS_PER_S == pytest.approx(1.672704e13, rel=1e-6)
    by_bytes = dict(bytes=3.35e12, ops=1)
    by_ops = dict(bytes=1, ops=2 * roofline.INT32_OPS_PER_S)
    assert roofline.least_seconds(by_bytes) == pytest.approx(1.0)
    assert roofline.least_seconds(by_ops) == pytest.approx(2.0)
