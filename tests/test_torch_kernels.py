"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the kernels are built from ``src/repro_torch/kernels/csrc`` at first
use.  Run them on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Censuses and partials are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.planner import split_device_words
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def hub_graph(n=40, hub_out=24, extra=80, seed=0):
    rng = np.random.default_rng(seed)
    src = [0] * hub_out + list(rng.integers(0, n, extra))
    dst = list(range(1, hub_out + 1)) + list(rng.integers(0, n, extra))
    return rt.from_edges(src, dst, n=max(n, hub_out + 1))


def graph_on(chunker, device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in chunker.device_arrays())


def assert_same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("w", [1, 100, 8192, 8193, 3 * 8192, 50_000])
def test_histogram_matches_plain(cuda, w):
    rng = np.random.default_rng(w)
    tri = torch.from_numpy(rng.integers(-3, 70, w).astype(np.int32))
    mask = torch.from_numpy(rng.random(w) < 0.7)
    got = ops.tricode_histogram(tri.to(cuda), mask.to(cuda))
    want = ops.tricode_histogram(tri, mask)          # plain, on the CPU
    assert_same([got], [want])
    masked = torch.where(mask, tri, 64)
    assert int(got.sum()) == int(((masked >= 0) & (masked < 64)).sum())


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("prune_self", [True, False])
@pytest.mark.parametrize("name, max_items", [
    ("hub", 5), ("hub", 64), ("orkut", 20_000)])
def test_fused_desc_matches_plain(cuda, orient, prune_self, name,
                                  max_items):
    """Every window, with IDX_PAD padding lanes appended to the index
    array, against the plain version on the same CUDA tensors (budgets
    of 5 items split the hub's pairs across windows)."""
    g = (hub_graph() if name == "hub"
         else rt.paper_workload("orkut", 250, 12.0, seed=0))
    ck = rt.PlanChunker(g, max_items, orient=orient, prune_self=prune_self)
    graph = graph_on(ck, cuda)
    idx = torch.cat([torch.arange(ck.chunk_shape, dtype=torch.int32),
                     torch.full((37,), ops.IDX_PAD, dtype=torch.int32)]
                    ).to(cuda)
    for k in range(ck.num_chunks):
        words = torch.from_numpy(ck.descriptors(k).device_words())
        nv, dp, dc, dw, an = split_device_words(words.to(cuda),
                                                ck.num_anchors)
        args = (*graph, dp, dc, dw, an, nv, idx, ck.space.search_iters,
                ck.desc_iters, orient, prune_self)
        assert_same(ops.fused_census_desc_partials(*args),
                    ops.fused_census_desc_partials_ref(*args))


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("max_items", [4096, None])
def test_fused_items_matches_plain(cuda, orient, max_items):
    g = rt.paper_workload("webgraph", 400, 6.0, seed=1)
    ck = rt.PlanChunker(g, max_items, orient=orient, pad_to=64)
    graph = graph_on(ck, cuda)
    for chunk in ck:
        sp = torch.from_numpy(chunk.item_sp).to(cuda)
        pv = torch.from_numpy(chunk.item_pv).to(cuda)
        args = (*graph, sp, pv, ck.space.search_iters)
        assert_same(ops.fused_census_partials(*args),
                    ops.fused_census_partials_ref(*args))


@pytest.mark.parametrize("backend", ["torch", "hist", "fused"])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_engine_on_card_matches_oracle(cuda, backend, emit, orient):
    g = rt.paper_workload("orkut", 250, 12.0, seed=3)
    want = rt.census_batagelj_mrvar(g)
    for max_items in (None, 4096):
        eng = rt.CensusEngine(device=cuda, backend=backend, emit=emit)
        np.testing.assert_array_equal(
            eng.run(g, max_items=max_items, orient=orient), want)


def test_desc_launches_count_windows(cuda):
    g = hub_graph(seed=4)
    ops.reset_launch_counts()
    eng = rt.CensusEngine(device=cuda)
    eng.run(g, max_items=11)
    assert ops.fused_census_desc_partials.launches == eng.stats.chunks > 1
    assert ops.fused_census_partials.launches == 0
    assert ops.tricode_histogram.launches == 0


def test_wrappers_reject_bad_tensors(cuda):
    tri = torch.zeros(10, dtype=torch.int64, device=cuda)
    mask = torch.ones(10, dtype=torch.bool, device=cuda)
    from repro_torch.kernels.tricode_hist import tricode_histogram_kernel
    with pytest.raises(TypeError):
        tricode_histogram_kernel(tri)
    with pytest.raises(ValueError):
        ops.tricode_histogram(tri.cpu(), mask)     # mixed devices
    with pytest.raises(ValueError):
        tricode_histogram_kernel(
            torch.zeros((2, 5), dtype=torch.int32, device=cuda))
