"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the kernels are built from ``src/repro_torch/kernels/csrc`` at first
use.  Run them on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels.py

Censuses and partials are integers: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.incremental import (affected_pair_ids,
                                          subset_descriptor_windows)
from repro_torch.core.planner import (descriptor_window,
                                     emit_items_for_pairs, pad_and_pack,
                                     split_device_words)
from repro_torch.kernels import ops
from repro_torch.kernels.census_fused import (BLOCK_ITEMS, STAGE_RUNS,
                                             census_fused_desc_probe,
                                             census_fused_items_probe,
                                             tile_desc_ranges,
                                             tile_item_stage)

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


def hold_histogram(tri, mask):
    """The kernel on CUDA views of ``tri`` and ``mask`` against the plain
    version on the CPU, one launch per call."""
    before = ops.tricode_histogram.launches
    got = ops.tricode_histogram(tri, mask)
    assert ops.tricode_histogram.launches == before + 1
    assert_same([got], [ops.tricode_histogram(tri.cpu(), mask.cpu())])
    return got


@pytest.mark.parametrize("mask_offset", [0, 1, 2, 3])
@pytest.mark.parametrize("code_offset", [1, 2, 3])
def test_histogram_misaligned_views(cuda, code_offset, mask_offset):
    """Views with a storage offset: the codes' 16-byte alignment and the
    mask's 4-byte alignment start elsewhere, equally or not."""
    rng = np.random.default_rng(10 * code_offset + mask_offset)
    w = 10_000
    tri = torch.from_numpy(rng.integers(-3, 70, w + 8).astype(np.int32))
    mask = torch.from_numpy(rng.random(w + 8) < 0.6)
    hold_histogram(tri.to(cuda)[code_offset:code_offset + w],
                   mask.to(cuda)[mask_offset:mask_offset + w])


@pytest.mark.parametrize("code", [0, 20, 63])
def test_histogram_one_bin(cuda, code):
    """Every item in one bin: the lanes' private counters never meet."""
    w = 3 * 2**16 + 5
    tri = torch.full((w,), code, dtype=torch.int32, device=cuda)
    mask = torch.ones(w, dtype=torch.bool, device=cuda)
    got = hold_histogram(tri, mask)
    assert int(got[code]) == w and int(got.sum()) == w


def test_histogram_drops_codes_outside_the_bins(cuda):
    """Codes that are negative or >= 64 are dropped where the mask is
    set, as the masked copy of the first port dropped them."""
    rng = np.random.default_rng(4)
    w = 50_000
    tri = rng.choice(np.array([-2**31, -65, -1, 64, 65, 2**31 - 1, 0, 33]),
                     w).astype(np.int32)
    mask = rng.random(w) < 0.8
    got = hold_histogram(torch.from_numpy(tri).to(cuda),
                         torch.from_numpy(mask).to(cuda))
    assert int(got.sum()) == int(((tri == 0) | (tri == 33))[mask].sum())


@pytest.mark.parametrize("w", [*range(1, 34), 1023, 1024, 1025, 4095, 4096,
                               4097, 2**20 + 3])
def test_histogram_lengths(cuda, w):
    """Lengths 1-33 (head and tail only), and around one load width
    (4 items) x threads (256) x loads in flight (4)."""
    rng = np.random.default_rng(w)
    tri = torch.from_numpy(rng.integers(-3, 70, w).astype(np.int32))
    mask = torch.from_numpy(rng.random(w) < 0.7)
    hold_histogram(tri.to(cuda), mask.to(cuda))


@pytest.mark.parametrize("dtypes", [(torch.int64, torch.uint8),
                                    (torch.int16, torch.bool)])
def test_histogram_converts_other_dtypes(cuda, dtypes):
    rng = np.random.default_rng(7)
    w = 9_000
    tri = torch.from_numpy(rng.integers(-3, 70, w)).to(dtypes[0])
    mask = torch.from_numpy(rng.integers(0, 3, w)).to(dtypes[1])
    got = ops.tricode_histogram(tri.to(cuda), mask.to(cuda))
    masked = torch.where(mask != 0, tri, 64)
    assert_same([got], [ops.tricode_histogram_ref(masked.to(torch.int32))])


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


def star_with_pendants(k=12):
    """Hub 0 with leaves 1..k, each leaf with a pendant k+i."""
    leaves = np.arange(1, k + 1)
    return rt.from_edges(np.concatenate([np.zeros(k, np.int64), leaves]),
                         np.concatenate([leaves, leaves + k]), n=2 * k + 1)


def ring(n=6000):
    """Every pair carries 4 items, so a 4096-lane tile reaches ~1,024
    descriptors: past the staging capacity."""
    v = np.arange(n)
    return rt.from_edges(v, (v + 1) % n, n=n)


def index_layout(layout, lanes, rng):
    """A flat-index array over ``lanes`` window lanes, with IDX_PAD
    padding lanes: in order, permuted, strided, shuffled within each
    tile, or in order and ending mid-tile."""
    pad = np.full(37, ops.IDX_PAD, np.int64)
    order = np.arange(lanes)
    if layout == "arange":
        idx = np.concatenate([order, pad])
    elif layout == "permuted":
        idx = rng.permutation(np.concatenate([order, pad]))
    elif layout == "strided":
        idx = np.concatenate([order[::3], pad, order[1::3], order[2::3]])
    elif layout == "tile_shuffled":
        idx = np.concatenate([order, pad])
        for lo in range(0, idx.shape[0], BLOCK_ITEMS):
            idx[lo:lo + BLOCK_ITEMS] = rng.permutation(
                idx[lo:lo + BLOCK_ITEMS])
    else:
        assert layout == "ragged_tail"
        idx = np.concatenate([order, pad[:BLOCK_ITEMS // 3]])
        idx = idx[:max(1, idx.shape[0] - BLOCK_ITEMS // 2 - 1)]
    return torch.from_numpy(idx.astype(np.int32))


def desc_windows(ck, device):
    for k in range(ck.num_chunks):
        words = torch.from_numpy(ck.descriptors(k).device_words())
        yield split_device_words(words.to(device), ck.num_anchors)


def hold_branches(graph, window, idx, orient, prune_self, want):
    """Run the kernel's probe on one window: its output must equal
    ``want`` and the branch it took per tile and per lane the staging
    rule's; returns the lanes it resolved from a stage."""
    nv, dp, dc, dw, an = window
    probe = census_fused_desc_probe(*graph, dp, dc, dw, an, nv, idx,
                                    orient, prune_self)
    assert_same((probe.out[:64], probe.out[64:]), want)
    rule = tile_desc_ranges(an, dc, nv, idx)
    assert torch.equal(probe.tile_staged, rule.staged)
    assert torch.equal(probe.lane_staged, rule.from_stage)
    return int(probe.lane_staged.sum())


def hold_desc_windows(graph, windows, idx, orient, prune_self,
                      search_iters, desc_iters):
    """Every window against the plain version on the same CUDA tensors,
    and the branches the kernel took against the staging rule; returns
    the valid lanes, and those the kernel resolved from a stage."""
    valid = staged = 0
    for window in windows:
        nv, dp, dc, dw, an = window
        args = (*graph, dp, dc, dw, an, nv, idx, search_iters, desc_iters,
                orient, prune_self)
        want = ops.fused_census_desc_partials_ref(*args)
        assert_same(ops.fused_census_desc_partials(*args), want)
        valid += int(((idx >= 0) & (idx < nv)).sum())
        staged += hold_branches(graph, window, idx, orient, prune_self,
                                want)
    return valid, staged


@pytest.mark.parametrize("layout", ["arange", "permuted", "strided",
                                    "tile_shuffled", "ragged_tail"])
@pytest.mark.parametrize("name, orient, max_items", [
    ("orkut-hub", "degree", 2**18), ("ring", "none", 2**16)])
def test_fused_desc_index_layouts(cuda, name, orient, max_items, layout):
    """The staged and the per-lane branch, bit for bit: any index
    layout on a hub graph (max degree 733) and on a ring whose tiles
    overflow the staging capacity."""
    g = (rt.paper_workload("orkut", 1000, 20.0, seed=0)
         if name == "orkut-hub" else ring())
    ck = rt.PlanChunker(g, max_items, orient=orient)
    idx = index_layout(layout, ck.chunk_shape,
                       np.random.default_rng(len(layout))).to(cuda)
    valid, staged = hold_desc_windows(
        graph_on(ck, cuda), desc_windows(ck, cuda), idx, orient, True,
        ck.space.search_iters, ck.desc_iters)
    assert valid > 0
    if name == "ring" or layout in ("permuted", "strided"):
        assert staged < valid       # lanes resolved from global memory
    else:
        assert staged == valid      # every lane from its tile's stage


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("max_items", [1, 3, 5])
def test_fused_desc_tiny_budgets(cuda, orient, max_items):
    """Windows of 1-5 items over pairs with one post-prune item."""
    ck = rt.PlanChunker(star_with_pendants(), max_items, orient=orient)
    idx = index_layout("arange", ck.chunk_shape,
                       np.random.default_rng(0)).to(cuda)
    valid, staged = hold_desc_windows(
        graph_on(ck, cuda), desc_windows(ck, cuda), idx, orient, True,
        ck.space.search_iters, ck.desc_iters)
    assert staged == valid == ck.space.num_items_preprune


@pytest.mark.parametrize("orient, prune_self", [
    ("none", False), ("none", True), ("degree", True)])
def test_fused_desc_subset_windows(cuda, orient, prune_self):
    """Session windows (arbitrary pair ids: the affected pairs of a
    delta) under each of the three keep modes."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    rng = np.random.default_rng(3)
    _, delta = rt.apply_delta(g, rng.integers(0, g.n, 40),
                              rng.integers(0, g.n, 40))
    ck = rt.PlanChunker(g, 2**16, orient=orient, prune_self=prune_self)
    pairs = affected_pair_ids(ck.space, delta.touched)
    wins = [split_device_words(torch.from_numpy(w.device_words()).to(cuda),
                               ck.num_anchors)
            for w in subset_descriptor_windows(
                ck.space, pairs, ck.chunk_shape, ck.chunk_shape // 2 + 1,
                ck.num_anchors)]
    idx = index_layout("arange", ck.chunk_shape,
                       np.random.default_rng(0)).to(cuda)
    valid, staged = hold_desc_windows(
        graph_on(ck, cuda), wins, idx, orient, prune_self,
        ck.space.search_iters, ck.desc_iters)
    assert len(wins) > 1 and staged == valid


def test_fused_desc_inexact_anchors(cuda):
    """Anchors that undershoot (not the last descriptor at their index):
    the kernel keeps the anchored search's answer, wherever the plain
    version's gathers stay in bounds (checked on the CPU first), and
    leaves the tiles over such anchors unstaged."""
    g = rt.paper_workload("webgraph", 400, 6.0, seed=0)
    ck = rt.PlanChunker(g, 20_000)
    graph = [torch.from_numpy(a) for a in ck.device_arrays()]
    idx = torch.arange(ck.chunk_shape, dtype=torch.int32)
    held = 0
    for k in range(ck.num_chunks):
        nv, dp, dc, dw, an = (torch.from_numpy(a) for a in split_device_words(
            ck.descriptors(k).device_words(), ck.num_anchors))
        for shift in (1, 2, 5, 20, 40):
            bad = (an - shift).clamp(min=0)
            args = [*graph, dp, dc, dw, bad, nv, idx]
            rest = (ck.space.search_iters, ck.desc_iters, "none", True)
            try:
                want = ops.fused_census_desc_partials_ref(*args, *rest)
            except IndexError:
                continue            # a slot past the packed array
            on_card = [t.to(cuda) for t in args]
            assert_same(ops.fused_census_desc_partials(*on_card, *rest),
                        want)
            dp_c, dc_c, dw_c, an_c, nv_c, idx_c = on_card[5:]
            hold_branches(on_card[:5], (nv_c, dp_c, dc_c, dw_c, an_c),
                          idx_c, "none", True, want)
            held += 1
    assert held > 0


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


def hold_items(graph, sp, pv, search_iters):
    """Host items against the plain version on the same CUDA tensors,
    through the wrapper and through the kernel's probe, whose branch per
    tile and per lane must be the staging rule's; returns the valid lanes
    and those the kernel resolved from staged rows."""
    args = (*graph, sp, pv, search_iters)
    want = ops.fused_census_partials_ref(*args)
    assert_same(ops.fused_census_partials(*args), want)
    probe = census_fused_items_probe(*graph, sp, pv)
    assert_same((probe.out[:64], probe.out[64:66]), want)
    assert int(probe.out[66]) == 0
    rule = tile_item_stage(pv, graph[0], graph[2], graph[3])
    assert torch.equal(probe.tile_staged, rule.staged)
    assert torch.equal(probe.lane_staged, rule.from_stage)
    return int((pv & 1).sum()), int(probe.lane_staged.sum())


def item_layout(layout, sp, pv, rng):
    """Host item words in order, shuffled, strided, with zero padding
    words between them, or at an odd storage offset."""
    n = sp.shape[0]
    if layout == "in_order":
        return sp, pv
    if layout == "shuffled":
        order = torch.from_numpy(rng.permutation(n))
    elif layout == "strided":
        order = torch.cat([torch.arange(k, n, 7) for k in range(7)])
    elif layout == "zero_words":
        zeros = torch.zeros(n, dtype=torch.int32, device=sp.device)
        return (torch.stack([sp, zeros], 1).reshape(-1),
                torch.stack([pv, zeros], 1).reshape(-1))
    else:
        assert layout == "offset"
        pad = torch.zeros(1, dtype=torch.int32, device=sp.device)
        return torch.cat([pad, sp])[1:], torch.cat([pad, pv])[1:]
    order = order.to(sp.device)
    return sp[order].contiguous(), pv[order].contiguous()


@pytest.mark.parametrize("layout", ["in_order", "shuffled", "strided",
                                    "zero_words", "offset"])
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_fused_items_layouts(cuda, orient, layout):
    """The staged and the global branch, bit for bit: host items in any
    order on a hub graph, with pairs split across tiles; shuffled and
    strided items put more than STAGE_RUNS runs in a tile."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    ck = rt.PlanChunker(g, 2**16, orient=orient)
    graph = graph_on(ck, cuda)
    rng = np.random.default_rng(len(layout))
    valid = staged = 0
    for chunk in ck:
        sp, pv = (torch.from_numpy(a).to(cuda)
                  for a in (chunk.item_sp, chunk.item_pv))
        v, st = hold_items(graph, *item_layout(layout, sp, pv, rng),
                           ck.space.search_iters)
        valid += v
        staged += st
    assert valid > 0
    if layout in ("shuffled", "strided"):
        assert staged < valid
    else:
        assert staged > 0.5 * valid


def test_fused_items_split_pairs(cuda):
    """Pairs whose runs cross a tile boundary are staged in both tiles
    (where their rows fit)."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    ck = rt.PlanChunker(g, 2**16)
    graph = graph_on(ck, cuda)
    chunk = ck.chunk(0)
    pv = torch.from_numpy(chunk.item_pv).to(cuda)
    edges = pv[BLOCK_ITEMS - 1::BLOCK_ITEMS]
    split = int((edges[:-1] == pv[BLOCK_ITEMS::BLOCK_ITEMS][:len(edges) - 1]
                 ).sum())
    assert split > 0
    valid, staged = hold_items(
        graph, torch.from_numpy(chunk.item_sp).to(cuda), pv,
        ck.space.search_iters)
    assert staged > 0.5 * valid


@pytest.mark.parametrize("orient", ["none", "degree"])
def test_fused_items_session_order(cuda, orient):
    """Items of a delta's affected pairs in the session's order."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    rng = np.random.default_rng(3)
    _, delta = rt.apply_delta(g, rng.integers(0, g.n, 40),
                              rng.integers(0, g.n, 40))
    ck = rt.PlanChunker(g, None, orient=orient)
    pairs = affected_pair_ids(ck.space, delta.touched)
    rng.shuffle(pairs)
    pair, slot, side = emit_items_for_pairs(ck.space, pairs)
    sp, pv = pad_and_pack(pair, slot, side, pair.shape[0] + 100)
    valid, staged = hold_items(graph_on(ck, cuda),
                               torch.from_numpy(sp).to(cuda),
                               torch.from_numpy(pv).to(cuda),
                               ck.space.search_iters)
    assert valid == pair.shape[0] > BLOCK_ITEMS
    assert staged > 0.5 * valid


@pytest.mark.parametrize("orient", ["none", "degree"])
def test_fused_items_hub_past_capacity(cuda, orient):
    """Three pairs of a hub of 8,300 arcs between 400 small pairs: the
    hub pairs' rows exceed the row buffer, so their lanes resolve from
    global memory; the small pairs' lanes still stage."""
    n = 8600
    rng = np.random.default_rng(3)
    g = rt.from_edges(
        np.concatenate([np.zeros(8300, np.int64), rng.integers(0, n, 3000)]),
        np.concatenate([np.arange(1, 8301), rng.integers(0, n, 3000)]), n=n)
    ck = rt.PlanChunker(g, None, orient=orient)
    space = ck.space
    hub = np.flatnonzero(space.pair_u == 0)[:3]
    small = np.flatnonzero(space.pair_u != 0)[:400]
    pair, slot, side = emit_items_for_pairs(
        space, np.concatenate([small[:200], hub, small[200:]]))
    sp, pv = pad_and_pack(pair, slot, side, pair.shape[0])
    valid, staged = hold_items(graph_on(ck, cuda),
                               torch.from_numpy(sp).to(cuda),
                               torch.from_numpy(pv).to(cuda),
                               space.search_iters)
    assert 0 < staged < valid


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("max_items", [1, 3, 5])
def test_fused_items_tiny_budgets(cuda, orient, max_items):
    """Windows of 1-5 items over pairs with one post-prune item."""
    ck = rt.PlanChunker(star_with_pendants(), max_items, orient=orient)
    graph = graph_on(ck, cuda)
    for chunk in ck:
        valid, staged = hold_items(
            graph, torch.from_numpy(chunk.item_sp).to(cuda),
            torch.from_numpy(chunk.item_pv).to(cuda), ck.space.search_iters)
        assert staged == valid


def test_items_rule_counts_runs(cuda):
    """A tile of more than STAGE_RUNS runs records none of them."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    ck = rt.PlanChunker(g, 2**16)
    chunk = ck.chunk(0)
    pv = torch.from_numpy(chunk.item_pv).to(cuda)
    pv = pv[torch.randperm(pv.shape[0], device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))]
    indptr, _, pair_u, pair_v, _ = graph_on(ck, cuda)
    rule = tile_item_stage(pv, indptr, pair_u, pair_v)
    assert bool((rule.runs[rule.live] > STAGE_RUNS).all())
    assert not bool(rule.from_stage.any())


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
        tricode_histogram_kernel(tri, mask)
    with pytest.raises(TypeError):
        tricode_histogram_kernel(tri.int(), mask.to(torch.uint8))
    with pytest.raises(ValueError):
        ops.tricode_histogram(tri.cpu(), mask)     # mixed devices
    with pytest.raises(ValueError):
        tricode_histogram_kernel(
            torch.zeros((2, 5), dtype=torch.int32, device=cuda),
            mask.reshape(2, 5))
    with pytest.raises(ValueError):
        tricode_histogram_kernel(tri.int(), mask[:9])


def code_tiles(rng, b, hit_rate, dup=False):
    """(q, k, kc) int32 (b, 128) tiles: sorted unique keys (or, with
    ``dup``, unsorted repeated keys and codes that wrap int32)."""
    if dup:
        k = rng.integers(0, 6, size=(b, 128))
        kc = rng.integers(-2**31, 2**31, size=(b, 128))
        q = rng.integers(-1, 7, size=(b, 128))
    else:
        k = np.sort(rng.random((b, 128)).argsort(axis=1)[:, :128]
                    + 200 * np.arange(128), axis=1)
        k[:, 100:] = np.where(rng.random((b, 1)) < 0.2, -1, k[:, 100:])
        kc = rng.integers(1, 4, size=(b, 128))
        take = rng.random((b, 128)) < hit_rate
        q = np.where(take, k, -5 - rng.integers(0, 100, size=(b, 128)))
    return tuple(torch.from_numpy(a.astype(np.int32)) for a in (q, k, kc))


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("hit_rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("b", [1, 7, 8, 33, 65_537])
def test_pair_codes_matches_plain(cuda, b, hit_rate, dup):
    rng = np.random.default_rng(b + int(10 * hit_rate) + 1000 * dup)
    tiles = code_tiles(rng, b, hit_rate, dup)
    before = ops.pair_codes.launches
    got = ops.pair_codes(*(t.to(cuda) for t in tiles))
    assert ops.pair_codes.launches == before + 1
    # plain, on the CPU, in row blocks: (B, 128, 128) temporaries
    want = torch.cat([ops.pair_codes(*(t[i:i + 4096] for t in tiles))
                      for i in range(0, b, 4096)])
    assert_same([got], [want])
    assert tuple(got.shape) == (b, 128)


def test_pair_codes_rejects_bad_tiles(cuda):
    t = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    from repro_torch.kernels.pair_codes import pair_codes_kernel
    with pytest.raises(ValueError):
        pair_codes_kernel(t, t, t[:, :64].contiguous())
    with pytest.raises(TypeError):
        pair_codes_kernel(t, t.long(), t)
    with pytest.raises(ValueError):
        pair_codes_kernel(t, t[:3], t)
    with pytest.raises(ValueError):
        pair_codes_kernel(t.t(), t, t)               # not (B, 128)
    # (B, 128) views that are not row-major raise before any launch
    wide = torch.zeros((4, 256), dtype=torch.int32, device=cuda)
    square = torch.arange(128 * 128, dtype=torch.int32,
                          device=cuda).reshape(128, 128)
    for bad in (wide[:, :128], wide[:, 128:], square.t()):
        before = ops.pair_codes.launches
        with pytest.raises(ValueError, match="contiguous"):
            ops.pair_codes(bad, bad.contiguous(), bad.contiguous())
        with pytest.raises(ValueError, match="contiguous"):
            ops.pair_codes(bad.contiguous(), bad.contiguous(), bad)
        assert ops.pair_codes.launches == before
    empty = torch.zeros((0, 128), dtype=torch.int32, device=cuda)
    before = ops.pair_codes.launches
    assert ops.pair_codes(empty, empty, empty).shape == (0, 128)
    assert ops.pair_codes.launches == before


def session_stream(g, seed):
    """Empty, random, deletion-heavy and row-growing deltas."""
    rng = np.random.default_rng(seed)
    empty = np.zeros(0, np.int64)
    src, dst = np.nonzero(rt.to_dense(g))
    take = rng.random(src.shape[0]) < 0.4
    hub = int(rng.integers(0, g.n))
    spokes = rng.choice(g.n, min(int(g.degrees.max()) + 3, g.n),
                        replace=False)
    return [(empty, empty, empty, empty),
            (rng.integers(0, g.n, 8), rng.integers(0, g.n, 8),
             rng.integers(0, g.n, 8), rng.integers(0, g.n, 8)),
            (empty, empty, src[take], dst[take]),
            (np.full(spokes.shape[0], hub), spokes, empty, empty)]


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("max_items", [None, 37])
def test_fused_session_on_card_matches_cpu(cuda, emit, orient, max_items):
    """A fused session on the card and a plain one on the CPU, over the
    same deltas: equal censuses and stats after every step, each update
    launching its kernel once per dispatch."""
    g = rt.paper_workload("orkut", 120, 8.0, seed=5)
    sessions = [rt.CensusEngine(device=d, backend="fused").session(
        g, orient=orient, max_items=max_items, emit=emit)
        for d in (cuda, "cpu")]
    kernel = (ops.fused_census_desc_partials if emit == "device"
              else ops.fused_census_partials)
    gg = g
    for k, delta in enumerate([None] + session_stream(g, seed=7)):
        before = kernel.launches
        if delta is None:
            got = [s.census() for s in sessions]
        else:
            got = [s.update(*delta) for s in sessions]
            gg, _ = rt.apply_delta(gg, *delta)
        assert kernel.launches - before == sessions[0].stats.chunks
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], rt.census_batagelj_mrvar(gg))
        for field in ("chunks", "chunk_items", "items", "full_items",
                      "affected_pairs", "desc_shape", "plan_upload_bytes"):
            assert getattr(sessions[0].stats, field) == \
                getattr(sessions[1].stats, field), (k, field)
    assert sessions[0].stats.chunks > 0


def shard_schedule(g, max_items, orient="none", mesh=None, shards=4):
    """The windows of a partitioned run: one ``ShardSchedule`` over the
    shards (or 2D tiles) of ``g``."""
    from repro_torch.core.partition import (partition_graph,
                                            partition_graph_2d)
    space = rt.pair_space(g, orient=orient)
    part = (partition_graph(num_shards=shards, space=space) if mesh is None
            else partition_graph_2d(space=space, mesh_shape=mesh))
    sched = rt.ShardSchedule([sh.space for sh in part.shards], max_items,
                             len(part.shards), mesh_shape=mesh)
    return part, sched


def hold_batch(graph, batch, idx, orient, search_iters, desc_iters,
               real=None):
    """One megastep launch on a (K, words) batch against the plain
    version and, row for row, against single-window launches of each
    row (zero rows: zeros, and no single launch).  With ``real``, only
    the first ``real`` rows are the batch's: every row past them comes
    back zero, whatever it holds."""
    args = (search_iters, desc_iters, orient, True)
    before = ops.fused_census_desc_partials_batch.launches
    got = ops.fused_census_desc_partials_batch(*graph, batch, idx, *args,
                                               real=real)
    assert ops.fused_census_desc_partials_batch.launches == before + 1
    want = ops.fused_census_desc_partials_batch_ref(*graph, batch, idx,
                                                    *args, real=real)
    assert_same(got, want)
    assert got[0].shape == (batch.shape[0], 64)
    assert got[1].shape == (batch.shape[0], 3)
    rows = batch.shape[0] if real is None else real
    assert not bool(got[0][rows:].any()) and not bool(got[1][rows:].any())
    anchors = ck_anchors(idx)
    for r in range(rows):
        if int(batch[r, 0]) == 0:
            assert not bool(got[0][r].any()) and not bool(got[1][r].any())
            continue
        nv, dp, dc, dw, an = split_device_words(batch[r], anchors)
        single = ops.fused_census_desc_partials(*graph, dp, dc, dw, an, nv,
                                                idx, *args)
        assert_same((got[0][r], got[1][r]), single)
    return got


def ck_anchors(idx):
    from repro_torch.core.planner import num_desc_anchors
    return num_desc_anchors(idx.shape[0])


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_desc_batch_matches_singles(cuda, k, orient):
    """K full rows of one shard's windows (a hub graph's 1D shards)."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    part, sched = shard_schedule(g, 2**16, orient)
    graph = tuple(torch.from_numpy(a[0]).to(cuda)
                  for a in rt.stacked_device_arrays(part.shards))
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=cuda)
    rows = [sched.descriptors(0, j).device_words()
            for j in range(sched.steps_for(0))]
    assert len(rows) >= 8
    batch = torch.from_numpy(np.stack(rows[:k])).to(cuda)
    hold_batch(graph, batch, idx, orient, part.space.search_iters,
               sched.desc_iters)


def test_desc_batch_zero_rows(cuda):
    """A 5-of-8 batch as the batcher pads it (rows 5-7 all zero), and
    zero rows between real ones."""
    g = rt.paper_workload("orkut", 600, 12.0, seed=2)
    part, sched = shard_schedule(g, 3000)
    graph = tuple(torch.from_numpy(a[1]).to(cuda)
                  for a in rt.stacked_device_arrays(part.shards))
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=cuda)
    rows = [sched.descriptors(1, j).device_words()
            for j in range(sched.steps_for(1))]
    buf, real = next(rt.WindowBatcher(8, rows[0].shape[0]).wrap(rows[:5]))
    assert real == 5
    hold_batch(graph, torch.from_numpy(buf).to(cuda), idx, "none",
               part.space.search_iters, sched.desc_iters)
    gappy = np.zeros_like(buf)
    gappy[1], gappy[4], gappy[6] = rows[0], rows[1], rows[2]
    got = hold_batch(graph, torch.from_numpy(gappy).to(cuda), idx, "none",
                     part.space.search_iters, sched.desc_iters)
    assert int(got[1][:, 2].sum()) > 0


@pytest.mark.parametrize("max_items", [1, 2, 3, 4, 5])
def test_desc_batch_2d_tiles_tiny_budgets(cuda, max_items):
    """2D tiles hold pairs with a single in-slice item; at budgets of
    1-5 items (per device: the budget over 4 tiles, at least 1) every
    row of every tile's batches, held as above."""
    g = star_with_pendants()
    for orient in ("none", "degree"):
        part, sched = shard_schedule(g, max_items, orient, mesh=(2, 2))
        arrays = rt.stacked_device_arrays(part.shards)
        idx = torch.arange(sched.chunk_shape, dtype=torch.int32,
                           device=cuda)
        words = 1 + 3 * sched.desc_shape + sched.num_anchors
        for s in range(len(part.shards)):
            graph = tuple(torch.from_numpy(a[s]).to(cuda) for a in arrays)
            rows = (sched.descriptors(s, j).device_words()
                    for j in range(sched.steps_for(s)))
            for buf, _ in rt.WindowBatcher(4, words).wrap(rows):
                hold_batch(graph, torch.from_numpy(buf).to(cuda), idx,
                           orient, part.space.search_iters,
                           sched.desc_iters)


def test_desc_batch_rejects_bad_batches(cuda):
    g = hub_graph()
    part, sched = shard_schedule(g, 40, shards=2)
    graph = tuple(torch.from_numpy(a[0]).to(cuda)
                  for a in rt.stacked_device_arrays(part.shards))
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=cuda)
    row = sched.descriptors(0, 0).device_words()
    batch = torch.from_numpy(np.stack([row, row])).to(cuda)
    args = (part.space.search_iters, sched.desc_iters, "none", True)
    before = ops.fused_census_desc_partials_batch.launches
    for bad in (batch[:, :-1], batch.t(), batch.long(), batch[0],
                batch[:0], batch.cpu()):
        with pytest.raises((ValueError, TypeError)):
            ops.fused_census_desc_partials_batch(*graph, bad, idx, *args)
    assert ops.fused_census_desc_partials_batch.launches == before


def stale_batch(rows, real, stale, cap=8):
    """A (cap, words) int32 batch: ``rows[:real]`` first, then the
    ``stale`` windows' words (an earlier batch left on the card) or
    zeros (as the batcher pads)."""
    buf = np.zeros((cap, rows[0].shape[0]), np.int32)
    buf[:real] = rows[:real]
    for r, words in zip(range(real, cap), stale):
        buf[r] = words
    return torch.from_numpy(buf)


def shard0_rows(cuda, max_items=2**16, orient="none"):
    """Shard 0 of a hub graph's 1D partition over 4: its resident arrays
    on the card, its window rows and the schedule."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    part, sched = shard_schedule(g, max_items, orient)
    graph = tuple(torch.from_numpy(a[0]).to(cuda)
                  for a in rt.stacked_device_arrays(part.shards))
    rows = [sched.descriptors(0, j).device_words()
            for j in range(sched.steps_for(0))]
    return part, sched, graph, rows


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("k", list(range(1, 9)))
def test_desc_batch_real_rows(cuda, k, stale):
    """K = 1..8 real rows of a cap-8 buffer, launched as K rows: the
    rows past them zero (as the batcher pads) or holding later windows
    (as an earlier batch leaves the device buffer), which the launch
    must not read."""
    part, sched, graph, rows = shard0_rows(cuda)
    assert len(rows) >= 9
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=cuda)
    batch = stale_batch(rows, k, rows[:k - 9:-1] if stale else ())
    hold_batch(graph, batch.to(cuda), idx, "none", part.space.search_iters,
               sched.desc_iters, real=k)


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("end", ["mid_tile", "tile_boundary"])
def test_desc_batch_last_window(cuda, end, orient):
    """A shard's last window, whose valid count ends mid-tile (lanes of
    one tile past it, tiles after it with none) or exactly on a tile
    boundary, alone and behind two full windows of 5 tiles each."""
    g = rt.paper_workload("orkut", 1000, 20.0, seed=0)
    chunk = 5 * BLOCK_ITEMS
    ck = rt.PlanChunker(g, chunk, orient=orient)
    last = 2 * BLOCK_ITEMS + (1234 if end == "mid_tile" else 0)
    rows = [descriptor_window(ck.space.offsets, lo, hi, ck.desc_shape,
                              ck.num_anchors).device_words()
            for lo, hi in ((0, chunk), (chunk, 2 * chunk),
                           (2 * chunk, 2 * chunk + last))]
    assert int(rows[2][0]) == last
    idx = torch.arange(chunk, dtype=torch.int32, device=cuda)
    graph = graph_on(ck, cuda)
    iters = (ck.space.search_iters, ck.desc_iters)
    hold_batch(graph, stale_batch(rows[2:], 1, rows[:2]).to(cuda), idx,
               orient, *iters, real=1)
    hold_batch(graph, stale_batch(rows, 3, rows).to(cuda), idx, orient,
               *iters, real=3)


@pytest.mark.parametrize("layout", ["permuted", "shifted", "padded"])
def test_desc_batch_scattered_idx(cuda, layout):
    """An index array that is no run -- permuted, shifted up by 5 (its
    top lanes past every valid count) or in order with its last 37 lanes
    IDX_PAD -- takes the per-lane loads in every row."""
    part, sched, graph, rows = shard0_rows(cuda)
    order = np.arange(sched.chunk_shape, dtype=np.int64)
    padded = order.copy()
    padded[-37:] = ops.IDX_PAD
    idx = {"permuted": np.random.default_rng(3).permutation(order),
           "shifted": order + 5, "padded": padded}[layout]
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    batch = stale_batch(rows, 5, rows[5:8]).to(cuda)
    hold_batch(graph, batch, idx, "none", part.space.search_iters,
               sched.desc_iters, real=5)


@pytest.mark.parametrize("max_items", [1, 2, 3, 4, 5])
def test_desc_batch_2d_tiles_real_rows(cuda, max_items):
    """2D tiles at budgets of 1-5 items, both orients: each batch as the
    batcher builds it, launched on its real rows with the rows past them
    holding the tile's previous batch, as the device buffer would."""
    g = star_with_pendants()
    for orient in ("none", "degree"):
        part, sched = shard_schedule(g, max_items, orient, mesh=(2, 2))
        arrays = rt.stacked_device_arrays(part.shards)
        idx = torch.arange(sched.chunk_shape, dtype=torch.int32,
                           device=cuda)
        words = 1 + 3 * sched.desc_shape + sched.num_anchors
        for s in range(len(part.shards)):
            graph = tuple(torch.from_numpy(a[s]).to(cuda) for a in arrays)
            rows = (sched.descriptors(s, j).device_words()
                    for j in range(sched.steps_for(s)))
            before = np.zeros((4, words), np.int32)
            for buf, real in rt.WindowBatcher(4, words).wrap(rows):
                batch = buf.copy()
                batch[real:] = before[real:]
                hold_batch(graph, torch.from_numpy(batch).to(cuda), idx,
                           orient, part.space.search_iters,
                           sched.desc_iters, real=real)
                before = batch


def test_desc_batch_refuses_bad_real_counts(cuda):
    """A real count of 0, past the buffer's rows, or not an integer
    raises before any launch."""
    part, sched, graph, rows = shard0_rows(cuda, max_items=40 * 4096)
    idx = torch.arange(sched.chunk_shape, dtype=torch.int32, device=cuda)
    batch = torch.from_numpy(np.stack(rows[:2])).to(cuda)
    args = (part.space.search_iters, sched.desc_iters, "none", True)
    before = ops.fused_census_desc_partials_batch.launches
    for bad in (0, -1, 3, 1.5, True):
        with pytest.raises(ValueError, match="real windows"):
            ops.fused_census_desc_partials_batch(*graph, batch, idx, *args,
                                                 real=bad)
    assert ops.fused_census_desc_partials_batch.launches == before


def test_partial_batches_on_card_match_cpu(cuda):
    """A 1D async run whose 4 shards hold 1, 2, 3 and 5 windows (a
    megastep cap of 5: partial batches on every shard but one) on the
    card against the CPU, both orients: equal censuses and stats, one
    launch per dispatch, each of its batch's real rows only."""
    from torch_partition_cases import windows_owner
    g = rt.paper_workload("orkut", 600, 12.0, seed=4)
    for orient in ("none", "degree"):
        space = rt.pair_space(g, orient=orient)
        owner, max_items = windows_owner(space)
        part = rt.partition_graph(num_shards=4, space=space, owner=owner)
        runs = []
        for devices in (rt.default_devices(4), rt.default_devices(4, "cpu")):
            ops.reset_launch_counts()
            eng = rt.CensusEngine(devices=devices, backend="fused",
                                  partition=True, schedule="async")
            runs.append((eng.run(g, max_items=max_items, part=part),
                         eng.stats,
                         ops.fused_census_desc_partials_batch.launches))
        (got, st, launches), (want, cpu_st, _) = runs
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g))
        assert st.shard_steps == cpu_st.shard_steps == [1, 2, 3, 5]
        for field in ("items", "shard_items", "plan_upload_bytes_total",
                      "dispatch_batch_limit", "chunks"):
            assert getattr(st, field) == getattr(cpu_st, field), field
        assert sorted(st.chunk_items) == sorted(cpu_st.chunk_items)
        assert launches == st.dispatches_total > 0


@pytest.mark.parametrize("schedule, mesh", [
    ("async", None), ("lockstep", None), ("async", (2, 2))])
@pytest.mark.parametrize("emit", ["device", "host"])
def test_partitioned_run_on_card_matches_cpu(cuda, schedule, mesh, emit):
    """A partitioned run over 4 logical devices on the card (4 streams
    on one card) against the same run on the CPU: equal censuses and
    deterministic stats; the megastep's launches equal the async run's
    dispatches, the single-window kernel's the lock-step windows."""
    g = rt.paper_workload("orkut", 600, 12.0, seed=4)
    kw = dict(partition=True) if mesh is None else dict(partition_2d=mesh)
    runs = []
    for devices in (rt.default_devices(4), rt.default_devices(4, "cpu")):
        ops.reset_launch_counts()
        eng = rt.CensusEngine(devices=devices, backend="fused", emit=emit,
                              schedule=schedule, **kw)
        runs.append((eng.run(g, max_items=3000, orient="degree"),
                     eng.stats,
                     ops.fused_census_desc_partials_batch.launches,
                     ops.fused_census_desc_partials.launches,
                     ops.fused_census_partials.launches))
    (got, st, batch, single, items), (want, cpu_st, *_) = runs
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(g))
    for field in ("items", "shard_steps", "shard_items", "idle_steps",
                  "plan_upload_bytes_total", "graph_resident_bytes",
                  "dispatch_batch_limit"):
        assert getattr(st, field) == getattr(cpu_st, field), field
    assert sorted(st.chunk_items) == sorted(cpu_st.chunk_items)
    if emit == "host":
        assert batch == single == 0 and items > 0
    elif schedule == "async":
        assert batch == st.dispatches_total > 0 and single == items == 0
    else:
        assert single == st.dispatches_total * 4 and batch == items == 0


def test_default_devices_share_one_card(cuda):
    devs = rt.default_devices(4)
    count = torch.cuda.device_count()
    assert [d.device for d in devs] == [torch.device("cuda", i % count)
                                        for i in range(4)]
    assert len({d.stream.cuda_stream for d in devs}) == 4


def faulty_plan(k=4, seed=3):
    return rt.FaultPlan.seeded(seed, k, producer_errors=1,
                               dispatch_errors=1, retire_devices=1,
                               poisons=1)


@pytest.mark.parametrize("emit", ["device", "host"])
def test_faulted_async_run_on_card(cuda, emit):
    """A seeded faulty async run over 4 logical devices on the card: the
    fault-free census, a retired lane, and a kernel launch for every
    dispatch, retries included (a poisoned window launches again)."""
    g = rt.paper_workload("orkut", 600, 12.0, seed=4)
    want = rt.CensusEngine(device="cpu", backend="torch").run(
        g, max_items=3000)
    ops.reset_launch_counts()
    eng = rt.CensusEngine(devices=rt.default_devices(4), backend="fused",
                          partition=True, emit=emit, faults=faulty_plan(),
                          retry_backoff=0.0)
    got = eng.run(g, max_items=3000)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, want)
    st = eng.stats
    assert st.failovers == 1 and len(st.retired_devices) == 1
    assert st.retries >= 1
    kernel = (ops.fused_census_desc_partials_batch if emit == "device"
              else ops.fused_census_partials)
    assert kernel.launches >= st.dispatches_total > 0
    # nothing ran on another kernel or on the plain version
    assert ops.fused_census_desc_partials.launches == 0


def test_every_lane_retired_raises_on_card(cuda):
    g = rt.paper_workload("orkut", 300, 8.0, seed=1)
    plan = rt.FaultPlan(faults=[
        rt.Fault("dispatch", "error", device=d, occurrence=0,
                 persistent=True) for d in range(2)])
    eng = rt.CensusEngine(devices=rt.default_devices(2), partition=True,
                          faults=plan, retry_backoff=0.0)
    with pytest.raises(rt.FaultError, match="every device"):
        eng.run(g, max_items=1000)


def test_checkpoint_resume_on_card(cuda, tmp_path):
    """A checkpointed run on the card stopped after half its windows and
    resumed: the uninterrupted census, the journal's windows skipped."""
    g = rt.paper_workload("orkut", 600, 12.0, seed=4)
    want = rt.census_batagelj_mrvar(g)
    ck = str(tmp_path / "run.ckpt")
    eng = rt.CensusEngine(devices=rt.default_devices(4), partition=True)

    def stop(done, total, num):
        if done + 1 >= total // 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        eng.run(g, max_items=3000, checkpoint=ck, progress=stop)
    torch.cuda.synchronize()
    info = rt.CensusEngine.compact_checkpoint(ck)
    assert info["compacted_bytes"] <= info["bytes"]
    ops.reset_launch_counts()
    got = eng.resume(g, ck, max_items=3000)
    np.testing.assert_array_equal(got, want)
    st = eng.stats
    assert st.resumed_windows >= 1
    assert ops.fused_census_desc_partials_batch.launches == \
        st.dispatches_total > 0


def drive_sessions(sessions, g, stream, kernel):
    """Census then each delta on every session: equal censuses and
    stats, the card's session launching once per dispatch (a replicated
    session once per dispatch on each lane)."""
    gg = g
    for k, delta in enumerate([None] + stream):
        before = kernel.launches
        if delta is None:
            got = [s.census() for s in sessions]
        else:
            got = [s.update(*delta) for s in sessions]
            gg, _ = rt.apply_delta(gg, *delta)
        st = sessions[0].stats
        lanes = 1 if st.partitioned else st.ndev
        assert kernel.launches - before == st.chunks * lanes
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], rt.census_batagelj_mrvar(gg))
        for field in ("chunks", "chunk_items", "items", "full_items",
                      "affected_pairs", "shard_items", "desc_shape",
                      "plan_upload_bytes", "graph_resident_bytes"):
            assert getattr(sessions[0].stats, field) == \
                getattr(sessions[1].stats, field), (k, field)
        if hasattr(sessions[0], "load_max_over_mean"):
            assert sessions[0].load_max_over_mean == \
                sessions[1].load_max_over_mean
    assert sessions[0].stats.chunks > 0


@pytest.mark.parametrize("layout", ["1d", "2d", "replicated"])
@pytest.mark.parametrize("emit", ["device", "host"])
def test_multidevice_session_on_card_matches_cpu(cuda, layout, emit):
    """Partitioned (1D over 4, 2D (2, 2)) and replicated (over 2)
    sessions on the card against the same sessions on the CPU."""
    g = rt.paper_workload("orkut", 160, 8.0, seed=5)
    kw, k = {"1d": (dict(partition=True), 4),
             "2d": (dict(partition_2d=(2, 2)), 4),
             "replicated": (dict(), 2)}[layout]
    sessions = [rt.CensusEngine(devices=devices, backend="fused",
                                emit=emit, **kw).session(
        g, max_items=401, emit=emit)
        for devices in (rt.default_devices(k), rt.default_devices(k, "cpu"))]
    kernel = (ops.fused_census_desc_partials if emit == "device"
              else ops.fused_census_partials)
    drive_sessions(sessions, g, session_stream(g, seed=3), kernel)


@pytest.mark.parametrize("max_items", [1, 2, 3, 4, 5])
def test_2d_session_tiles_tiny_budgets_on_card(cuda, max_items):
    """2D session tiles whose pairs keep one item, at budgets of 1-5
    items, on the card against the CPU."""
    k = 12
    leaves = np.arange(1, k + 1)
    g = rt.from_edges(np.concatenate([np.zeros(k, np.int64), leaves]),
                      np.concatenate([leaves, leaves + k]), n=2 * k + 1)
    sessions = [rt.CensusEngine(devices=devices, backend="fused",
                                partition_2d=(2, 2)).session(
        g, max_items=max_items)
        for devices in (rt.default_devices(4), rt.default_devices(4, "cpu"))]
    stream = [([0, 3], [13, 20], [2], [14])]
    drive_sessions(sessions, g, stream, ops.fused_census_desc_partials)


def test_session_faults_on_card(cuda):
    """A partitioned session on the card retries an injected error and a
    poisoned window (which launches again) to the CPU's census."""
    g = rt.paper_workload("orkut", 160, 8.0, seed=5)
    plan = rt.FaultPlan(faults=[
        rt.Fault("dispatch", "error", occurrence=1),
        rt.Fault("dispatch", "poison", occurrence=2)])
    s = rt.CensusEngine(devices=rt.default_devices(4), partition=True,
                        faults=plan, retry_backoff=0.0).session(
        g, max_items=401)
    before = ops.fused_census_desc_partials.launches
    np.testing.assert_array_equal(s.census(), rt.census_batagelj_mrvar(g))
    assert s.retries >= 2
    assert ops.fused_census_desc_partials.launches - before > s.stats.chunks


def network_monitor_example():
    """``examples/network_monitor_torch.py``, loaded as the smoke loads
    it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import load_example
    return load_example("network_monitor_torch")


#: the example's scenario at its default window and a sliding stride
MONITOR_SCENARIO = dict(window=1200, windows=28, stride=600)


@pytest.mark.parametrize("backend,emit", [("fused", "device"),
                                          ("fused", "host"),
                                          ("hist", None)])
def test_network_monitor_on_card_matches_cpu(cuda, backend, emit):
    """The example's monitor on the card equals the plain torch monitor
    on the CPU in censuses, proportions, alarms and per-window stats,
    launching the path's kernel, with an alarm on the injected scans."""
    example = network_monitor_example()
    want, spans = example.run(backend="torch", device="cpu", emit=emit,
                              **MONITOR_SCENARIO)
    kernel = {("fused", "device"): ops.fused_census_desc_partials,
              ("fused", "host"): ops.fused_census_partials,
              ("hist", None): ops.tricode_histogram}[backend, emit]
    before = kernel.launches
    got, _ = example.run(backend=backend, device=cuda, emit=emit,
                         **MONITOR_SCENARIO)
    assert kernel.launches > before
    np.testing.assert_array_equal(got.censuses, want.censuses)
    np.testing.assert_array_equal(got.proportions(), want.proportions())
    assert got.alarms() == want.alarms()
    for a, b in zip(got.window_stats, want.window_stats):
        for field in ("items", "full_items", "affected_pairs", "chunks"):
            assert getattr(a, field) == getattr(b, field), field
    assert example.detected(got, spans)[1]


def test_network_monitor_faults_on_card(cuda):
    """Under the example's fault plan the monitor on the card degrades
    the same windows as on the CPU and equals it everywhere."""
    example = network_monitor_example()
    got, _ = example.run(device=cuda, inject_faults=0, **MONITOR_SCENARIO)
    want, _ = example.run(device="cpu", inject_faults=0, **MONITOR_SCENARIO)
    assert got.degraded == want.degraded != []
    np.testing.assert_array_equal(got.censuses, want.censuses)
    assert got._session.retries == want._session.retries >= 1


def test_session_recounts_after_a_failed_call_on_card(cuda):
    """A session call that fails past its retry budget leaves no ring
    slot in flight: the session recounts after it (as the monitor does
    after a degraded window), equal to the CPU."""
    g = rt.paper_workload("orkut", 160, 8.0, seed=5)
    plan = rt.FaultPlan(faults=[
        rt.Fault("dispatch", "error", device=0, occurrence=4 + i)
        for i in range(3)])
    s = rt.CensusEngine(device=cuda, faults=plan, max_retries=2,
                        retry_backoff=0.0).session(g, max_items=401)
    with pytest.raises(rt.FaultError):
        s.census()
    s.set_graph(g)
    np.testing.assert_array_equal(s.census(), rt.census_batagelj_mrvar(g))
    assert s.stats.chunks > 4
