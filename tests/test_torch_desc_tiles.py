"""The desc kernel's staging rule, on the CPU.

``census_fused_desc`` stages one descriptor range per tile of lanes, and
resolves in shared memory each valid lane whose anchor the tile covers;
:func:`repro_torch.kernels.census_fused.tile_desc_ranges` is that rule
in torch (the kernel itself runs only on the card).  Every lane the rule
resolves from a stage must find there each descriptor its anchored
search reads and the descriptor it lands on: the one the JAX package's
``expand_work_items`` gives it (the position of its pair in the window's
``desc_pair``).  A tile is reported as overflowing exactly when the
smallest range covering its anchors exceeds the staging capacity, as a
plain per-tile loop finds it.  The kernels' C entry points, the desc
kernel's probe instance (which reports on the card the branch each tile
and lane took) included, must match the ctypes signatures they are
called through.
"""

import re

import jax
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import census as ref_census
from repro_torch.core import census
from repro_torch.core.incremental import (affected_pair_ids,
                                          subset_descriptor_windows)
from repro_torch.core.planner import DESC_ANCHOR_STRIDE, split_device_words
from repro_torch.kernels import build, ops
from repro_torch.kernels.census_fused import (BLOCK_ITEMS, STAGE_ANCHORS,
                                              STAGE_DESCS,
                                              census_fused_desc_probe,
                                              tile_desc_ranges)

torch.set_num_threads(1)

#: the oracle workloads of the JAX package's tests/test_census_fused.py
SMALL_SIZES = {"patents": (600, 3.0), "orkut": (250, 12.0),
               "webgraph": (400, 6.0)}

ref_expand = jax.jit(ref_census.expand_work_items, static_argnums=9)


def star_with_pendants(k=12):
    """Hub 0 with leaves 1..k, each leaf with a pendant k+i."""
    leaves = np.arange(1, k + 1)
    return rt.from_edges(np.concatenate([np.zeros(k, np.int64), leaves]),
                         np.concatenate([leaves, leaves + k]), n=2 * k + 1)


def ring(n=3000):
    """Pairs of 4 items: a tile of lanes reaches ~1,024 descriptors."""
    v = np.arange(n)
    return rt.from_edges(v, (v + 1) % n, n=n)


def plain_rule(anchors, desc_cum, num_lanes):
    """Per tile, ``(lo, hi, staged)`` by a plain loop."""
    nd = desc_cum.shape[0]
    last = anchors.shape[0] - 1

    def exact(a):
        at, index = int(anchors[a]), a * DESC_ANCHOR_STRIDE
        return desc_cum[at] <= index and (at + 1 == nd
                                          or desc_cum[at + 1] > index)

    out = []
    for first in range(0, max(num_lanes, 1), BLOCK_ITEMS):
        count = max(min(num_lanes - first, BLOCK_ITEMS), 1)
        a0 = min(first // DESC_ANCHOR_STRIDE, last)
        a1 = min((first + count - 1) // DESC_ANCHOR_STRIDE, last)
        reach = anchors[a0:a1 + 1]
        lo = max(int(reach.min()) - 1, 0)
        hi = min(int(reach.max()) + DESC_ANCHOR_STRIDE + 1, nd)
        staged = (reach.min() >= 0 and reach.max() < nd
                  and hi - lo <= STAGE_DESCS
                  and all(desc_cum[j] > desc_cum[j - 1]
                          or desc_cum[j] == desc_cum[j - 1]
                          >= (a1 + 1) * DESC_ANCHOR_STRIDE
                          for j in range(lo + 1, hi))
                  and all(exact(a) for a in range(a0, a1 + 1)))
        out.append((lo, hi, bool(staged)))
    return out


def check_window(graph, win, num_anchors, idx, desc_iters):
    """Hold one window's rule to the reference; return its TileRanges."""
    indptr, _, pair_u, pair_v, _ = graph
    nv, dp, dc, dw, an = split_device_words(win.device_words(), num_anchors)
    nd = dp.shape[0]
    r = tile_desc_ranges(*(torch.from_numpy(a) for a in (an, dc, nv, idx)))
    for k, (lo, hi, staged) in enumerate(plain_rule(an, dc, idx.shape[0])):
        assert bool(r.staged[k]) == staged, k
        if staged:
            assert (int(r.lo[k]), int(r.hi[k])) == (lo, hi), k

    pair, _, _, valid = (np.asarray(x) for x in ref_expand(
        indptr, pair_u, pair_v, dp, dc, dw, an, nv, idx, desc_iters))
    position = {int(p): j for j, p in enumerate(dp[:win.num_descs])}
    d_ref = np.array([position[int(p)] for p in pair[valid]], np.int64)
    d, v = census.lane_descriptors(*(torch.from_numpy(a) for a in (
        dc, an, nv, idx)), desc_iters)
    np.testing.assert_array_equal(v.numpy(), valid)
    np.testing.assert_array_equal(d.numpy()[valid], d_ref)

    tile = np.arange(idx.shape[0]) // BLOCK_ITEMS
    first = tile * BLOCK_ITEMS
    a0 = np.minimum(first // DESC_ANCHOR_STRIDE, an.shape[0] - 1)
    a1 = np.minimum((np.minimum(first + BLOCK_ITEMS, idx.shape[0]) - 1)
                    // DESC_ANCHOR_STRIDE, an.shape[0] - 1)
    np.testing.assert_array_equal(
        r.from_stage.numpy(),
        valid & r.staged.numpy()[tile] & (idx >= a0 * DESC_ANCHOR_STRIDE)
        & (idx < (a1 + 1) * DESC_ANCHOR_STRIDE))
    a = np.minimum(np.clip(idx, 0, None) // DESC_ANCHOR_STRIDE,
                   an.shape[0] - 1)
    lo_d = an[a].astype(np.int64)
    hi_d = np.minimum(lo_d + DESC_ANCHOR_STRIDE + 1, nd)
    mine = r.from_stage.numpy()
    assert not (mine & ~valid).any()
    lo, hi = r.lo.numpy()[tile], r.hi.numpy()[tile]
    landed = np.zeros(idx.shape[0], np.int64)
    landed[valid] = d_ref
    assert (lo[mine] <= landed[mine]).all() and (landed[mine] < hi[mine]).all()
    assert (lo[mine] <= lo_d[mine]).all() and (hi_d[mine] <= hi[mine]).all()
    return r


def arange_idx(chunker, pad=29):
    return np.concatenate([np.arange(chunker.chunk_shape, dtype=np.int32),
                           np.full(pad, ops.IDX_PAD, np.int32)])


def every_window(g, max_items, orient):
    ck = rt.PlanChunker(g, max_items, orient=orient)
    graph = ck.device_arrays()
    idx = arange_idx(ck)
    lanes = 0
    for k in range(ck.num_chunks):
        r = check_window(graph, ck.descriptors(k), ck.num_anchors, idx,
                         ck.desc_iters)
        lanes += int(r.from_stage.sum())
    return ck, lanes


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("name, max_items", [
    *((name, budget) for name in sorted(SMALL_SIZES)
      for budget in (4096, None)), ("webgraph", 37)])
def test_small_workload_windows(name, max_items, orient):
    """An in-order idx resolves every valid lane from its tile's stage."""
    n, deg = SMALL_SIZES[name]
    g = rt.paper_workload(name, n, deg, seed=0)
    ck, lanes = every_window(g, max_items, orient)
    assert lanes == ck.space.num_items_preprune


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("max_items", [1, 3, 5])
def test_tiny_budgets(max_items, orient):
    ck, lanes = every_window(star_with_pendants(), max_items, orient)
    assert ck.num_chunks > 1
    assert lanes == ck.space.num_items_preprune


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("name", sorted(SMALL_SIZES))
def test_subset_windows(name, orient):
    """The windows a session update dispatches: the affected pairs of a
    delta, in any order of pair ids."""
    n, deg = SMALL_SIZES[name]
    g = rt.paper_workload(name, n, deg, seed=0)
    rng = np.random.default_rng(5)
    _, delta = rt.apply_delta(g, rng.integers(0, n, 12),
                              rng.integers(0, n, 12))
    ck = rt.PlanChunker(g, 1024, orient=orient)
    pairs = affected_pair_ids(ck.space, delta.touched)
    graph = ck.device_arrays()
    idx = arange_idx(ck)
    windows = list(subset_descriptor_windows(
        ck.space, pairs, ck.chunk_shape, ck.chunk_shape // 2 + 1,
        ck.num_anchors))
    lanes = sum(int(check_window(graph, w, ck.num_anchors, idx,
                                 ck.desc_iters).from_stage.sum())
                for w in windows)
    assert len(windows) > 1
    assert lanes == sum(w.num_preprune for w in windows)


def test_overflowing_tiles_are_reported():
    """Tiles over more than STAGE_DESCS descriptors resolve per lane."""
    ck = rt.PlanChunker(ring(), 2**14)
    graph = ck.device_arrays()
    idx = arange_idx(ck)
    r = check_window(graph, ck.descriptors(0), ck.num_anchors, idx,
                     ck.desc_iters)
    assert not r.staged.any()
    assert not r.from_stage.any()
    assert ((r.hi - r.lo) > STAGE_DESCS).all()


@pytest.mark.parametrize("layout", ["permuted", "strided"])
def test_scattered_idx(layout):
    """Lanes whose index lies outside their tile's anchors resolve from
    global memory; the rest still from the stage."""
    g = rt.paper_workload("orkut", 250, 12.0, seed=0)
    ck = rt.PlanChunker(g, None)
    order = arange_idx(ck)
    rng = np.random.default_rng(2)
    idx = (rng.permutation(order) if layout == "permuted"
           else np.concatenate([order[::2], order[1::2]]))
    r = check_window(ck.device_arrays(), ck.descriptors(0), ck.num_anchors,
                     idx, ck.desc_iters)
    valid = int(((idx >= 0) & (idx < ck.space.num_items_preprune)).sum())
    assert 0 < int(r.from_stage.sum()) < valid


@pytest.mark.parametrize("shift", [1, 20])
def test_inexact_anchors_are_not_staged(shift):
    """Anchors that undershoot (not the last descriptor at their index)
    leave the anchored search's answer to global memory."""
    g = rt.paper_workload("webgraph", 400, 6.0, seed=0)
    ck = rt.PlanChunker(g, 20_000)
    nv, dp, dc, dw, an = split_device_words(ck.descriptors(1).device_words(),
                                            ck.num_anchors)
    bad = np.maximum(an - shift, 0).astype(np.int32)
    idx = arange_idx(ck)
    r = tile_desc_ranges(*(torch.from_numpy(a) for a in (bad, dc, nv, idx)))
    for k, (lo, hi, staged) in enumerate(plain_rule(bad, dc, idx.shape[0])):
        assert bool(r.staged[k]) == staged
    assert not r.staged.any()


def test_constants_match_the_kernel_source():
    source = (build.CSRC / "census_fused.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kBlockItems") == BLOCK_ITEMS
    assert constant("kStageDescs") == STAGE_DESCS
    assert constant("kAnchorStride") == DESC_ANCHOR_STRIDE
    assert "kStageAnchors = kBlockItems / kAnchorStride + 2" in source
    assert STAGE_ANCHORS == BLOCK_ITEMS // DESC_ANCHOR_STRIDE + 2


def c_entry_points():
    """Each ``extern "C"`` function of the kernel sources: name -> its
    parameter count."""
    found = {}
    for src in build.SOURCES:
        text = src.read_text()
        text = text[text.index('extern "C" {'):]
        for name, params in re.findall(
                r"^(?:int|const char\*) (\w+)\(([^)]*)\)", text, re.M):
            found[name] = len(params.split(","))
    return found


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signatures_match_the_kernel_sources(name):
    """ctypes declares every entry point with the source's arity, the
    probe instance of the desc kernel included."""
    assert c_entry_points()[name] == len(build.SIGNATURES[name][0])


def test_every_entry_point_is_declared():
    assert set(c_entry_points()) == set(build.SIGNATURES)


def test_probe_needs_the_card():
    """The branch report comes from the kernel only: on CPU tensors the
    probe raises, and there is no plain version to stand in for it."""
    ck = rt.PlanChunker(rt.paper_workload("orkut", 250, 12.0, seed=0),
                        4096)
    nv, dp, dc, dw, an = (torch.from_numpy(a) for a in split_device_words(
        ck.descriptors(0).device_words(), ck.num_anchors))
    graph = [torch.from_numpy(a) for a in ck.device_arrays()]
    idx = torch.arange(ck.chunk_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        census_fused_desc_probe(*graph, dp, dc, dw, an, nv, idx, "none",
                                True)
