"""The items kernel's staging rule, and the histogram wrapper, on the CPU.

``census_fused_items`` splits each tile of host items into runs of one
pair and stages both rows of each run's pair in shared memory;
:func:`repro_torch.kernels.census_fused.tile_item_stage` is that rule in
torch (the kernel itself runs only on the card, where its probe instance
is held to the rule).  Here the rule is held to a plain per-tile replay
in numpy on the items the JAX package's planner emits: its windows, its
sessions' pair subsets, shuffled items and hub pairs whose rows exceed
the row buffer.  The histogram wrapper is held to the JAX package's on
the inputs the census passes and on other dtypes.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import digraph as ref_digraph
from repro.core import generators as ref_generators
from repro.core import incremental as ref_incremental
from repro.core import plan_stream as ref_stream
from repro.core import planner as ref_planner
from repro.kernels import ops as ref_ops
from repro_torch.kernels import build, ops
from repro_torch.kernels.census_fused import (BLOCK_ITEMS, STAGE_RUNS,
                                              STAGE_WORDS,
                                              census_fused_items_probe,
                                              tile_item_stage)

torch.set_num_threads(1)

#: the oracle workloads of the JAX package's tests/test_census_fused.py
SMALL_SIZES = {"patents": (600, 3.0), "orkut": (250, 12.0),
               "webgraph": (400, 6.0)}

ref_histogram = jax.jit(ref_ops.tricode_histogram,
                        static_argnames=("interpret",))


def plain_rule(item_pv, indptr, pair_u, pair_v):
    """Per tile (runs, staged) and per lane from_stage, by a plain loop
    over each tile's lanes and runs."""
    deg = np.diff(indptr.astype(np.int64))
    n = item_pv.shape[0]
    tiles = max(1, -(-n // BLOCK_ITEMS))
    runs, staged = [], []
    from_stage = np.zeros(n, bool)
    for k in range(tiles):
        lanes = range(k * BLOCK_ITEMS, min(n, (k + 1) * BLOCK_ITEMS))
        pairs, run_of, prev = [], {}, None
        for i in lanes:
            if item_pv[i] & 1:
                pair = int(item_pv[i]) >> 1
                if pair != prev:
                    pairs.append(pair)
                    prev = pair
                run_of[i] = len(pairs) - 1
        recorded = len(pairs) <= STAGE_RUNS
        runs.append(len(pairs))
        staged.append(recorded)
        off, run_staged = 0, []
        for pair in pairs:
            length = int(deg[pair_u[pair]] + deg[pair_v[pair]])
            fits = 0 < length <= STAGE_WORDS
            run_staged.append(recorded and fits
                              and off + length <= STAGE_WORDS)
            off += length if fits else 0
        for i, r in run_of.items():
            from_stage[i] = run_staged[r]
    return np.array(runs), np.array(staged), from_stage


def check_items(graph, item_pv):
    """Hold the rule to the replay on one launch's items; returns the
    rule, the valid lanes and those it resolves from staged rows."""
    indptr, _, pair_u, pair_v, _ = graph
    r = tile_item_stage(*(torch.from_numpy(np.ascontiguousarray(a))
                          for a in (item_pv, indptr, pair_u, pair_v)))
    runs, staged, from_stage = plain_rule(item_pv, indptr, pair_u, pair_v)
    np.testing.assert_array_equal(r.runs.numpy(), runs)
    np.testing.assert_array_equal(r.staged.numpy(), staged)
    np.testing.assert_array_equal(r.from_stage.numpy(), from_stage)
    valid = (item_pv & 1) == 1
    tile = np.arange(item_pv.shape[0]) // BLOCK_ITEMS
    np.testing.assert_array_equal(
        r.live.numpy(), np.bincount(tile[valid], minlength=len(runs)) > 0)
    assert int(r.staged_runs.sum()) <= int(r.runs.sum())
    assert (r.words.numpy() <= STAGE_WORDS).all()
    return r, int(valid.sum()), int(from_stage.sum())


def chunker_windows(g, max_items, orient, limit=None):
    ck = ref_stream.PlanChunker(g, max_items, orient=orient)
    graph = ck.device_arrays()
    for k in range(ck.num_chunks if limit is None
                   else min(limit, ck.num_chunks)):
        yield graph, ck.chunk(k).item_pv


def star_with_pendants(k=12):
    """Hub 0 with leaves 1..k, each leaf with a pendant k+i."""
    leaves = np.arange(1, k + 1)
    return ref_digraph.from_edges(
        np.concatenate([np.zeros(k, np.int64), leaves]),
        np.concatenate([leaves, leaves + k]), n=2 * k + 1)


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("name, max_items", [
    (name, budget) for name in sorted(SMALL_SIZES)
    for budget in (4096, None)])
def test_small_workload_windows(name, max_items, orient):
    """The planner's windows: most lanes resolve from staged rows; runs
    past the row capacity at a tile's end do not."""
    n, deg = SMALL_SIZES[name]
    g = ref_generators.paper_workload(name, n, deg, seed=0)
    valid = staged = 0
    for graph, pv in chunker_windows(g, max_items, orient):
        _, v, s = check_items(graph, pv)
        valid += v
        staged += s
    assert 0.5 * valid < staged <= valid


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("max_items", [1, 3, 5])
def test_tiny_budgets(max_items, orient):
    """Windows of 1-5 items, pairs split across windows."""
    windows = list(chunker_windows(star_with_pendants(), max_items, orient))
    assert len(windows) > 1
    for graph, pv in windows:
        r, v, s = check_items(graph, pv)
        assert s == v
        assert int(r.runs.sum()) <= max_items


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("name", sorted(SMALL_SIZES))
def test_session_subsets(name, orient):
    """Host items of a delta's affected pairs, in the order a session
    emits them (grouped by pair in the given pair order)."""
    n, deg = SMALL_SIZES[name]
    g = ref_generators.paper_workload(name, n, deg, seed=0)
    rng = np.random.default_rng(5)
    _, delta = ref_digraph.apply_delta(g, rng.integers(0, n, 12),
                                       rng.integers(0, n, 12))
    ck = ref_stream.PlanChunker(g, None, orient=orient)
    pairs = ref_incremental.affected_pair_ids(ck.space, delta.touched)
    rng.shuffle(pairs)
    pair, slot, side = ref_planner.emit_items_for_pairs(ck.space, pairs)
    _, pv = ref_planner.pad_and_pack(pair, slot, side, pair.shape[0] + 77)
    _, v, s = check_items(ck.device_arrays(), pv)
    assert v == pair.shape[0] > 0 and s > 0.5 * v


def test_shuffled_items():
    """Shuffled items put more than STAGE_RUNS runs in a tile: nothing
    is staged there."""
    g = ref_generators.paper_workload("orkut", 250, 12.0, seed=0)
    ck = ref_stream.PlanChunker(g, None)
    pv = ck.chunk(0).item_pv
    pv = pv[np.random.default_rng(2).permutation(pv.shape[0])]
    r, v, s = check_items(ck.device_arrays(), pv)
    full = np.arange(r.runs.shape[0]) < pv.shape[0] // BLOCK_ITEMS
    assert (r.runs.numpy()[full] > STAGE_RUNS).all()
    assert not r.staged.numpy()[full].any()
    assert v > 0 and s < v


def test_hub_pair_past_capacity():
    """Pairs of a hub of 8,300 arcs need more row words than the buffer:
    their lanes resolve from global memory, the small pairs' from the
    stage."""
    n = 8600
    rng = np.random.default_rng(3)
    g = ref_digraph.from_edges(
        np.concatenate([np.zeros(8300, np.int64), rng.integers(0, n, 3000)]),
        np.concatenate([np.arange(1, 8301), rng.integers(0, n, 3000)]), n=n)
    ck = ref_stream.PlanChunker(g, None)
    space = ck.space
    hub = np.flatnonzero(space.pair_u == 0)[:3]
    small = np.flatnonzero(space.pair_u != 0)[:400]
    pair, slot, side = ref_planner.emit_items_for_pairs(
        space, np.concatenate([small[:200], hub, small[200:]]))
    _, pv = ref_planner.pad_and_pack(pair, slot, side, pair.shape[0])
    r, v, s = check_items(ck.device_arrays(), pv)
    on_hub = np.isin(pv >> 1, hub) & ((pv & 1) == 1)
    assert not r.from_stage.numpy()[on_hub].any()
    assert r.from_stage.numpy()[~on_hub & ((pv & 1) == 1)].all()
    assert 0 < s < v


def test_item_constants_match_the_kernel_source():
    source = (build.CSRC / "census_fused.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             source).group(1))

    assert constant("kStageRuns") == STAGE_RUNS
    assert constant("kStageWords") == STAGE_WORDS


def test_items_probe_needs_the_card():
    ck = ref_stream.PlanChunker(
        ref_generators.paper_workload("orkut", 250, 12.0, seed=0), 4096)
    chunk = ck.chunk(0)
    arrays = [torch.from_numpy(a) for a in (*ck.device_arrays(),
                                            chunk.item_sp, chunk.item_pv)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        census_fused_items_probe(*arrays)


@pytest.mark.parametrize("dtypes", [(np.int32, np.bool_),
                                    (np.int64, np.uint8)])
def test_histogram_wrapper_matches_jax(dtypes):
    """The wrapper's histogram equals the JAX package's, masked codes
    outside [0, 64) included, on int32/bool (what the census passes) and
    on int64/uint8 inputs."""
    rng = np.random.default_rng(11)
    w = 9_000
    tri = rng.integers(-5, 75, w).astype(dtypes[0])
    mask = rng.integers(0, 3 if dtypes[1] is np.uint8 else 2,
                        w).astype(dtypes[1])
    got = ops.tricode_histogram(torch.from_numpy(tri),
                                torch.from_numpy(mask))
    want = ref_histogram(jnp.asarray(tri.astype(np.int32)),
                         jnp.asarray(mask), interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
