"""The port's device half, on the CPU, against the JAX package's.

Each function of ``repro_torch.core.census`` (plain torch) and each kernel
wrapper's CPU route (its plain version) is fed the same numpy-made
inputs as its ``repro`` counterpart (jnp, and the Pallas kernels in
interpret mode); every output is integer and must be equal.  Windows
with padding lanes (``IDX_PAD``), padded descriptors and no valid lanes
at all pin the gathers that XLA clamps and torch does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import census as ref_census
from repro.kernels import ops as ref_ops
from repro_torch.core import census
from repro_torch.core.planner import descriptor_window, split_device_words
from repro_torch.kernels import build, ops

torch.set_num_threads(1)

BACKENDS = {"torch": "jnp", "hist": "pallas", "fused": "pallas-fused"}
PAD_LANES = 29


def jitted(fn, *static):
    """The reference function compiled whole, as its engine runs it."""
    return jax.jit(fn, static_argnums=static)


ref_searchsorted = jitted(ref_census.segment_searchsorted, 4)
ref_expand = jitted(ref_census.expand_work_items, 9)
ref_classify = jitted(ref_census.classify_items, 9)
ref_keep = jitted(ref_census.prune_keep_mask, 8, 9)
ref_desc_partials = jitted(ref_census.census_partials_desc, 11, 12, 13, 14)
ref_item_partials = jitted(ref_census.census_partials, 7)


def hub_graph(n=24, hub_out=16, extra=40, seed=0):
    rng = np.random.default_rng(seed)
    src = [0] * hub_out + list(rng.integers(0, n, extra))
    dst = list(range(1, hub_out + 1)) + list(rng.integers(0, n, extra))
    return rt.from_edges(src, dst, n=max(n, hub_out + 1))


def to_torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def to_jnp(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def assert_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def windows(g, max_items, orient="none", prune_self=True, pad=PAD_LANES):
    """Every descriptor window of ``g`` as numpy inputs ``(graph..., dp,
    dc, dw, an, nv, idx)``, the index array padded with IDX_PAD."""
    ck = rt.PlanChunker(g, max_items, orient=orient, prune_self=prune_self)
    idx = np.concatenate([np.arange(ck.chunk_shape, dtype=np.int32),
                          np.full(pad, ops.IDX_PAD, np.int32)])
    for k in range(ck.num_chunks):
        nv, dp, dc, dw, an = split_device_words(
            ck.descriptors(k).device_words(), ck.num_anchors)
        yield ck, (*ck.device_arrays(), dp, dc, dw, an, nv, idx)


@pytest.mark.parametrize("iters", [1, 2, 4, 8])
def test_segment_searchsorted_matches(iters):
    """The same fixed-depth clamped loop, so even a search cut short
    (``iters`` too small) lands where the reference's lands."""
    rng = np.random.default_rng(iters)
    keys = np.sort(rng.integers(0, 500, 200)).astype(np.int32)
    lo = rng.integers(0, 200, 300).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 60, 300), 200).astype(np.int32)
    q = rng.integers(-5, 510, 300).astype(np.int32)
    got = census.segment_searchsorted(*to_torch((keys, lo, hi, q)), iters)
    want = ref_searchsorted(*to_jnp((keys, lo, hi, q)), iters)
    assert_equal([got], [want])


@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("max_items", [3, 37, None])
def test_expand_classify_keep_match(orient, max_items):
    for prune_self in (True, False):
        for ck, arrays in windows(hub_graph(), max_items, orient,
                                  prune_self):
            ip, pk, pu, pv, pc, dp, dc, dw, an, nv, idx = arrays
            di = ck.desc_iters
            got = census.expand_work_items(
                *to_torch((ip, pu, pv, dp, dc, dw, an, nv, idx)), di)
            want = ref_expand(
                *to_jnp((ip, pu, pv, dp, dc, dw, an, nv, idx)), di)
            assert_equal(got, want)
            items = [np.array(x) for x in want]
            si = ck.space.search_iters
            got = census.classify_items(
                *to_torch((ip, pk, pu, pv, pc, *items)), si)
            want = ref_classify(
                *to_jnp((ip, pk, pu, pv, pc, *items)), si)
            assert_equal(got, want)
            got = census.prune_keep_mask(
                *to_torch((pk, pu, pv, pc, *items)), orient, prune_self)
            want = ref_keep(
                *to_jnp((pk, pu, pv, pc, *items)), orient, prune_self)
            assert_equal([got], [want])


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_desc_partials_match_every_window(backend, orient):
    """Per-window int32 partials of each port backend (CPU) equal the
    reference's jnp partials."""
    g = rt.paper_workload("orkut", 60, 8.0, seed=0)
    for ck, arrays in windows(g, 97, orient):
        fn = census.desc_partials_fn(backend, ck.space.search_iters,
                                     ck.desc_iters, orient, True)
        got = fn(*to_torch(arrays))
        assert all(t.dtype == torch.int32 for t in got)
        assert got[1].shape == (3,)
        assert_equal(got, ref_desc_partials(
            *to_jnp(arrays), ck.space.search_iters, ck.desc_iters, orient,
            True))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("orient", ["none", "degree"])
def test_item_partials_match_every_chunk(backend, orient):
    g = rt.paper_workload("orkut", 60, 8.0, seed=0)
    ck = rt.PlanChunker(g, 97, orient=orient, pad_to=8)
    for chunk in ck:
        arrays = (*ck.device_arrays(), chunk.item_sp, chunk.item_pv)
        got = census.partials_fn(backend, ck.space.search_iters)(
            *to_torch(arrays))
        want = ref_item_partials(*to_jnp(arrays), ck.space.search_iters)
        assert all(t.dtype == torch.int32 for t in got)
        assert_equal(got, want)


def test_padded_and_empty_windows():
    """A last window with padded descriptors and IDX_PAD lanes, and a
    window with no valid lane: equal partials, and zeros for the empty
    one (no gather may leave its array on the way)."""
    g = hub_graph(seed=5)
    ck, arrays = list(windows(g, 50, pad=1000))[-1]
    win = ck.descriptors(ck.num_chunks - 1)
    assert win.num_descs < ck.desc_shape          # padded descriptors
    assert win.num_preprune < ck.chunk_shape      # padding lanes
    fn = census.desc_partials_fn("torch", ck.space.search_iters,
                                 ck.desc_iters, "none", True)
    want_fn = functools.partial(ref_desc_partials,
                                search_iters=ck.space.search_iters,
                                desc_iters=ck.desc_iters, orient="none",
                                prune_self=True)
    assert_equal(fn(*to_torch(arrays)), want_fn(*to_jnp(arrays)))
    empty = descriptor_window(ck.space.offsets, 10, 10, ck.desc_shape,
                              ck.num_anchors)
    assert empty.num_preprune == 0 and empty.num_descs == 0
    nv, dp, dc, dw, an = split_device_words(empty.device_words(),
                                            ck.num_anchors)
    arrays = (*arrays[:5], dp, dc, dw, an, nv, arrays[-1])
    got = fn(*to_torch(arrays))
    assert_equal(got, want_fn(*to_jnp(arrays)))
    assert int(got[0].sum()) == 0 and int(got[1].sum()) == 0


def test_wrappers_on_cpu_match_pallas_interpret():
    """Each kernel wrapper's CPU route against the Pallas kernel in
    interpret mode, on one tiny window each."""
    g = rt.paper_workload("orkut", 60, 8.0, seed=1)
    ck, arrays = next(windows(g, 400, "degree"))
    si, di = ck.space.search_iters, ck.desc_iters
    got = ops.fused_census_desc_partials(*to_torch(arrays), si, di,
                                         "degree", True)
    want = ref_ops.fused_census_desc_partials(*to_jnp(arrays), si, di,
                                              "degree", True,
                                              interpret=True)
    assert_equal(got, want)

    chunk = ck.chunk(0)
    items = (*ck.device_arrays(), chunk.item_sp, chunk.item_pv)
    got = ops.fused_census_partials(*to_torch(items), si)
    want = ref_ops.fused_census_partials(*to_jnp(items), si,
                                         interpret=True)
    assert_equal(got, want)

    rng = np.random.default_rng(0)
    tri = rng.integers(0, 64, 3000).astype(np.int32)
    mask = rng.random(3000) < 0.6
    got = ops.tricode_histogram(*to_torch((tri, mask)))
    want = ref_ops.tricode_histogram(*to_jnp((tri, mask)), interpret=True)
    assert got.dtype == torch.int32
    assert_equal([got], [want])
    assert (ops.fused_census_desc_partials.launches
            == ops.fused_census_partials.launches
            == ops.tricode_histogram.launches == 0)   # no kernel on a CPU


@pytest.mark.parametrize("w", [1, 100, 8193])
def test_histogram_plain_matches_reference(w):
    rng = np.random.default_rng(w)
    tri = rng.integers(-2, 70, w).astype(np.int32)
    got = ops.tricode_histogram_ref(torch.from_numpy(tri))
    want = ref_ops.tricode_histogram_ref(jnp.asarray(tri))
    assert_equal([got], [want])


def test_assemble_counts_matches():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 2**31 - 1, 64)
    inter = rng.integers(0, 2**31 - 1, 2)
    for n in (3, 1000, 3_774_768):
        np.testing.assert_array_equal(
            census.assemble_counts(n, 12345, 678, hist, inter),
            ref_census.assemble_counts(n, 12345, 678, hist, inter))


def test_launchers_refuse_cpu_tensors():
    from repro_torch.kernels.census_fused import census_fused_kernel
    from repro_torch.kernels.tricode_hist import tricode_histogram_kernel
    g = hub_graph()
    ck = rt.PlanChunker(g, None)
    chunk = ck.chunk(0)
    with pytest.raises(ValueError):
        census_fused_kernel(*to_torch((*ck.device_arrays(), chunk.item_sp,
                                       chunk.item_pv)))
    with pytest.raises(ValueError):
        tricode_histogram_kernel(torch.zeros(8, dtype=torch.int32),
                                 torch.zeros(8, dtype=torch.bool))
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        ops.tricode_histogram(torch.zeros(8, dtype=torch.int32,
                                          device="meta"),
                              torch.zeros(8, dtype=torch.bool,
                                          device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "missing-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
