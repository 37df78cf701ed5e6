"""A descriptor window's anchor table built on the device
(``repro_torch.kernels.ops.desc_anchors``): its plain version against the
table ``descriptor_window`` builds on the host, the CUDA kernel against
its plain version bit for bit (marker ``cuda``), and the engine paths
that build every window's table on the device instead of shipping it.

The ``cuda`` cases run on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_desc_anchors.py
"""

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core.incremental import subset_descriptor_windows
from repro_torch.core.plan_stream import PlanChunker, ShardSchedule
from repro_torch.core.planner import (DESC_CUM_PAD, descriptor_window,
                                      num_desc_anchors, split_device_words)
from repro_torch.kernels import ops

torch.set_num_threads(1)

#: the item budget of a run here: a few dozen windows of ``graph()``
BUDGET = 2000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tables(monkeypatch):
    """The sizes of the tables the engine builds through the wrapper, one
    entry a call: the wrapper's own ``launches`` counts only its kernel
    launches, none of them on the CPU."""
    built = []
    wrapper = ops.desc_anchors

    def counted(desc_cum, out):
        built.append(out.shape[0])
        before = wrapper.launches
        got = wrapper(desc_cum, out)
        assert wrapper.launches == before + (out.device.type == "cuda")
        return got

    monkeypatch.setattr(ops, "desc_anchors", counted)
    return built


def graph():
    return rt.paper_workload("orkut", 300, 8.0, seed=1)


def delta(g, seed=0, k=20):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, g.n, k), rng.integers(0, g.n, k))


def plain(win) -> np.ndarray:
    """The window's table as the wrapper builds it on the CPU, which
    launches no kernel."""
    out = torch.full((win.anchors.shape[0],), -1, dtype=torch.int32)
    before = ops.desc_anchors.launches
    got = ops.desc_anchors(torch.from_numpy(win.desc_cum), out).numpy()
    assert ops.desc_anchors.launches == before
    return got


#: (offsets of a pair sequence, window [lo, hi), desc_shape, chunk_shape)
WINDOWS = {
    "empty": ([0, 5, 9, 40], 9, 9, 4, 64),
    "one-descriptor": ([0, 100], 0, 100, 3, 128),
    "starts-mid-pair": ([0, 7, 30, 31, 90, 200], 12, 150, 6, 160),
    "no-padding": ([0, 3, 20, 21, 50], 0, 50, 4, 64),
    "chunk-not-a-multiple-of-16": ([0, 9, 10, 33, 70], 2, 70, 5, 75),
    "pairs-with-no-items": ([0, 0, 0, 4, 4, 4, 4, 20, 20, 37], 0, 37, 9,
                            40),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_plain_equals_the_host_table(case):
    offsets, lo, hi, desc_shape, chunk_shape = WINDOWS[case]
    win = descriptor_window(np.array(offsets), lo, hi, desc_shape,
                            num_desc_anchors(chunk_shape))
    if case == "no-padding":
        assert win.num_descs == desc_shape
    if case == "empty":
        assert win.num_descs == 0 and not win.anchors.any()
    np.testing.assert_array_equal(plain(win), win.anchors)


@pytest.mark.parametrize("budget", [64, 333, 2000])
def test_plain_equals_the_host_table_on_subset_windows(budget):
    g = graph()
    space = rt.pair_space(g)
    ids = np.random.default_rng(budget).choice(space.num_pairs, 400,
                                               replace=False)
    ck = PlanChunker(g, budget)
    wins = list(subset_descriptor_windows(space, np.sort(ids), budget,
                                          ck.desc_shape, ck.num_anchors))
    assert len(wins) >= 2
    for win in wins:
        np.testing.assert_array_equal(plain(win), win.anchors)


def test_a_window_without_its_table_ships_the_rest_unchanged():
    """``num_anchors`` 0 (``anchors=False``) builds no host table: the
    words are the full window's without its tail, as the lock-step
    path's ``step_words``; the megastep's rows still carry theirs."""
    g = graph()
    ck = PlanChunker(g, BUDGET)
    for k in range(ck.num_chunks):
        full = ck.descriptors(k).device_words()
        short = ck.descriptors(k, anchors=False).device_words()
        assert short.shape == (1 + 3 * ck.desc_shape,)
        np.testing.assert_array_equal(full[:short.shape[0]], short)
        nv, dp, dc, dw, an = split_device_words(short, 0)
        assert an.shape == (0,) and dc.shape == (ck.desc_shape,)
    sched = ShardSchedule([rt.pair_space(g)], BUDGET, 1)
    for k in range(sched.num_steps):
        full = sched.descriptors(0, k).device_words()
        assert full.shape == (1 + 3 * sched.desc_shape + sched.num_anchors,)
        np.testing.assert_array_equal(sched.step_words(k),
                                      full[None, :1 + 3 * sched.desc_shape])


@pytest.mark.parametrize("layout", ["stream", "replicated-2", "lockstep-2",
                                    "async-2", "torch-backend"])
def test_engine_builds_each_table_on_the_device(layout, tables):
    """A census through each engine path equals Batagelj–Mrvar; the
    wrapper builds one table a dispatch on every device on the
    single-window paths, none on the megastep's (its rows carry host
    tables) or under the oracle backend (plain torch)."""
    g = graph()
    kw = {}
    if layout.endswith("-2"):
        kw = dict(devices=rt.default_devices(2, "cpu"))
        if layout != "replicated-2":
            kw.update(partition=True, schedule=layout[:-2])
    else:
        kw = dict(device="cpu", backend=("torch" if layout == "torch-backend"
                                         else "fused"))
    eng = rt.CensusEngine(**kw)
    counts = eng.run(g, max_items=BUDGET)
    np.testing.assert_array_equal(counts, rt.census_batagelj_mrvar(g))
    st = eng.stats
    want = {"stream": st.chunks, "replicated-2": st.chunks * st.ndev,
            "lockstep-2": st.dispatches_total * st.ndev, "async-2": 0,
            "torch-backend": 0}[layout]
    assert len(tables) == want
    assert len(set(tables)) <= 1
    if layout not in ("async-2", "torch-backend"):
        assert want >= 3


@pytest.mark.parametrize("devices", [1, 2])
def test_session_builds_each_table_on_the_device(devices, tables):
    g = graph()
    eng = (rt.CensusEngine(device="cpu") if devices == 1
           else rt.CensusEngine(devices=rt.default_devices(devices, "cpu")))
    session = eng.session(g, max_items=BUDGET)
    tables.clear()
    np.testing.assert_array_equal(session.census(),
                                  rt.census_batagelj_mrvar(g))
    assert len(tables) == session.stats.chunks * devices >= 3
    tables.clear()
    got = session.update(*delta(g))
    np.testing.assert_array_equal(got,
                                  rt.census_batagelj_mrvar(session.graph))
    assert len(tables) == session.stats.chunks * devices > 0


@pytest.mark.parametrize("mesh", [None, (2, 1)])
def test_partitioned_session_builds_each_table_on_the_device(mesh,
                                                             tables):
    g = graph()
    kw = dict(partition=True) if mesh is None else dict(partition_2d=mesh)
    session = rt.CensusEngine(devices=rt.default_devices(2, "cpu"),
                              **kw).session(g, max_items=BUDGET)
    tables.clear()
    np.testing.assert_array_equal(session.census(),
                                  rt.census_batagelj_mrvar(g))
    assert len(tables) == session.stats.chunks >= 3
    tables.clear()
    got = session.update(*delta(g, seed=1))
    np.testing.assert_array_equal(got,
                                  rt.census_batagelj_mrvar(session.graph))
    assert len(tables) == session.stats.chunks


def card_windows(seed: int, chunk_shape: int):
    """Windows of ``chunk_shape`` lanes over a seeded pair sequence:
    many small pairs, hub pairs, runs of pairs with no items, and a
    window that starts mid-pair; then the empty window."""
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.6, 600_000).clip(max=2**20)
    counts[rng.random(counts.shape[0]) < 0.05] = 0
    counts[1000:3000] = 0
    offsets = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    num_anchors = num_desc_anchors(chunk_shape)
    starts = [0, chunk_shape // 3 + 7, int(offsets[2500]) - 5]
    wins = [(offsets, lo, min(lo + chunk_shape, int(offsets[-1])))
            for lo in starts]
    desc_shape = max(int(np.searchsorted(offsets, hi, side="left")
                         - np.searchsorted(offsets, lo, side="right") + 1)
                     for _, lo, hi in wins)
    out = [descriptor_window(o, lo, hi, desc_shape, num_anchors)
           for o, lo, hi in wins]
    out.append(descriptor_window(offsets, 0, 0, desc_shape, num_anchors))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_equals_plain_at_2_24_lanes(cuda, offset):
    """The kernel bit for bit against its plain version, and both against
    the host's table, at the main path's 2**24 lanes; ``offset`` 1 writes
    into a table that is not 16-byte aligned."""
    for win in card_windows(seed=7, chunk_shape=2**24):
        num_anchors = win.anchors.shape[0]
        assert (win.desc_cum[win.num_descs:] == DESC_CUM_PAD).all()
        desc_cum = torch.from_numpy(win.desc_cum).to(cuda)
        buf = torch.full((num_anchors + 1,), -1, dtype=torch.int32,
                         device=cuda)
        before = ops.desc_anchors.launches
        got = ops.desc_anchors(desc_cum, buf[offset:offset + num_anchors])
        want = ops.desc_anchors_ref(desc_cum, num_anchors)
        assert ops.desc_anchors.launches == before + 1
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.cpu().numpy(), win.anchors)
        untouched = buf[num_anchors] if offset == 0 else buf[0]
        assert int(untouched) == -1


@pytest.mark.cuda
def test_census_on_the_card_builds_each_table_there(cuda):
    g = graph()
    eng = rt.CensusEngine(device=cuda)
    ops.reset_launch_counts()
    np.testing.assert_array_equal(eng.run(g, max_items=BUDGET),
                                  rt.census_batagelj_mrvar(g))
    assert ops.desc_anchors.launches == eng.stats.chunks \
        == ops.fused_census_desc_partials.launches
