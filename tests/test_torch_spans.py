"""The census path's host spans (``repro_torch.core.spans``) under
``torch.profiler``: which ranges a run and a session update open, that
they lie as documented, that every host-seconds field of
``EngineStats`` equals its span's range total, and the copied-bytes
counter ``plan_upload_bytes_total``.

The ``cuda`` case runs the census on the card, where the upload and the
waits are real copies and events::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_spans.py
"""

import inspect
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch as rt
from repro_torch.core import engine, spans
from repro_torch.core.planner import DESC_BYTES

torch.set_num_threads(1)

#: the item budget of a run here: a few dozen windows of ``graph()``
BUDGET = 2000

CENSUS_SPANS = {spans.PLAN, spans.GRAPH, spans.WINDOW, spans.ANCHORS,
                spans.UPLOAD, spans.WAIT}
SESSION_SPANS = {spans.MERGE, spans.PAIR, spans.EMIT, spans.INSTALL}
#: EngineStats field fed by each session span
FIELDS = {spans.MERGE: "host_merge_seconds",
          spans.PAIR: "host_pair_seconds",
          spans.EMIT: "host_emit_seconds",
          spans.INSTALL: "host_install_seconds"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def graph():
    return rt.paper_workload("orkut", 300, 8.0, seed=1)


def delta(g, seed=0, k=20):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, g.n, k), rng.integers(0, g.n, k))


def traced(fn):
    """``fn()``'s result and the user ranges it opened on the host:
    name -> list of (start, end) in microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for e in prof.events():
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out, ranges


def inside(span, others):
    s, e = span
    return any(s >= s2 and e <= e2 for s2, e2 in others)


def overlaps(span, others):
    s, e = span
    return any(min(e, e2) > max(s, s2) for s2, e2 in others)


def shipped_bytes(st):
    """What a device-emission dispatch copies to each device: the
    descriptors and the valid-lane count, no anchor table."""
    return DESC_BYTES * st.desc_shape + 4


def check_census_ranges(ranges, dispatches):
    assert CENSUS_SPANS <= set(ranges), sorted(ranges)
    assert all(name.startswith("census.") for name in ranges), sorted(ranges)
    assert len(ranges[spans.WINDOW]) >= 3
    # the anchor table is built at each dispatch's launch, after its
    # window and its upload: outside every window, once a dispatch; the
    # upload and the waits come after the window too
    assert len(ranges[spans.ANCHORS]) == dispatches
    for name in (spans.ANCHORS, spans.UPLOAD, spans.WAIT, spans.GRAPH):
        assert not any(overlaps(r, ranges[spans.WINDOW])
                       for r in ranges[name]), name


def test_census_opens_its_spans_and_only_census_ranges():
    g = graph()
    eng = rt.CensusEngine(device="cpu", emit="device")
    counts, ranges = traced(lambda: eng.run(g, max_items=BUDGET))
    np.testing.assert_array_equal(counts, rt.census_batagelj_mrvar(g))
    check_census_ranges(ranges, eng.stats.chunks)
    assert len(ranges[spans.UPLOAD]) == len(ranges[spans.WINDOW]) \
        == eng.stats.chunks


@pytest.mark.cuda
def test_census_on_the_card_opens_upload_and_wait(cuda):
    g = graph()
    eng = rt.CensusEngine(device=cuda, emit="device")
    eng.run(g, max_items=BUDGET)                   # builds the kernels
    counts, ranges = traced(lambda: eng.run(g, max_items=BUDGET))
    np.testing.assert_array_equal(counts, rt.census_batagelj_mrvar(g))
    st = eng.stats
    check_census_ranges(ranges, st.chunks)
    assert st.plan_upload_bytes_total == shipped_bytes(st) * st.chunks


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("index", [True, False])
def test_session_spans_are_its_stats(emit, index):
    """An update opens the four session spans, side by side, and each
    stats bucket is its span's range total.  One window a recount, so
    the profiler's own cost at each range's ends stays small."""
    g = graph()
    session = rt.CensusEngine(device="cpu").session(
        g, emit=emit, index=index)
    session.census()
    counts, ranges = traced(lambda: session.update(*delta(g)))
    np.testing.assert_array_equal(
        counts, rt.census_batagelj_mrvar(session.graph))
    assert SESSION_SPANS | {spans.UPLOAD, spans.WAIT} <= set(ranges)
    assert all(name.startswith("census.") for name in ranges), sorted(ranges)
    session_ranges = [r for name in SESSION_SPANS for r in ranges[name]]
    for name in SESSION_SPANS:
        for r in ranges[name]:
            assert sum(inside(r, [o]) for o in session_ranges) == 1, name
        total = sum(e - s for s, e in ranges[name]) / 1e6
        got = getattr(session.stats, FIELDS[name])
        assert got == pytest.approx(total, rel=0.05, abs=1e-3), name
    if emit == "device":
        # built at each dispatch's launch, outside the window's emission
        assert len(ranges[spans.ANCHORS]) == session.stats.chunks
        assert not any(overlaps(r, ranges[spans.EMIT])
                       for r in ranges[spans.ANCHORS])


@pytest.mark.parametrize("layout", ["desc", "desc-replicated-2", "host",
                                    "session"])
def test_upload_counter_counts_the_copied_bytes(layout):
    """``plan_upload_bytes_total`` is what the dispatches handed the
    devices, on every device: each host-emission dispatch's
    ``plan_upload_bytes``, and each device-emission dispatch's
    descriptors and valid-lane count, whose anchor table the device
    builds (``plan_upload_bytes`` keeps the JAX package's count, table
    included)."""
    g = graph()
    devices = rt.default_devices(2, "cpu") if layout.endswith("-2") else None
    eng = (rt.CensusEngine(devices=devices) if devices
           else rt.CensusEngine(device="cpu",
                                emit="host" if layout == "host"
                                else "device"))
    if layout == "session":
        session = eng.session(g, max_items=BUDGET)
        session.census()
        session.update(*delta(g))
        st = session.stats
    else:
        eng.run(g, max_items=BUDGET)
        st = eng.stats
    # host emission skips a chunk whose items were all pruned
    dispatches = (sum(1 for c in st.chunk_items if c) if layout == "host"
                  else st.chunks)
    assert dispatches >= 3
    per = st.plan_upload_bytes if layout == "host" else shipped_bytes(st)
    assert st.plan_upload_bytes_total == per * dispatches * st.ndev


def test_span_totals_and_spanned_streams():
    totals = {}
    with pytest.raises(KeyError):
        with spans.span(spans.PAIR, totals):
            raise KeyError("counted all the same")
    assert totals[spans.PAIR] >= 0
    first = totals[spans.PAIR]
    with spans.span(spans.PAIR, totals):
        pass
    assert totals[spans.PAIR] >= first
    seen = []
    for item in spans.spanned(iter(range(3)), spans.EMIT, totals):
        seen.append(item)
        time.sleep(0.02)               # the consumer's time is not counted
    assert seen == [0, 1, 2] and 0 <= totals[spans.EMIT] < 0.02
    with spans.span(spans.WAIT):       # no totals: a range alone
        pass


def test_engine_times_its_host_phases_by_spans_alone():
    source = inspect.getsource(engine)
    assert "perf_counter" not in source
    assert "_TimedIter" not in source and "record_function" not in source
    assert all(name.startswith("census.") for name in (
        getattr(spans, k) for k in dir(spans) if k.isupper()
        and isinstance(getattr(spans, k), str)))
