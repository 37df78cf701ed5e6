"""The port's temporal monitor on the CPU against the JAX package's.

``repro_torch.TriadMonitor(device="cpu")`` against ``repro``'s
``TriadMonitor`` on the same seeded streams, fed in the same batches:
the cases of ``tests/test_temporal.py`` (window parity, every backend ×
both orients × incremental/indexed, tumbling, duplicates and self-loops,
fewer items, observe validation, alarms), the monitor cases of
``tests/test_faults.py`` (budget exhaustion, transparent retries) and
``tests/test_partition.py`` (the partitioned monitor over
``default_devices(4, "cpu")`` against ``default_mesh(4)``).  Each port
backend (``torch``, ``hist``, ``fused``) is held to ``repro``'s ``jnp``
monitor, whose windows run through the engine's jitted steps; those
reference runs are cached.  Censuses, proportions, alarm lists,
degraded windows and each window's ``items``, ``full_items``,
``affected_pairs``, ``chunks`` and ``indexed`` must be equal: the
tolerance is zero.  ``streaming_section`` gives ``repro``'s text for the
same stats.
"""

import functools

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.analysis.report import streaming_section as ref_streaming_section
from repro.core import CensusEngine as RefEngine
from repro.core import Fault as RefFault
from repro.core import FaultPlan as RefFaultPlan
from repro.core import SECURITY_PATTERN_INDICES as REF_PATTERN_INDICES
from repro.core import SECURITY_PATTERNS as REF_PATTERNS
from repro.core import TriadMonitor as RefMonitor
from repro.core import default_mesh
from repro.core import paper_workload as ref_paper_workload
from repro_torch.analysis import streaming_section

torch.set_num_threads(1)

BACKENDS = ("torch", "hist", "fused")

#: per-window stats held to the reference's
WINDOW_STATS = ("items", "full_items", "affected_pairs", "chunks",
                "indexed")


# ------------------------------------------------------------ streams


def stream(seed, n, length, zipf=1.6, mutual_p=0.3):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(zipf, length) - 1) % n
    dst = rng.integers(0, n, length)
    back = rng.random(length) < mutual_p
    src = np.where(back, dst, src)
    return src.astype(np.int64), dst.astype(np.int64)


def scan_burst_stream(rng, n_hosts, per_window, n_windows, attack_windows,
                      n_targets=120):
    """The network_monitor example scenario: zipf background + injected
    port-scan bursts (021D fan-out) in the attack windows."""
    chunks_s, chunks_d = [], []
    for w in range(n_windows):
        k = per_window - (n_targets if w in attack_windows else 0)
        src = (rng.zipf(1.5, k) - 1) % n_hosts
        dst = rng.integers(0, n_hosts, k)
        back = rng.random(k) < 0.3
        src = np.concatenate([src[~back], dst[back]])
        dst = np.concatenate([dst[~back], src[:back.sum()]])
        if w in attack_windows:
            scanner = int(rng.integers(0, n_hosts))
            targets = rng.choice(n_hosts, size=n_targets, replace=False)
            src = np.concatenate([src, np.full(n_targets, scanner)])
            dst = np.concatenate([dst, targets])
        chunks_s.append(src[:per_window])
        chunks_d.append(dst[:per_window])
    return np.concatenate(chunks_s), np.concatenate(chunks_d)


def random_batches(seed, n, batch, batches):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n, batch), rng.integers(0, n, batch))
            for _ in range(batches)]


def cut(src, dst, bounds):
    return [(src[lo:hi], dst[lo:hi]) for lo, hi in zip(bounds, bounds[1:])]


#: name -> (n_nodes, monitor kwargs, batches); the streams of the JAX
#: package's monitor tests
CASES = {
    # ragged batches: windowing must not depend on batch boundaries
    "ragged": (100, dict(window=400, stride=100, history=2),
               lambda: cut(*stream(0, 100, 1600),
                           (0, 250, 900, 901, 1600))),
    "grid": (60, dict(window=150, stride=50, history=2),
             lambda: [stream(1, 60, 450)]),
    "tumbling": (80, dict(window=300), lambda: [stream(2, 80, 900)]),
    "dups": (10, dict(window=6),
             lambda: [(np.array([1, 1, 1, 2, 3, 3]),
                       np.array([2, 2, 1, 1, 4, 4]))]),
    "fewer": (4000, dict(window=800, stride=80, history=2, max_items=1024),
              lambda: [tuple(np.random.default_rng(3).integers(
                  0, 4000, (2, 2400)))]),
    "scan": (200, dict(window=600, history=8, threshold=4.0),
             lambda: [scan_burst_stream(np.random.default_rng(0), 200, 600,
                                        17, {14, 15})]),
    "cache": (150, dict(window=400, history=6, threshold=4.0),
              lambda: cut(*scan_burst_stream(np.random.default_rng(4), 150,
                                             400, 14, {11}),
                          (0, 7 * 400, 14 * 400))),
    "faults": (120, dict(window=300, stride=150, history=3),
               lambda: random_batches(0, 120, 150, 8)),
    "partition": (60, dict(window=300, stride=100, history=2,
                           max_items=1024),
                  lambda: [tuple(np.random.default_rng(29).integers(
                      0, 60, (2, 1500)))]),
}


def feed(mon, case):
    out = [mon.observe(src, dst) for src, dst in CASES[case][2]()]
    return np.concatenate(out) if out else None


def reference_run(case, **kw):
    """``repro``'s ``jnp`` monitor over the case's stream."""
    n, base, _ = CASES[case]
    mon = RefMonitor(n, **{**base, **kw})
    feed(mon, case)
    mon.alarms()
    return mon


#: cached reference runs, keyed by hashable settings
reference = functools.lru_cache(maxsize=None)(reference_run)


def port(case, backend="fused", **kw):
    n, base, _ = CASES[case]
    where = {} if "devices" in kw else {"device": "cpu"}
    mon = rt.TriadMonitor(n, backend=backend, **where, **{**base, **kw})
    out = feed(mon, case)
    return mon, out


def assert_same(got, want):
    np.testing.assert_array_equal(got.censuses, want.censuses)
    np.testing.assert_array_equal(got.proportions(), want.proportions())
    assert got.alarms() == want.alarms()
    assert got.degraded == want.degraded
    assert len(got.window_stats) == len(want.window_stats)
    for t, (a, b) in enumerate(zip(got.window_stats, want.window_stats)):
        if b is None:
            assert a is None, t
            continue
        for f in WINDOW_STATS:
            assert getattr(a, f) == getattr(b, f), (t, f)


def direct_census(src, dst, n, lo, hi, orient="none"):
    g = rt.from_edges(src[lo:hi], dst[lo:hi], n=n)
    return rt.triad_census(rt.build_plan(g, orient=orient), device="cpu")


# ------------------------------------------------------------ window parity


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sliding_windows_match_reference(backend, incremental):
    mon, out = port("ragged", backend, incremental=incremental)
    assert_same(mon, reference("ragged", incremental=incremental))
    assert out.shape == (13, 16)
    src, dst = stream(0, 100, 1600)
    for k, census in enumerate(out):
        np.testing.assert_array_equal(
            census, direct_census(src, dst, 100, 100 * k, 100 * k + 400))


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("backend", ["hist", "fused"])
def test_emit_modes_match_reference(backend, emit):
    mon, _ = port("ragged", backend, emit=emit)
    assert_same(mon, reference("ragged", emit=emit))
    assert all(s.emit == emit for s in mon.window_stats)


@pytest.mark.parametrize("mode", ["indexed", "rebuilt", "full"])
@pytest.mark.parametrize("orient", ["none", "degree"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_backends_orients_match_reference(backend, orient, mode):
    """incremental (indexed and rebuilt pair space) and full recompute,
    each backend × orient, against the same reference run."""
    kw = dict(orient=orient, incremental=mode != "full",
              index=mode != "rebuilt")
    mon, _ = port("grid", backend, **kw)
    assert_same(mon, reference("grid", **kw))
    src, dst = stream(1, 60, 450)
    np.testing.assert_array_equal(
        mon.censuses[-1], direct_census(src, dst, 60, 300, 450, orient))
    assert all(s.indexed == kw["index"] for s in mon.window_stats)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tumbling_matches_reference(backend):
    mon, out = port("tumbling", backend)
    explicit, out_e = port("tumbling", backend, stride=300)
    assert out.shape == (3, 16) and mon.stride == mon.window == 300
    np.testing.assert_array_equal(out, out_e)
    assert_same(mon, reference("tumbling"))


def test_duplicates_and_self_loops_collapse():
    mon, out = port("dups")
    assert_same(mon, reference("dups"))
    src, dst = CASES["dups"][2]()[0]
    np.testing.assert_array_equal(out[0], direct_census(src, dst, 10, 0, 6))


@pytest.mark.parametrize("backend", BACKENDS)
def test_incremental_processes_fewer_items(backend):
    mon, _ = port("fewer", backend)
    assert_same(mon, reference("fewer"))
    slid = mon.window_stats[1:]
    assert slid and all(s.items < s.full_items for s in slid)


# ------------------------------------------------------------ observe input


def both(ctor_kw=None):
    ctor_kw = dict(window=5) if ctor_kw is None else ctor_kw
    return (rt.TriadMonitor(10, device="cpu", **ctor_kw),
            RefMonitor(10, **ctor_kw))


BAD_BATCHES = {
    "empty": ([], []),
    "mismatch": ([1, 2], [3]),
    "high": ([1], [10]),
    "negative": ([-1], [2]),
    "ragged": (np.array([[0, 1], [2]], dtype=object), [1, 2]),
    "nan": (np.array([0.0, np.nan]), [1, 2]),
    "inf": ([1, 2], np.array([np.inf, 1.0])),
}


@pytest.mark.parametrize("name", sorted(BAD_BATCHES))
def test_observe_rejects_like_reference(name):
    src, dst = BAD_BATCHES[name]
    got, want = both()
    with pytest.raises(ValueError) as ref_err:
        want.observe(src, dst)
    with pytest.raises(ValueError) as err:
        got.observe(src, dst)
    assert str(err.value) == str(ref_err.value)


BAD_TIMES = {"nan": [1.0, float("nan")], "negative": [-1.0, 2.0],
             "mismatch": [1.0], "regressed": [0.5, 3.0]}


@pytest.mark.parametrize("name", sorted(BAD_TIMES))
def test_timestamps_rejected_like_reference(name):
    got, want = both()
    for mon in (got, want):
        mon.observe([0, 1], [1, 2], t=[1.0, 2.0])
    with pytest.raises(ValueError) as ref_err:
        want.observe([0, 1], [1, 2], t=BAD_TIMES[name])
    with pytest.raises(ValueError) as err:
        got.observe([0, 1], [1, 2], t=BAD_TIMES[name])
    assert str(err.value) == str(ref_err.value)
    assert got.last_t == want.last_t == 2.0


BAD_CONFIGS = {
    "no nodes": (0, {}), "no window": (5, dict(window=0)),
    "stride past window": (5, dict(window=10, stride=11)),
    "no stride": (5, dict(window=10, stride=0)),
    "no history": (5, dict(window=10, history=0)),
    "emit": (5, dict(emit="cloud")),
    "rebalance unpartitioned": (5, dict(auto_rebalance_threshold=1.2)),
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_rejects_bad_config_like_reference(name):
    n, kw = BAD_CONFIGS[name]
    with pytest.raises(ValueError) as ref_err:
        RefMonitor(n, **kw)
    with pytest.raises(ValueError) as err:
        rt.TriadMonitor(n, device="cpu", **kw)
    assert str(err.value) == str(ref_err.value)


def test_partition_requires_devices():
    with pytest.raises(ValueError, match="requires devices"):
        rt.TriadMonitor(10, device="cpu", partition=True)


def test_legacy_positional_signature():
    mon = rt.TriadMonitor(50, 100, 5, 2.5, device="cpu")
    assert (mon.window, mon.history, mon.threshold) == (100, 5, 2.5)
    assert mon.stride == mon.window
    with pytest.raises(TypeError):
        rt.TriadMonitor(50, 100, 5, 2.5, 10)


def test_2d_input_is_raveled():
    src = np.array([[1, 2], [3, 4]])
    dst = np.array([[5, 6], [7, 8]])
    got = rt.TriadMonitor(12, window=4, device="cpu")
    want = RefMonitor(12, window=4)
    np.testing.assert_array_equal(got.observe(src, dst),
                                  want.observe(src, dst))


def test_partial_window_emits_nothing():
    mon = rt.TriadMonitor(10, window=100, device="cpu")
    out = mon.observe([1, 2], [3, 4])
    assert out.shape == (0, 16) and mon.censuses.shape == (0, 16)
    assert out.dtype == mon.censuses.dtype == np.int64


def test_defaults_to_the_card_and_fused(monkeypatch):
    mon = rt.TriadMonitor(10, device="cpu")
    assert mon.engine.backend == "fused" and mon.emit is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.TriadMonitor(10)


# ------------------------------------------------------------ alarms


def test_pattern_tables_match_reference():
    assert rt.SECURITY_PATTERNS == REF_PATTERNS
    assert rt.SECURITY_PATTERN_INDICES.keys() == REF_PATTERN_INDICES.keys()
    for pattern, idx in REF_PATTERN_INDICES.items():
        np.testing.assert_array_equal(rt.SECURITY_PATTERN_INDICES[pattern],
                                      idx)
        assert rt.SECURITY_PATTERN_INDICES[pattern].dtype == idx.dtype


@pytest.mark.parametrize("backend", BACKENDS)
def test_scan_burst_alarms_match_reference(backend):
    mon, _ = port("scan", backend)
    assert_same(mon, reference("scan"))
    flagged = {a["window"] for a in mon.alarms()
               if a["pattern"] == "scanning"}
    assert {14, 15} <= flagged and len(flagged - {14, 15}) <= 1


def test_robust_baseline_survives_poisoned_history():
    clean = np.zeros(16, np.int64)
    clean[1] = 900
    clean[3] = 10
    poisoned = clean.copy()
    poisoned[3] = 450
    got, want = both(dict(window=5, history=8, threshold=4.0))
    for mon in (got, want):
        for census in [clean] * 6 + [poisoned] * 3:
            mon.record(census)
    assert [a for a in got.alarms()
            if a["pattern"] == "scanning" and a["window"] == 8]
    assert got.alarms() == want.alarms()
    for mon in (got, want):
        mon.record(clean)
    assert not [a for a in got.alarms() if a["window"] == 9]
    assert got.alarms() == want.alarms()
    np.testing.assert_array_equal(got.proportions(), want.proportions())


def test_alarm_cache_is_incremental_and_stable():
    batches = CASES["cache"][2]()
    cached = rt.TriadMonitor(150, device="cpu", **CASES["cache"][1])
    cached.observe(*batches[0])
    first = cached.alarms()
    assert cached.alarms() == first
    cached.observe(*batches[1])
    fresh, _ = port("cache")
    assert cached.alarms() == fresh.alarms()
    assert_same(cached, reference("cache"))


def test_threshold_is_retunable_after_caching():
    mon, _ = port("cache", threshold=1e9)
    assert mon.alarms() == []
    mon.threshold = 4.0
    want = reference("cache")
    assert mon.alarms() == want.alarms() != []


def test_proportions_cached_per_window():
    got, want = both(dict(window=5, history=2))
    c = np.zeros(16, np.int64)
    c[1], c[3] = 50, 25
    for mon in (got, want):
        mon.record(c)
        mon.record(c)
    np.testing.assert_array_equal(got.proportions(), want.proportions())
    np.testing.assert_allclose(got.proportions()[0], c / 75.0)


# ------------------------------------------------------------ faults


#: the fault plans of the JAX package's monitor cases: a 3-deep burst of
#: dispatch errors on device 0 (past a budget of 2 retries: a degraded
#: window), and one transient dispatch error
FAULTS = {
    "budget": [dict(site="dispatch", kind="error", device=0,
                    occurrence=6 + i) for i in range(3)],
    "transient": [dict(site="dispatch", kind="error", occurrence=2)],
}


@functools.lru_cache(maxsize=None)
def reference_faulted(kind):
    plan = RefFaultPlan(faults=[RefFault(**f) for f in FAULTS[kind]])
    return reference_run("faults", faults=plan, max_retries=2,
                         retry_backoff=0.0)


def port_faulted(kind, backend):
    plan = rt.FaultPlan(faults=[rt.Fault(**f) for f in FAULTS[kind]])
    mon, _ = port("faults", backend, faults=plan, max_retries=2,
                  retry_backoff=0.0)
    return mon


@pytest.mark.parametrize("backend", BACKENDS)
def test_monitor_survives_budget_exhaustion(backend):
    mon = port_faulted("budget", backend)
    want = reference_faulted("budget")
    assert_same(mon, want)
    clean = reference("faults")
    deg = {d["window"] for d in mon.degraded}
    assert deg
    for t in range(mon.censuses.shape[0]):
        expect = mon.censuses[t - 1] if t in deg else clean.censuses[t]
        np.testing.assert_array_equal(mon.censuses[t], expect)
    assert mon.window_stats[min(deg)] is None
    assert mon._session.retries == want._session.retries


@pytest.mark.parametrize("backend", BACKENDS)
def test_monitor_transparent_retries(backend):
    mon = port_faulted("transient", backend)
    want = reference_faulted("transient")
    assert_same(mon, want)
    assert not mon.degraded
    np.testing.assert_array_equal(mon.censuses,
                                  reference("faults").censuses)
    assert mon._session.retries == want._session.retries >= 1


def test_a_non_fault_error_surfaces(monkeypatch):
    """Only a FaultError becomes a degraded window; anything else (a CUDA
    error on the card) surfaces from observe."""
    mon = rt.TriadMonitor(120, window=300, stride=150, device="cpu")
    batches = CASES["faults"][2]()
    mon.observe(*batches[0])
    mon.observe(*batches[1])

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(mon._session, "update", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        mon.observe(*batches[2])
    assert not mon.degraded


# ------------------------------------------------------------ partitioned


@functools.lru_cache(maxsize=None)
def reference_partitioned(emit):
    return reference("partition", mesh=default_mesh(4), partition=True,
                     emit=emit)


@pytest.mark.parametrize("emit", ["device", "host"])
def test_partitioned_monitor_matches_reference(emit):
    mon, _ = port("partition", devices=rt.default_devices(4, "cpu"),
                  partition=True, emit=emit)
    want = reference_partitioned(emit)
    assert_same(mon, want)
    np.testing.assert_array_equal(mon.censuses,
                                  reference("partition").censuses)
    for a, b in zip(mon.window_stats, want.window_stats):
        assert a.partitioned and len(a.shard_items) == 4
        assert a.shard_items == b.shard_items
        assert a.graph_resident_bytes == b.graph_resident_bytes


# ------------------------------------------------------------ report


def streamed_stats(budget):
    g = ref_paper_workload("webgraph", n=120, avg_degree=6.0, seed=0)
    ref = RefEngine(backend="jnp")
    ref.run(g, max_items=budget)
    got = rt.CensusEngine(device="cpu", backend="fused")
    got.run(rt.paper_workload("webgraph", n=120, avg_degree=6.0, seed=0),
            max_items=budget)
    return got.stats, ref.stats


@pytest.mark.parametrize("budget", [None, 4096, 300])
def test_streaming_section_matches_reference(budget):
    """The same text for the same stats fields: the port's stats and
    ``repro``'s, each through both functions; the chunk rows and the
    elided middle (more than 16 chunks at a budget of 300) too."""
    got, ref = streamed_stats(budget)
    assert got.chunk_items == ref.chunk_items
    for stats in (got, ref):
        assert streaming_section(stats) == ref_streaming_section(stats)
    text = streaming_section(got)
    assert text.startswith("### §Streaming schedule")
    assert ("| … | … | … |" in text) == (len(got.chunk_items) > 16)
