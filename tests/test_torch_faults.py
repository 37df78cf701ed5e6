"""The port's fault tolerance against the JAX package's: inject, retry,
fail over, checkpoint and resume — and stay bit-identical.

* ``FaultPlan.seeded`` draws the same faults as ``repro``'s, and the
  injector fires, kills devices and poisons exactly as ``repro``'s on the
  same event sequence.
* ``ShardStreamPipeline`` recovers as ``repro``'s does
  (``tests/test_faults.py``): restart from the skip count, propagation
  without a restart factory, budget exhaustion, the watchdog, and thread
  reaping.
* Seeded faulty async runs over ``default_devices(k, "cpu")`` (k in
  {1, 2, 4}, 8 for one orient) give ``repro``'s faulted census, its
  fault-free census and the Batagelj–Mrvar census, bit for bit, for both
  emits and both orients; ``retries``, ``failovers`` and
  ``retired_devices`` equal ``repro``'s wherever two runs of ``repro``
  agree on them, and meet ``repro``'s own inequalities otherwise.
* Checkpoints: resume equals the uninterrupted run, also under further
  faults and from a compacted journal or one ``repro`` wrote; a
  completed journal dispatches nothing; another graph's is refused.
* Sessions (``partition`` False and True) retry transient faults, raise
  past the budget, and warm-resume from a checkpoint.

``repro`` runs its ``jnp`` engine over ``default_mesh(k)``; the port its
``fused`` backend (the plain version on the CPU).  All integers: the
tolerance is zero.
"""

import dataclasses
import functools
import os
import threading

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import CensusEngine as RefEngine
from repro.core import default_mesh, scale_free_digraph
from repro.core.faults import Fault as RefFault
from repro.core.faults import FaultPlan as RefFaultPlan
from repro_torch import (Fault, FaultError, FaultPlan, InjectedFault,
                         ProducerStalledError, ShardStreamPipeline)
from repro_torch.core.engine import _validate_partials
from repro_torch.core.faults import poison_result

torch.set_num_threads(1)

#: the async runs' item budget (as tests/test_faults.py): 12 windows per
#: shard at k = 4
BUDGET = 900


@functools.lru_cache(maxsize=None)
def ref_graph(seed=3):
    return scale_free_digraph(n=120, avg_degree=4, exponent=2.2,
                              mutual_p=0.3, seed=seed)


@functools.lru_cache(maxsize=None)
def graph(seed=3):
    g = ref_graph(seed)
    return rt.CompactDigraph(n=g.n, indptr=g.indptr.copy(),
                             packed=g.packed.copy(), num_arcs=g.num_arcs)


@functools.lru_cache(maxsize=None)
def oracle(orient="none"):
    return RefEngine().run(ref_graph(), orient=orient)


def seeded(plan_cls, k):
    return plan_cls.seeded(31 + k, k, producer_errors=1, dispatch_errors=1,
                           retire_devices=1 if k > 1 else 0)


def counts(st):
    return st.retries, st.failovers, list(st.retired_devices)


@functools.lru_cache(maxsize=None)
def ref_faulted(k, emit, orient, run):
    """``repro``'s seeded faulty async run (``run`` tells two apart)."""
    eng = RefEngine(mesh=default_mesh(k), partition=True, schedule="async",
                    faults=seeded(RefFaultPlan, k), retry_backoff=0.0)
    census = eng.run(ref_graph(), max_items=BUDGET, emit=emit,
                     orient=orient)
    return census, counts(eng.stats)


def port_engine(k, **kw):
    return rt.CensusEngine(devices=rt.default_devices(k, "cpu"),
                           partition=True, schedule="async",
                           retry_backoff=0.0, **kw)


# ------------------------------------------------------------ fault plans


def as_tuples(faults):
    return [dataclasses.astuple(f) for f in faults]


@pytest.mark.parametrize("seed", [0, 5, 11, 12])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_seeded_plan_matches_reference(shards, seed):
    kw = dict(producer_errors=2, dispatch_errors=2,
              retire_devices=min(2, shards), delays=1, poisons=1,
              delay_seconds=0.02)
    got = FaultPlan.seeded(seed, shards, **kw)
    want = RefFaultPlan.seeded(seed, shards, **kw)
    assert as_tuples(got.faults) == as_tuples(want.faults)
    assert got.seed == want.seed == seed
    if shards > 1:
        assert 0 not in {f.device for f in got.faults if f.persistent}


def test_fault_validation():
    with pytest.raises(ValueError, match="site"):
        Fault("nowhere")
    with pytest.raises(ValueError, match="kind"):
        Fault("dispatch", "explode")
    with pytest.raises(ValueError, match="persistent"):
        Fault("producer", "error", persistent=True)
    assert issubclass(InjectedFault, FaultError)


def test_injector_matches_reference():
    """The same event sequence through both injectors: the same events
    raise (with the same message), the same devices die, the same
    poisons are taken."""
    spec = [("dispatch", "error", None, 1, 1, False),
            ("dispatch", "error", None, 2, 0, True),
            ("upload", "error", 3, None, 2, False),
            ("dispatch", "poison", None, 0, 1, False),
            ("producer", "error", 1, None, 0, False),
            ("dispatch", "delay", None, 3, 0, False)]

    def make(fault_cls, plan_cls):
        return plan_cls(faults=[
            fault_cls(site, kind, shard=sh, device=d, occurrence=o,
                      seconds=0.0, persistent=p)
            for site, kind, sh, d, o, p in spec]).injector()

    ours, theirs = make(Fault, FaultPlan), make(RefFault, RefFaultPlan)
    rng = np.random.default_rng(0)
    for _ in range(200):
        site = ("producer", "upload", "dispatch")[int(rng.integers(3))]
        shard = int(rng.integers(4))
        device = None if site == "producer" else int(rng.integers(4))
        out = []
        for inj in (ours, theirs):
            try:
                inj.fire(site, shard=shard, device=device)
                out.append(("ok", inj.take_poison()))
            except Exception as exc:   # noqa: BLE001 - compared below
                out.append((type(exc).__name__, str(exc)))
        assert out[0] == out[1]
        assert ([ours.device_is_dead(d) for d in range(4)]
                == [theirs.device_is_dead(d) for d in range(4)])
    assert len(ours.fired) == len(theirs.fired)
    assert ours.device_is_dead(2)


def test_poison_fails_validation():
    hist = np.arange(64, dtype=np.int64)
    inter = np.array([3, 4, 5], dtype=np.int64)
    ph, pi = poison_result(hist, inter)
    assert (ph < 0).all() and pi is inter
    with pytest.raises(FaultError):
        _validate_partials(ph, pi)
    _validate_partials(hist, inter)


# ---------------------------------------------------- pipeline robustness


def test_producer_error_restarts_from_skip():
    attempts = {"n": 0}

    def flaky(skip=0):
        attempts["n"] += 1
        for k in range(skip, 6):
            if k == 3 and attempts["n"] == 1:
                raise RuntimeError("flake")
            yield k

    pipe = ShardStreamPipeline(
        [flaky()], restart=lambda slot, skip: flaky(skip), backoff=0.0)
    got = [w for _, w in pipe]
    pipe.close()
    assert got == list(range(6))
    assert pipe.producer_retries == 1


def test_producer_error_without_restart_propagates():
    def dead():
        yield 0
        raise RuntimeError("no recovery")

    pipe = ShardStreamPipeline([dead()])
    with pytest.raises(RuntimeError, match="no recovery"):
        list(pipe)
    pipe.close()


def test_retry_budget_exhaustion_propagates():
    def always(skip=0):
        raise RuntimeError("permafail")
        yield  # pragma: no cover

    pipe = ShardStreamPipeline(
        [always()], restart=lambda slot, skip: always(skip),
        max_retries=2, backoff=0.0)
    with pytest.raises(RuntimeError, match="permafail"):
        list(pipe)
    pipe.close()
    assert pipe.producer_retries == 2


def test_watchdog_restarts_hung_producer():
    hang = threading.Event()
    release = threading.Event()

    def hung(skip=0):
        for k in range(skip, 4):
            if k == 2 and not hang.is_set():
                hang.set()
                release.wait(30)       # never finishes in time
            yield k

    pipe = ShardStreamPipeline(
        [hung()], restart=lambda slot, skip: hung(skip),
        watchdog=0.3, backoff=0.0)
    got = [w for _, w in pipe]
    release.set()
    pipe.close()
    assert got == list(range(4))
    assert pipe.watchdog_fires >= 1


def test_watchdog_exhaustion_raises_stalled():
    release = threading.Event()

    def hung(skip=0):
        release.wait(30)
        yield 0  # pragma: no cover

    pipe = ShardStreamPipeline(
        [hung()], restart=lambda slot, skip: hung(skip),
        watchdog=0.2, max_retries=1, backoff=0.0)
    with pytest.raises(ProducerStalledError):
        list(pipe)
    release.set()
    pipe.close()
    assert issubclass(ProducerStalledError, FaultError)


def test_context_manager_reaps_threads():
    def slow():
        yield from range(1000)

    with ShardStreamPipeline([slow(), slow()], depth=2) as pipe:
        next(iter(pipe))
        threads = list(pipe._threads)
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()


def test_context_manager_reaps_on_exception():
    def src():
        yield from range(100)

    try:
        with ShardStreamPipeline([src()]) as pipe:
            raise KeyboardInterrupt
    except KeyboardInterrupt:
        pass
    for t in pipe._threads:
        t.join(timeout=5)
        assert not t.is_alive()


def test_pipeline_validation():
    with pytest.raises(ValueError, match="max_retries"):
        ShardStreamPipeline([], max_retries=-1)


# -------------------------------------------------- engine runs, faulted


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("k, orient", [
    (1, "none"), (1, "degree"), (2, "none"), (2, "degree"), (4, "none"),
    (4, "degree"), (8, "none")])
def test_faulted_run_matches_reference(k, orient, emit):
    want, want_counts = ref_faulted(k, emit, orient, 0)
    _, again = ref_faulted(k, emit, orient, 1)
    np.testing.assert_array_equal(want, oracle(orient))
    eng = port_engine(k, faults=seeded(FaultPlan, k))
    got = eng.run(graph(), max_items=BUDGET, emit=emit, orient=orient)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rt.census_batagelj_mrvar(graph()))
    st = eng.stats
    for name, mine, theirs, theirs2 in zip(
            ("retries", "failovers", "retired_devices"), counts(st),
            want_counts, again):
        if theirs == theirs2:
            assert mine == theirs, name
    assert st.retries >= 1
    if k > 1:
        assert st.failovers >= 1 and st.retired_devices
    assert "faults[" in st.summary()
    # every window landed once
    assert st.chunks == sum(st.shard_steps) == len(st.chunk_items)


def test_slow_device_and_poison():
    plan = dict(producer_errors=0, dispatch_errors=0, delays=2, poisons=2,
                delay_seconds=0.02)
    ref = RefEngine(mesh=default_mesh(4), partition=True,
                    faults=RefFaultPlan.seeded(9, 4, **plan),
                    retry_backoff=0.0)
    want = ref.run(ref_graph(), max_items=BUDGET)
    eng = port_engine(4, faults=FaultPlan.seeded(9, 4, **plan))
    got = eng.run(graph(), max_items=BUDGET)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle())
    # each poison forces a re-dispatch
    assert eng.stats.retries == ref.stats.retries >= 1


def test_every_device_retired_raises():
    plan = FaultPlan(faults=[
        Fault("dispatch", "error", device=d, occurrence=0, persistent=True)
        for d in range(2)])
    eng = port_engine(2, faults=plan)
    with pytest.raises(FaultError, match="every device"):
        eng.run(graph(), max_items=BUDGET)


def test_exhausted_budget_retires_the_device():
    """Transient errors past ``max_retries`` on one device retire it; the
    run completes on the survivor."""
    plan = FaultPlan(faults=[
        Fault("dispatch", "error", device=1, occurrence=i)
        for i in range(3)])
    eng = port_engine(2, faults=plan, max_retries=1)
    np.testing.assert_array_equal(eng.run(graph(), max_items=BUDGET),
                                  oracle())
    assert eng.stats.retired_devices == [1]
    assert eng.stats.retries == 2


def test_engine_validation():
    devices = rt.default_devices(2, "cpu")
    for kw, match in ((dict(max_retries=-1), "max_retries"),
                      (dict(retry_backoff=-1.0), "retry_backoff"),
                      (dict(watchdog_timeout=0.0), "watchdog_timeout")):
        with pytest.raises(ValueError, match=match):
            rt.CensusEngine(devices=devices, **kw)


def test_shard_report_fault_section():
    plan = dict(producer_errors=1, dispatch_errors=2, retire_devices=1)
    ref = RefEngine(mesh=default_mesh(8), partition=True,
                    faults=RefFaultPlan.seeded(5, 8, **plan),
                    retry_backoff=0.0)
    ref.run(ref_graph(), max_items=BUDGET)
    eng = port_engine(8, faults=FaultPlan.seeded(5, 8, **plan))
    eng.run(graph(), max_items=BUDGET)
    part = rt.partition_graph(graph(), num_shards=8)
    text = rt.shard_report(part, stats=eng.stats)
    assert "fault tolerance:" in text
    assert "retired devices" in text and "failovers" in text
    assert "fault tolerance:" not in rt.shard_report(part)
    assert "fault tolerance:" not in rt.shard_report(part,
                                                     stats=rt.EngineStats(
                                                         "fused", "none",
                                                         False, None, 0, 0,
                                                         0))
    if counts(eng.stats) == counts(ref.stats):
        from repro.core import partition_graph as ref_partition_graph
        from repro.core import shard_report as ref_shard_report
        want = ref_shard_report(ref_partition_graph(ref_graph(),
                                                    num_shards=8),
                                stats=ref.stats)
        assert text.split("fault tolerance:")[1] == \
            want.split("fault tolerance:")[1]


# ----------------------------------------------------- checkpoint/resume


class _Killer:
    """Progress callback that raises after ``at`` landed windows."""

    def __init__(self, at):
        self.at = at
        self.seen = 0

    def __call__(self, done, total, num=None):
        self.seen += 1
        if self.seen == self.at:
            raise KeyboardInterrupt


@pytest.mark.parametrize("emit", ["device", "host"])
def test_resume_equals_uninterrupted(tmp_path, emit):
    ck = str(tmp_path / "run.ckpt")
    eng = port_engine(4)
    with pytest.raises(KeyboardInterrupt):
        eng.run(graph(), max_items=BUDGET, emit=emit, checkpoint=ck,
                progress=_Killer(4))
    assert os.path.getsize(ck) > 0
    got = eng.resume(graph(), ck, max_items=BUDGET, emit=emit)
    np.testing.assert_array_equal(got, oracle())
    st = eng.stats
    assert st.resumed_windows >= 1
    windows = rt.ShardSchedule(
        [sh.space for sh in rt.partition_graph(graph(),
                                               num_shards=4).shards],
        BUDGET, 4).total_windows
    if emit == "device":
        assert st.resumed_windows + sum(st.shard_steps) == windows
    assert len(st.chunk_items) == st.chunks


def test_resume_under_further_faults(tmp_path):
    ck = str(tmp_path / "run.ckpt")
    with pytest.raises(KeyboardInterrupt):
        port_engine(4).run(graph(), max_items=BUDGET, checkpoint=ck,
                           progress=_Killer(3))
    plan = FaultPlan.seeded(2, 4, producer_errors=0, dispatch_errors=1,
                            retire_devices=1)
    eng = port_engine(4, faults=plan)
    got = eng.resume(graph(), ck, max_items=BUDGET)
    np.testing.assert_array_equal(got, oracle())
    assert eng.stats.resumed_windows >= 1
    assert eng.stats.failovers >= 1


def test_completed_checkpoint_dispatches_nothing(tmp_path):
    ck = str(tmp_path / "run.ckpt")
    eng = port_engine(4)
    want = eng.run(graph(), max_items=BUDGET, checkpoint=ck)
    np.testing.assert_array_equal(want, oracle())
    windows = eng.stats.resumed_windows + sum(eng.stats.shard_steps)
    got = eng.resume(graph(), ck, max_items=BUDGET)
    np.testing.assert_array_equal(got, want)
    assert eng.stats.resumed_windows == windows
    assert sum(eng.stats.shard_steps) == 0
    assert eng.stats.dispatches_total == 0


def test_fingerprint_mismatch_rejected(tmp_path):
    ck = str(tmp_path / "run.ckpt")
    eng = port_engine(4)
    eng.run(graph(), max_items=BUDGET, checkpoint=ck)
    with pytest.raises(FaultError, match="different run"):
        eng.resume(graph(seed=99), ck, max_items=BUDGET)
    with pytest.raises(FaultError, match="different run"):
        eng.resume(graph(), ck, max_items=BUDGET, emit="host")


def test_checkpoint_requires_async_partitioned(tmp_path):
    path = str(tmp_path / "x.ckpt")
    with pytest.raises(ValueError, match="checkpoint"):
        rt.CensusEngine(devices=rt.default_devices(4, "cpu")).run(
            graph(), max_items=BUDGET, checkpoint=path)
    with pytest.raises(ValueError, match="checkpoint"):
        port_engine(4).run(graph(), max_items=BUDGET, checkpoint=path,
                           schedule="lockstep")
    with pytest.raises(FileNotFoundError):
        port_engine(4).resume(graph(), str(tmp_path / "missing.ckpt"),
                              max_items=BUDGET)


def test_compact_checkpoint_resumes_identically(tmp_path):
    ck = str(tmp_path / "run.ckpt")
    with pytest.raises(KeyboardInterrupt):
        port_engine(4).run(graph(), max_items=BUDGET, checkpoint=ck,
                           progress=_Killer(4))
    info = rt.CensusEngine.compact_checkpoint(ck)
    assert info["records"] >= info["compacted"] >= 1
    assert info["compacted_bytes"] == os.path.getsize(ck)
    assert info["compacted_bytes"] <= info["bytes"]
    eng = port_engine(4)
    np.testing.assert_array_equal(eng.resume(graph(), ck, max_items=BUDGET),
                                  oracle())
    assert eng.stats.resumed_windows >= 1
    info2 = rt.CensusEngine.compact_checkpoint(ck)
    assert info2["compacted"] >= info["compacted"]
    np.testing.assert_array_equal(eng.resume(graph(), ck, max_items=BUDGET),
                                  oracle())
    assert sum(eng.stats.shard_steps) == 0


def test_compact_checkpoint_rejects_bad_journals(tmp_path):
    with pytest.raises(FileNotFoundError):
        rt.CensusEngine.compact_checkpoint(str(tmp_path / "missing.ckpt"))
    empty = tmp_path / "empty.ckpt"
    empty.write_text("")
    with pytest.raises(FaultError, match="empty"):
        rt.CensusEngine.compact_checkpoint(str(empty))
    bad = tmp_path / "bad.ckpt"
    bad.write_text('{"v": 99}\n')
    with pytest.raises(FaultError, match="version"):
        rt.CensusEngine.compact_checkpoint(str(bad))


@pytest.mark.parametrize("emit", ["device", "host"])
def test_resume_from_reference_journal(tmp_path, emit):
    """The journal format is ``repro``'s: the port resumes a run that
    ``repro`` was killed in, from the windows ``repro`` landed."""
    ck = str(tmp_path / "ref.ckpt")
    ref = RefEngine(mesh=default_mesh(4), partition=True, schedule="async")
    with pytest.raises(KeyboardInterrupt):
        ref.run(ref_graph(), max_items=BUDGET, emit=emit, checkpoint=ck,
                progress=_Killer(5))
    eng = port_engine(4)
    got = eng.resume(graph(), ck, max_items=BUDGET, emit=emit)
    np.testing.assert_array_equal(got, oracle())
    assert eng.stats.resumed_windows >= 1


# ----------------------------------------------------------- sessions


def session_plan(fault_cls, plan_cls):
    return plan_cls(faults=[
        fault_cls("dispatch", "error", occurrence=1),
        fault_cls("dispatch", "poison", occurrence=3),
        fault_cls("upload", "error", occurrence=5)])


@pytest.mark.parametrize("emit", ["device", "host"])
@pytest.mark.parametrize("partition", [False, True])
def test_session_retries_transient_faults(partition, emit):
    ref = RefEngine(mesh=default_mesh(4), partition=partition, emit=emit,
                    faults=session_plan(RefFault, RefFaultPlan),
                    retry_backoff=0.0)
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          partition=partition, emit=emit,
                          faults=session_plan(Fault, FaultPlan),
                          retry_backoff=0.0)
    delta = ([0, 1, 2], [3, 4, 5], [], [])
    with ref.session(ref_graph(), max_items=BUDGET) as r, \
            eng.session(graph(), max_items=BUDGET) as s:
        got = s.census()
        np.testing.assert_array_equal(got, oracle())
        np.testing.assert_array_equal(got, r.census())
        assert s.retries == r.retries >= 2
        assert s.stats.retries == s.retries
        np.testing.assert_array_equal(s.update(*delta), r.update(*delta))
        assert s.retries == r.retries
        assert s.stats.chunk_items == r.stats.chunk_items


@pytest.mark.parametrize("partition", [False, True])
def test_session_budget_exhaustion_raises(partition):
    plan = FaultPlan(faults=[
        Fault("dispatch", "error", occurrence=2 + i) for i in range(4)])
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          partition=partition, faults=plan, max_retries=2,
                          retry_backoff=0.0)
    with eng.session(graph(), max_items=BUDGET) as s:
        with pytest.raises(FaultError):
            s.census()
        assert s.retries == 2


@pytest.mark.parametrize("partition", [False, True])
def test_session_context_manager_closes(partition):
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          partition=partition)
    with eng.session(graph(), max_items=BUDGET) as s:
        s.census()
    with pytest.raises(RuntimeError, match="closed"):
        s.census()
    with pytest.raises(RuntimeError, match="closed"):
        s.update([0], [1])
    s.close()     # idempotent


@pytest.mark.parametrize("partition", [False, True])
def test_session_checkpoint_warm_resume(tmp_path, partition):
    ck = str(tmp_path / "sess.ckpt")
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"),
                          partition=partition)
    with eng.session(graph(), max_items=BUDGET) as s:
        s.census()
        s.save_checkpoint(ck)
    with eng.session(graph(), max_items=BUDGET) as warm:
        np.testing.assert_array_equal(warm.load_checkpoint(ck), oracle())
        c_warm = warm.update([0, 1, 2], [3, 4, 5])
    with eng.session(graph(), max_items=BUDGET) as cold:
        cold.census()
        c_cold = cold.update([0, 1, 2], [3, 4, 5])
    np.testing.assert_array_equal(c_warm, c_cold)
    # the file is repro's format: a repro session adopts it too
    ref = RefEngine(mesh=default_mesh(4), partition=partition)
    with ref.session(ref_graph(), max_items=BUDGET) as r:
        np.testing.assert_array_equal(r.load_checkpoint(ck), oracle())


def test_session_checkpoint_mismatch_and_missing_census(tmp_path):
    ck = str(tmp_path / "sess.ckpt")
    eng = rt.CensusEngine(devices=rt.default_devices(4, "cpu"))
    with eng.session(graph(), max_items=BUDGET) as s:
        with pytest.raises(RuntimeError, match="census"):
            s.save_checkpoint(ck)
        s.census()
        s.save_checkpoint(ck)
    with eng.session(graph(seed=99), max_items=BUDGET) as other:
        with pytest.raises(FaultError, match="does not match"):
            other.load_checkpoint(ck)


def test_single_device_session_faults_match_reference():
    ref = RefEngine(faults=session_plan(RefFault, RefFaultPlan),
                    retry_backoff=0.0)
    eng = rt.CensusEngine(device="cpu",
                          faults=session_plan(Fault, FaultPlan),
                          retry_backoff=0.0)
    with ref.session(ref_graph(), max_items=300) as r, \
            eng.session(graph(), max_items=300) as s:
        np.testing.assert_array_equal(s.census(), r.census())
        assert s.retries == r.retries >= 2
        assert s.stats.retries == r.stats.retries
