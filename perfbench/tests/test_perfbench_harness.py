"""The harness on the CPU at test size: the result line, files found by
name, BENCHMARK.json against the files, and faults planted in the timed
path turning ``correct`` false."""

import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

from perfbench import harness  # noqa: E402
from perfbench_tiny import tiny_tree  # noqa: E402

CPU = torch.device("cpu")
CELLS = ("patents.census", "orkut.census", "patents.update")


def run(root, cell, trace=False, seconds=0.2, seed=2**31 + 5):
    return harness.run_cell(cell, seed, seconds, trace, CPU,
                            time.perf_counter(), root=root)[0]


@pytest.fixture(autouse=True)
def jax_elsewhere_in_this_worker(monkeypatch):
    """A test worker may hold ``jax`` and ``repro`` from another file: the
    runs here skip the check, which a fresh interpreter makes in
    ``test_perfbench_isolation.py``."""
    monkeypatch.setattr(harness, "FORBIDDEN", frozenset())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("perfbench") / "perfbench")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_reports_its_end_to_end_metrics(tree, cell):
    res = run(tree, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    rate = "update_s" if cell.endswith("update") else "census_s"
    assert set(res["metrics"]) == {rate, "setup_s"}
    assert res["checks"] == {"census_gap": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_cells_host_metrics(tree, bench, cell):
    res = run(tree, cell, trace=True)
    assert res["correct"]
    want = {m["name"] for m in bench["per_layer"]
            if cell in m["workloads"] and m["source"] != "device_trace"}
    # no device on the CPU: the device-trace metrics find nothing to read
    assert set(res["metrics"]) == want
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_benchmark_json_matches_the_files(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    for cfg in bench["configs"]:
        data = json.loads((ROOT / cfg["file"]).read_text())
        assert data["name"] == cfg["name"]
        assert data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
    rates = set()
    for cell in bench["workloads"]:
        spec = json.loads(
            (ROOT / "perfbench/workloads" / f"{cell['name']}.json")
            .read_text())
        assert {k: cell[k] for k in spec} == spec
        traffic = json.loads(
            (ROOT / "perfbench/traffic" / f"{spec['traffic']}.json")
            .read_text())
        rates.add(harness.load_module(
            ROOT / "perfbench/loops" / f"{traffic['loop']}.py").END_TO_END)
    assert {m["name"] for m in bench["end_to_end"]} == rates | {"setup_s"}
    used = set()
    for metric in bench["per_layer"]:
        mod = harness.metric_module(ROOT / "perfbench", metric["name"])
        assert mod.UNIT == metric["unit"]
        used.add(Path(mod.__file__).name)
    # every reader serves some metric
    assert used == {p.name for p in (ROOT / "perfbench/metrics").glob("*.py")}


def test_a_cell_and_a_metric_are_added_as_new_files_only(tmp_path):
    root = tiny_tree(tmp_path / "perfbench")
    cfg = json.loads((root / "configs/orkut-hub.json").read_text())
    cfg.update(name="dummy-graph", n=150, avg_degree=3.0)
    (root / "configs/dummy-graph.json").write_text(json.dumps(cfg))
    cell = dict(config="dummy-graph", traffic="census-degree", chips=1,
                why="a test cell")
    (root / "workloads/dummy.census.json").write_text(json.dumps(cell))
    (root / "metrics/calls.dummy.py").write_text(
        'UNIT = "count"\n\n\ndef read(ctx):\n    return ctx["calls"]\n')
    bench_file = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["workloads"].append(dict(name="dummy.census", **cell))
    bench["per_layer"] += [
        dict(name="calls.dummy", unit="count", better="higher",
             source="program_counter", layer="engine loop",
             moves="census_s", workloads=["dummy.census"]),
        # a second cell of an existing metric, with no file of its own
        dict(name="idle_share.dummy", unit="%", better="lower",
             source="device_trace", layer="device", moves="census_s",
             workloads=["dummy.census"])]
    bench_file.write_text(json.dumps(bench))
    res = run(root, "dummy.census", trace=True)
    assert res["correct"]
    assert res["metrics"]["calls.dummy"] == {"value": res["attempted"],
                                             "unit": "count"}
    assert "calls.dummy" not in run(root, "patents.census", trace=True)[
        "metrics"]
    assert harness.metric_module(root, "idle_share.dummy").UNIT == "%"


def test_a_metric_without_cells_is_read_where_its_end_to_end_metric_is():
    bench = dict(per_layer=[
        dict(name="a.census", moves="census_s", workloads=["x.census"]),
        dict(name="b", moves="census_s"),
        dict(name="c", moves="update_s"),
        dict(name="d", moves="setup_s")])
    assert harness.cell_metrics(bench, "x.census", "census_s") == [
        "a.census", "b", "d"]
    assert harness.cell_metrics(bench, "y.update", "update_s") == ["c", "d"]


def test_a_run_that_loaded_the_jax_package_prints_no_result(
        tree, monkeypatch):
    monkeypatch.setattr(harness, "FORBIDDEN", frozenset({"jax", "repro"}))
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    with pytest.raises(RuntimeError, match="repro"):
        run(tree, "patents.census")


def altered_answer(engine_run):
    """A census with one triad moved from 003 to 012 where it is made:
    the counts still sum to C(n, 3)."""
    def run(*args, **kwargs):
        out = engine_run(*args, **kwargs).copy()
        out[0] -= 1
        out[1] += 1
        return out
    return run


def half_the_windows(dispatch):
    """Every second window of a census or an update left out; the rest
    summed as if it were all."""
    def run(pipes, launches, steps, *args, **kwargs):
        return dispatch(pipes, launches,
                        (s for i, s in enumerate(steps) if i % 2 == 0),
                        *args, **kwargs)
    return run


def unchanged_state(update):
    """An update that returns the session's census without applying the
    delta."""
    def run(self, *args, **kwargs):
        return self._census.copy()
    return run


@pytest.mark.parametrize("cell, fault", [
    ("patents.census", "altered"), ("orkut.census", "altered"),
    ("patents.update", "altered"), ("patents.census", "half"),
    ("orkut.census", "half"), ("patents.update", "half"),
    ("patents.update", "unchanged")])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                 cell, fault):
    from repro_torch.core import engine
    root = tiny_tree(tmp_path / "perfbench", max_items=256)
    clean = run(root, cell)
    assert clean["correct"]
    if fault == "altered":
        if cell.endswith("update"):
            monkeypatch.setattr(engine.EngineSession, "update",
                                altered_answer(engine.EngineSession.update))
        else:
            monkeypatch.setattr(engine.CensusEngine, "run",
                                altered_answer(engine.CensusEngine.run))
    elif fault == "half":
        monkeypatch.setattr(engine, "_dispatch",
                            half_the_windows(engine._dispatch))
    else:
        monkeypatch.setattr(engine.EngineSession, "update",
                            unchanged_state(engine.EngineSession.update))
    res = run(root, cell)
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["census_gap"]["value"] > 0
