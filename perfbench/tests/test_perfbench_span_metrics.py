"""The readers of the program's span metrics on a hand-made context: each
is its span's host seconds over the calls, and nothing without a trace or
where the program opens no such span."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

PERFBENCH = ROOT / "perfbench"
#: metric -> the program span it reads
SPANS = {"anchor_s.census": "census.window.anchors",
         "graph_s.census": "census.graph",
         "upload_s.census": "census.upload",
         "wait_s.census": "census.wait",
         "install_s.update": "census.session.install",
         "wait_s.update": "census.wait"}


def ctx(host_s, calls=4):
    trace = None if host_s is None else dict(host_s=host_s)
    return dict(calls=calls, trace=trace, records=[])


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reader_is_its_span_over_the_calls(name):
    mod = harness.metric_module(PERFBENCH, name)
    assert mod.UNIT == "s"
    host_s = {"census.window": 9.0, "census.plan": 1.0, SPANS[name]: 2.0}
    assert mod.read(ctx(host_s)) == pytest.approx(0.5)
    assert mod.read(ctx(None)) is None
    # a program that opens no such span, as before the spans were added
    assert mod.read(ctx({"census.window": 9.0})) is None


def test_span_metrics_name_cells_and_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    rate = {"census": "census_s", "update": "update_s"}
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPANS:
        metric = entries[name]
        assert metric["source"] == "program_span"
        assert metric["workloads"] and set(metric["workloads"]) <= set(cells)
        for cell in metric["workloads"]:
            assert metric["moves"] == rate[cell.rsplit(".", 1)[1]]
        mod = harness.metric_module(PERFBENCH, name)
        assert Path(mod.__file__).parent == PERFBENCH / "metrics"
