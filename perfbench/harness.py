"""One run of one cell: set-up, the measured window, the reference check
and the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own under the benchmark's folder,
found by name:

* ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips``, ``why``;
* ``configs/<config>.json``: the deployment, its source and its cuts;
* ``traffic/<traffic>.json``: the mix's parameters and the ``loop`` that
  drives the program with them (``loops/<loop>.py``);
* ``metrics/<metric>.py``, or ``metrics/<stem>.py`` for every metric
  named ``<stem>.<suffix>`` without a file of its own: ``UNIT`` and
  ``read(ctx)``, which returns the metric's value or ``None`` where the
  run has nothing for it to read.

A traced run reads the per-layer metrics of ``BENCHMARK.json`` (beside
the benchmark's folder) whose ``workloads`` list the cell, or, for a
metric without ``workloads``, whose ``moves`` the cell reports.

A loop module gives ``END_TO_END`` (its rate metric) and a ``Loop`` class:
set-up in the constructor (warm call included), ``call()``, ``record()``
(the program's counters after a call), ``release()`` and
``expected(calls, acc)`` (the reference's answers by call index, and the
graph's least work or ``None``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import trace as tracing

ROOT = Path(__file__).resolve().parent
#: top-level modules that no run may load: the JAX stack and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def load_json(root: Path, kind: str, name: str) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded top-level module names that no run may hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & FORBIDDEN)


def device_info(device, trace: dict | None) -> dict:
    if device.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1, memory_peak_bytes=int(
                        torch.cuda.max_memory_allocated(device)))
    else:
        info = dict(platform=device.type, kind=device.type, count=1,
                    memory_peak_bytes=0)
    if trace is not None:
        info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return info


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, rate: str) -> list[str]:
    """The per-layer metrics that a traced run of ``cell``, which reports
    ``rate``, reads."""
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in (rate, "setup_s"))]


def metric_module(root: Path, name: str):
    """``metrics/<name>.py``, or else ``metrics/<stem>.py`` for a name
    ``<stem>.<suffix>``."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def load_cell(cell: str, root: Path = ROOT):
    """The cell's configuration, traffic mix and loop module."""
    work = load_json(root, "workloads", cell)
    cfg = load_json(root, "configs", work["config"])
    traffic = load_json(root, "traffic", work["traffic"])
    return cfg, traffic, load_module(root / "loops" / f"{traffic['loop']}.py")


def measure(loop, seconds: float) -> tuple[list, list, float]:
    """Whole calls until ``seconds`` have passed: each call's answer and
    the program's counters after it (with the call's ``wall_s``), and the
    time from the window's start to the end of its last call."""
    outputs, records = [], []
    with record_function(tracing.WINDOW):
        t0 = t = time.perf_counter()
        while t - t0 < seconds:
            with record_function(tracing.CALL):
                outputs.append(np.asarray(loop.call()))
            t, last = time.perf_counter(), t
            records.append(dict(loop.record(), wall_s=t - last))
        window_s = t - t0
    return outputs, records, window_s


def judge(outputs: list, want: dict) -> list[int]:
    """The largest count difference of each compared answer."""
    return [int(np.abs(np.asarray(outputs[i], dtype=np.int64)
                       - np.asarray(counts, dtype=np.int64)).max())
            for i, counts in want.items()]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT) -> tuple[dict, list[str]]:
    """Run ``cell`` once; returns the result line's object and the lines
    of the numbers compared, each beside its limit."""
    cfg, traffic, loop_mod = load_cell(cell, root)
    t_loop = time.perf_counter()
    loop = loop_mod.Loop(cfg, traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_loop - t_start, **loop.phases}

    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    outputs, records, window_s = measure(loop, seconds)
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = tracing.summarize(prof)
        prof = None
    device_line = device_info(device, summary)

    loop.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want, least = loop.expected(len(outputs))
    phases["reference"] = time.perf_counter() - t_ref
    gaps = judge(outputs, want)
    gap = max(gaps)
    failed = sum(g > 0 for g in gaps)
    checks = {"census_gap": {"value": gap, "limit": 0}}
    walls = sorted(r["wall_s"] for r in records)
    lines = ["seconds: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in phases.items()),
             f"calls: {len(walls)}, wall s min {walls[0]:.3f} median "
             f"{walls[len(walls) // 2]:.3f} max {walls[-1]:.3f}; in order "
             + " ".join(f"{r['wall_s']:.3f}" for r in records),
             f"check census_gap {gap} limit 0 (largest count difference "
             f"of {len(gaps)} compared answers)"]

    calls = len(outputs)
    if trace:
        ctx = dict(cell=cell, calls=calls, records=records, trace=summary,
                   least=least, device=device_line)
        metrics = {}
        for name in cell_metrics(load_benchmark(root), cell,
                                 loop_mod.END_TO_END):
            mod = metric_module(root, name)
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {loop_mod.END_TO_END: {"value": window_s / calls,
                                         "unit": "s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result = dict(correct=gap == 0 and bool(gaps), attempted=calls,
                  failed=failed, metrics=metrics, device=device_line)
    if summary is not None:
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    result["checks"] = checks
    for v in metrics.values():
        if not math.isfinite(v["value"]):
            raise RuntimeError(f"a metric is not finite: {metrics}")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {', '.join(found)}")
    return result, lines
