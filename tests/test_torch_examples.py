"""The port's entry points: the four ``examples/*_torch.py`` scripts and
the serving launcher ``python -m repro_torch.launch.serve`` run end to
end on the CPU (``--device cpu``) at small sizes and print their check
lines, and each refuses to run without a card when ``--device`` is not
given.  ``CensusPlan.balance_stats``, which the scaling example reports,
equals the JAX package's."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch as rt
from repro.core import build_plan as ref_build_plan
from repro.core import paper_workload as ref_paper_workload

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("quickstart_torch", "network_monitor_torch",
           "census_scaling_torch", "serve_lm_torch")
LAUNCHER = "-m repro_torch.launch.serve"


def run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    target = (LAUNCHER.split() if name == LAUNCHER
              else [str(ROOT / "examples" / f"{name}.py")])
    return subprocess.run(
        [sys.executable, *target, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def bursts_detected(stdout: str) -> int:
    found = re.search(r"detected (\d+)/3 attack bursts", stdout)
    assert found, stdout[-2000:]
    return int(found.group(1))


def test_quickstart_on_cpu():
    out = run_example("quickstart_torch", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sum == C(n,3) == 1331334000 ✓" in out.stdout
    assert "matches O(n^3) brute force on a 60-node graph ✓" in out.stdout


def test_network_monitor_detects_scans_and_survives_faults():
    out = run_example("network_monitor_torch", "--device", "cpu",
                      "--windows", "28", "--inject-faults", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    assert bursts_detected(out.stdout) >= 1
    assert "DEGRADED (census carried forward" in out.stdout
    found = re.search(r"(\d+) retried dispatches, (\d+) degraded window",
                      out.stdout)
    assert found and int(found.group(1)) >= 1 and int(found.group(2)) >= 1


def test_network_monitor_slides_partitioned():
    out = run_example("network_monitor_torch", "--device", "cpu",
                      "--windows", "28", "--stride", "600", "--devices",
                      "2", "--backend", "hist", "--emit", "host",
                      "--no-index", "--profile-host", "--verbose")
    assert out.returncode == 0, out.stderr[-2000:]
    assert bursts_detected(out.stdout) >= 1
    assert "shard report (2 logical devices" in out.stdout
    assert "(no index)" in out.stdout
    assert "host planning totals (full per-window rebuild)" in out.stdout


def test_census_scaling_on_cpu():
    out = run_example("census_scaling_torch", "--device", "cpu",
                      "--devices", "2", "--scale", "0.05")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("equal ✓") == 3
    assert "reduced-graph streamed census == serial B&M oracle ✓" \
        in out.stdout
    assert "### §Streaming schedule" in out.stdout


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium"])
def test_serve_lm_on_cpu(arch):
    out = run_example("serve_lm_torch", "--device", "cpu", "--arch", arch,
                      "--new-tokens", "6")
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"{arch} (reduced," in out.stdout and "on cpu" in out.stdout
    assert "shapes ✓" in out.stdout


def test_serve_launcher_on_cpu():
    out = run_example(LAUNCHER, "--device", "cpu", "--arch",
                      "granite-moe-3b-a800m", "--requests", "2",
                      "--new-tokens", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("generated (4, 20)") == 2
    assert "32 tokens in" in out.stdout and "on cpu" in out.stdout


def test_serve_launcher_refuses_recurrent_archs():
    out = run_example(LAUNCHER, "--device", "cpu", "--arch", "xlstm-1.3b")
    assert out.returncode != 0
    assert "not ported yet" in out.stderr


@pytest.mark.parametrize("name", SCRIPTS + (LAUNCHER,))
def test_refuses_without_a_card(name):
    out = run_example(name, *(["--arch", "qwen2-0.5b"]
                              if name == LAUNCHER else []))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


@pytest.mark.parametrize("workload,n,deg", [("orkut", 150, 6.0),
                                             ("patents", 300, 3.0)])
@pytest.mark.parametrize("shards", [1, 4, 64])
def test_balance_stats_matches_reference(shards, workload, n, deg):
    got = rt.build_plan(rt.paper_workload(workload, n=n, avg_degree=deg,
                                          seed=0), pad_to=shards)
    want = ref_build_plan(ref_paper_workload(workload, n=n, avg_degree=deg,
                                             seed=0),
                          pad_to=shards)
    assert got.balance_stats(shards) == want.balance_stats(shards)
