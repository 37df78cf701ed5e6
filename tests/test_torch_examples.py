"""The port's entry points: the five ``examples/*_torch.py`` scripts and
the serving and training launchers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) run end to end on the CPU
(``--device cpu``) at small sizes and print their check lines, and each
refuses to run without a card when ``--device`` is not given.  ``CensusPlan.balance_stats``, which the scaling example reports,
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
           "census_scaling_torch", "serve_lm_torch", "train_lm_torch")
LAUNCHER = "-m repro_torch.launch.serve"
TRAIN_LAUNCHER = "-m repro_torch.launch.train"


def run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    target = (name.split() if name in (LAUNCHER, TRAIN_LAUNCHER)
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


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium",
                                  "xlstm-1.3b", "recurrentgemma-2b"])
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
    """(The name is the one this test had while the launcher refused the
    recurrent architectures.)  It serves xlstm-1.3b on the CPU."""
    out = run_example(LAUNCHER, "--device", "cpu", "--arch", "xlstm-1.3b",
                      "--requests", "2", "--new-tokens", "4")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("generated (4, 20)") == 2
    assert "32 tokens in" in out.stdout and "on cpu" in out.stdout


def test_train_lm_on_cpu():
    out = run_example("train_lm_torch", "--device", "cpu", "--steps", "40",
                      "--batch", "4", "--seq", "32")
    assert out.returncode == 0, out.stderr[-2000:]
    found = re.search(r"loss: first-10 avg ([\d.]+) -> last-10 avg "
                      r"([\d.]+)", out.stdout)
    assert found and float(found.group(2)) < float(found.group(1))
    assert "recoveries: 1 [\"RuntimeError('injected node failure" in \
        out.stdout
    assert "loss decreased ✓" in out.stdout


def test_train_launcher_on_cpu(tmp_path):
    out = run_example(TRAIN_LAUNCHER, "--arch", "qwen2-0.5b", "--reduced",
                      "--device", "cpu", "--steps", "3", "--batch", "2",
                      "--seq", "16", "--ckpt-dir", str(tmp_path),
                      "--ckpt-every", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    steps = re.findall(r"^step (\d+): loss ([\d.]+) grad_norm [\d.]+ lr "
                       r"\S+; [\d.]+ ms, \d+ tokens/s; peak memory not "
                       r"measured \(cpu\)$", out.stdout, re.MULTILINE)
    assert [int(s) for s, _ in steps] == [0, 1, 2]
    assert "mesh {'data': 1, 'model': 1}" in out.stdout
    assert "3 steps in" in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000003"]
    again = run_example(TRAIN_LAUNCHER, "--arch", "qwen2-0.5b", "--reduced",
                        "--device", "cpu", "--steps", "1", "--batch", "2",
                        "--seq", "16", "--ckpt-dir", str(tmp_path),
                        "--resume")
    assert again.returncode == 0, again.stderr[-2000:]
    assert "resumed from step 3" in again.stdout
    assert "step 3: loss" in again.stdout


def test_train_launcher_refuses_the_multi_pod_mesh_on_cpu(tmp_path):
    """``--multi-pod`` asks for the (2, 16, 16) production mesh: the
    launcher prints it and refuses with one device, as ``repro`` cannot
    build it on fewer than 512 either."""
    out = run_example(TRAIN_LAUNCHER, "--arch", "qwen2-0.5b", "--reduced",
                      "--device", "cpu", "--steps", "1", "--batch", "2",
                      "--seq", "16", "--ckpt-dir", str(tmp_path),
                      "--multi-pod")
    assert out.returncode != 0
    assert "mesh {'pod': 2, 'data': 16, 'model': 16} (512 devices)" in \
        out.stdout
    assert "the production mesh needs 512 devices; 1 present" in out.stderr
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name", SCRIPTS + (LAUNCHER, TRAIN_LAUNCHER))
def test_refuses_without_a_card(name):
    out = run_example(name, *(["--arch", "qwen2-0.5b"]
                              if name in (LAUNCHER, TRAIN_LAUNCHER) else []))
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
