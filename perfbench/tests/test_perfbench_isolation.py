"""No run loads the JAX stack or the JAX package, and the command refuses
to run without a card.  Each check runs in a fresh interpreter: a test
worker may already hold ``jax`` from another file."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CHILD = r"""
import json, sys, time
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[2]]
import torch
from perfbench import control, harness
from perfbench_tiny import tiny_tree
root = tiny_tree(Path(sys.argv[3]) / "perfbench")
cpu = torch.device("cpu")
bench = json.loads((Path(sys.argv[1]) / "BENCHMARK.json").read_text())
results = {}
for cell in (w["name"] for w in bench["workloads"]):
    for trace in (False, True):
        res, _ = harness.run_cell(cell, 7, 0.1, trace, cpu,
                                  time.perf_counter(), root=root)
        results[f"{cell}/{trace}"] = res["correct"]
    results[cell + "/control"] = control.readings(cell, 8, 0.1, cpu,
                                                  root=root)["program_gap"]
print(json.dumps(dict(results=results,
                      modules=sorted({m.split(".")[0] for m in sys.modules}))))
"""


def test_runs_load_neither_jax_nor_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(ROOT), str(Path(__file__).parent),
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(v is True or v == 0 for v in got["results"].values()), got
    assert "repro_torch" in got["modules"]
    # whole top-level names: repro_torch begins with repro and is allowed
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
         "patents.census", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
