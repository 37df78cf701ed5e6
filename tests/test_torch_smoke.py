"""``chip_smoke.py`` itself: its phases run end to end at toy size on the
CPU (``--rehearse``), and it refuses to report a result without a card."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_smoke(*args, cwd=ROOT, script=ROOT / "chip_smoke.py"):
    # the script finds the package beside itself, never through the
    # caller's PYTHONPATH
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script), *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_rehearsal_runs_every_phase_and_reports_nothing():
    out = run_smoke("--rehearse")
    assert out.returncode == 3, out.stderr[-2000:]
    for phase in ("kernel fused_census_desc_partials", "kernel "
                  "fused_census_partials", "kernel tricode_histogram",
                  "kernel pair_codes",
                  "kernel fused_census_desc_partials_batch",
                  "1D partition of the main graph", "patents orient=none",
                  "patents orient=degree", "orkut-hub orient=degree",
                  "session orient=none", "session update k=10:",
                  "session update k=100:", "session update k=1000:",
                  "plain torch session on the card equal",
                  "session orient=degree update",
                  "partitioned 1d async orient=none",
                  "partitioned 1d async orient=degree",
                  "partitioned 1d lockstep orient=none",
                  "partitioned 2d (2, 2) async orient=none",
                  "partitioned replicated x2 orient=none",
                  "faults 1d async orient=none",
                  "checkpoint 1d async orient=none",
                  "partitioned session 1d x4: opened",
                  "partitioned session 1d x4 update k=10:",
                  "partitioned session 1d x4 update k=100:",
                  "partitioned session 2d (2, 2) update k=10:",
                  "replicated session x2",
                  "faults and multi-device sessions phase",
                  "monitor-backbone stream:",
                  "monitor-backbone full window 3:",
                  "monitor-backbone plain torch window 1:",
                  "monitor-backbone incremental window 0:",
                  "monitor-backbone incremental window 3:",
                  "monitor-backbone totals: 3 slides",
                  "monitor-backbone orient=degree window 3:",
                  "monitor-backbone partitioned x4 window 1:",
                  "example fused/device:", "example fused/host:",
                  "example hist/default:",
                  "example fused/device no index:",
                  "example under --inject-faults 0: degraded windows",
                  "temporal monitor phase: launches",
                  "phase temporal monitor done",
                  "pair_codes entry point",
                  "oracle phase: 72 runs and 36 sessions",
                  "lm qwen2-0.5b serve:", "lm qwen2-0.5b trace:",
                  "lm qwen2-0.5b holds: (a) yes; (b)",
                  "lm granite-moe-3b-a800m x2:",
                  "lm qwen2-vl-2b x2:", "lm seamless-m4t-medium x2:",
                  "phase LM serving done",
                  "rehearsal complete"):
        assert phase in out.stdout, phase
    assert '"ok"' not in out.stdout


def test_without_a_card_it_fails_before_any_result():
    out = run_smoke()
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_alone_it_fails(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = run_smoke("--rehearse", cwd=tmp_path, script=script)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
