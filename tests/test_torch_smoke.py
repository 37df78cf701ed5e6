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
                  "lm xlstm-1.3b serve:", "lm xlstm-1.3b trace:",
                  "lm xlstm-1.3b holds: (a) yes; (b)",
                  "lm recurrentgemma-2b serve:",
                  "lm recurrentgemma-2b trace:",
                  "lm recurrentgemma-2b holds: (a) yes; (b)",
                  "phase LM recurrent serving done",
                  "lm train qwen2-0.5b step 0: loss",
                  "lm train qwen2-0.5b: 2 layers",
                  "lm train qwen2-0.5b trace:",
                  "lm train hold (b) qwen2-0.5b 2 layers",
                  "lm train hold (b) granite-moe-3b-a800m 2 layers",
                  "lm train hold (b) recurrentgemma-2b 3 layers",
                  "lm train hold (b) xlstm-1.3b 2 layers (mlstm, mlstm)",
                  "lm train hold (d) qwen2-0.5b 2 layers",
                  "lm train hold (e) examples/train_lm_torch.py",
                  "phase LM training done",
                  "lm parallel placements qwen2-0.5b Mesh({'data': 16, "
                  "'model': 16}, abstract): params",
                  "lm parallel placements xlstm-1.3b Mesh({'pod': 2, "
                  "'data': 16, 'model': 16}, abstract): params",
                  "lm parallel part (a) placements:",
                  "lm parallel (b) granite-moe-3b-a800m MoE layer f32, 2 x "
                  "16 tokens after layer 0's attention, mesh Mesh({'data': "
                  "1, 'model': 4})",
                  "Mesh({'data': 2, 'model': 2}) (EP all_to_all over model,"
                  " FSDP gather over data 2-way)",
                  "lm parallel (b) granite-moe-3b-a800m full-depth prefill",
                  "lm parallel part (b) sharded MoE:",
                  "lm parallel (c) train step moe_impl=shard_map",
                  "lm parallel part (c) shard_map train step:",
                  "lm parallel (d) pipeline qwen2-0.5b",
                  "outputs equal to the sequential run_stack bit for bit",
                  "lm parallel part (d) pipeline:",
                  "lm parallel (e) quantized_tree_psum 8 bits",
                  "lm parallel (e) quantized_tree_psum 16 bits",
                  "every shard's reduced values equal to the cpu path's bit "
                  "for bit",
                  "lm parallel part (e) quantized all-reduce:",
                  "phase LM parallel done",
                  "lm dry run: 6 records traced in",
                  "lm dry run qwen2-0.5b train_4k 16x16: ",
                  "lm dry run qwen2-0.5b prefill_32k 16x16: ",
                  "lm dry run qwen2-0.5b decode_32k 16x16: ",
                  "lm dry run granite-moe-3b-a800m train_4k 16x16: ",
                  "lm dry run roofline qwen2-0.5b train_4k: compute",
                  "lm dry run roofline table (16x16):",
                  "lm dry run calibration train qwen2-0.5b 4 x 32 "
                  "(grad_accum 2, remat) on one card",
                  "= the training phase's state, exactly",
                  "lm dry run calibration decode qwen2-0.5b batch 2",
                  "lm dry run phase:",
                  "phase LM dry run done",
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
