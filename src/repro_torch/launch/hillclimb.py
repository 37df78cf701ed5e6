"""§Perf hill-climbing: re-run selected cells with optimization
variants and record before/after roofline terms.

The port of ``repro.launch.hillclimb``: the same variants, each a
``meta`` dry run (``repro_torch.launch.dryrun.run_cell``) written under
``build/variants/``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all
"""

import argparse
import json
import time
import traceback
from pathlib import Path

OUT = Path(__file__).resolve().parents[3] / "build" / "variants"

#: (name, arch, shape, multi_pod, overrides) — hypotheses in §Perf log
VARIANTS = {
    "moe": [
        ("shardmap_dispatch", "deepseek-moe-16b", "train_4k", False,
         {"moe_impl": "shard_map", "seq_shard": True, "grad_accum": 4}),
        ("shardmap_noaccum", "deepseek-moe-16b", "train_4k", False,
         {"moe_impl": "shard_map", "seq_shard": True, "grad_accum": 1}),
        ("shardmap_dispatch", "granite-moe-3b-a800m", "train_4k", False,
         {"moe_impl": "shard_map", "seq_shard": True, "grad_accum": 4}),
        ("shardmap_prefill", "granite-moe-3b-a800m", "prefill_32k", False,
         {"moe_impl": "shard_map", "seq_shard": True}),
        ("shardmap_prefill", "deepseek-moe-16b", "prefill_32k", False,
         {"moe_impl": "shard_map", "seq_shard": True}),
    ],
    "decode": [
        ("kv_int8", "qwen2.5-32b", "decode_32k", False,
         {"kv_quant": True}),
        ("kv_int8_long", "recurrentgemma-2b", "long_500k", False,
         {"kv_quant": True}),
    ],
    "dense": [
        # H1: drop SP, classic Megatron TP (1 AR/block) + microbatching
        ("tp_classic_accum4", "qwen2.5-32b", "train_4k", False,
         {"seq_shard": False, "grad_accum": 4}),
        # control: microbatching alone (memory fit, same layout)
        ("accum4", "qwen2.5-32b", "train_4k", False,
         {"grad_accum": 4}),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", default=None,
                    choices=list(VARIANTS) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    groups = args.cell or (list(VARIANTS) if args.all else [])

    from repro_torch.launch.dryrun import run_cell
    OUT.mkdir(parents=True, exist_ok=True)
    for group in groups:
        for name, arch, shape, mp, overrides in VARIANTS[group]:
            tag = (f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                   f"__{name}")
            path = OUT / f"{tag}.json"
            if path.exists() and not args.force:
                print(f"[skip] {tag}")
                continue
            print(f"[run ] {tag}", flush=True)
            t0 = time.time()
            try:
                rec = run_cell(arch, shape, mp, variant=name,
                               overrides=overrides)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "variant": name,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-3000:]}
            rec["wall_seconds"] = round(time.time() - t0, 1)
            path.write_text(json.dumps(rec, indent=2, default=str))
            print(f"       {rec['status']} in {rec['wall_seconds']}s",
                  flush=True)


if __name__ == "__main__":
    main()
