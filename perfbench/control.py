"""Readings that the census comparison's limit is set from.

For each seed, at the cell's own size: the program's timed path for a
short window (``--seconds``) and its largest count difference against the
int64 reference (the lower reading), then the control, the reference put
in the program's place with its counts accumulated in int32, the integer
precision below the configuration's int64 (the upper reading).  One JSON
line per seed:

    python3 perfbench/control.py --workload patents.census \\
        --seconds 5 --seeds 11 12 13

Runs on the card; ``--device cpu`` runs the same at the CPU's pace.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, seconds: float, device,
             root=None) -> dict:
    """The program's and the control's largest count difference from the
    int64 reference over the answers a run of ``cell`` compares."""
    import torch
    from perfbench import harness
    cfg, traffic, loop_mod = harness.load_cell(cell, root or harness.ROOT)
    t0 = time.perf_counter()
    loop = loop_mod.Loop(cfg, traffic, seed, device)
    outputs, _, window_s = harness.measure(loop, seconds)
    loop.release()
    gc.collect()
    want, _ = loop.expected(len(outputs))
    low, _ = loop.expected(len(outputs), acc=torch.int32)
    control = harness.judge([low.get(i) for i in range(len(outputs))], want)
    return dict(workload=cell, seed=seed, calls=len(outputs),
                compared=len(want), window_s=window_s,
                program_gap=max(harness.judge(outputs, want)),
                control_gap=max(control),
                seconds=time.perf_counter() - t0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  device)), flush=True)
    return 0


if __name__ == "__main__":
    # the package's own folder is not a place to import from: its module
    # names (trace, graphs, ...) would shadow others
    sys.path[0:1] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    sys.exit(main())
