"""Run one benchmark cell and print its result as the last line.

    python3 perfbench/run.py --workload patents.census --seed 7 \\
        --seconds 30 --trace 0

Exits non-zero and prints no result where no CUDA device is present, where
the cell asks for more devices than there are, or where the run loaded
the JAX stack or the JAX package.  Build and kernel caches stay inside
the checkout, under ``build/``.

The run keeps its host steady (:func:`steady_host`): freed memory stays
with the process, and the process keeps to a fixed half of its cores.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(CHECKOUT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = "0"
# the package's own folder is not a place to import from: its module
# names (trace, graphs, ...) would shadow others
sys.path[0:1] = [str(CHECKOUT / "src"), str(CHECKOUT)]


#: glibc ``mallopt`` parameters
M_TRIM_THRESHOLD, M_MMAP_MAX, M_ARENA_MAX = -1, -4, -8


def steady_host() -> int:
    """Make the host's share of a run repeatable; returns the cores kept.

    The program's host path allocates and frees arrays of hundreds of
    megabytes in every call.  glibc serves each from a fresh ``mmap`` and
    returns it on ``free``, so every call faults its pages in again, at a
    cost that follows the machine's load.  Here every allocation comes
    from one heap that is never trimmed: pages are faulted in once, by
    set-up's warm calls, and reused in the window.  The process also
    keeps to the upper half of the cores it may use, so that it does not
    wander between cores."""
    libc = ctypes.CDLL(None)
    for param, value in ((M_MMAP_MAX, 0), (M_TRIM_THRESHOLD, -1),
                         (M_ARENA_MAX, 1)):
        libc.mallopt(param, value)
    cores = sorted(os.sched_getaffinity(0))
    cores = cores[len(cores) // 2:]
    os.sched_setaffinity(0, cores)
    return len(cores)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    threads = steady_host()
    import torch
    from perfbench import harness
    torch.set_num_threads(threads)

    work = harness.load_json(harness.ROOT, "workloads", args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
