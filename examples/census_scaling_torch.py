"""End-to-end run on the PyTorch/CUDA port: the paper's scaling
experiment on re-synthesized workloads (patents / orkut / webgraph
analogues), distributed over logical devices with the paper's privatized
histogram reduction — followed by the out-of-core streaming demo: a
workload whose monolithic flat plan exceeds the (stand-in) host
plan-memory budget by >8x, completed by the chunked CensusEngine under
that budget.

    PYTHONPATH=src python examples/census_scaling_torch.py     # the card
    PYTHONPATH=src python examples/census_scaling_torch.py --devices 8
    PYTHONPATH=src python examples/census_scaling_torch.py --device cpu \
        --scale 0.1

``--devices k`` logical devices (default 4) share the cards present —
on a machine with one card, k streams on it; ``--device cpu`` runs the
plain torch versions on the host.  ``--scale`` shrinks every workload's
vertex count (and the plan budget with it) for a quick run.
"""

import argparse
import time

from repro_torch import (
    PAPER_WORKLOADS, CensusEngine, build_plan, census_batagelj_mrvar,
    census_dict, default_devices, pair_space, paper_workload,
    triad_census_distributed)
from repro_torch.analysis.report import streaming_section

SIZES = {"patents": (30_000, 3.0), "orkut": (5_000, 40.0),
         "webgraph": (15_000, 15.0)}

#: stand-in for the host plan-memory ceiling: on a real billion-edge run
#: this is the RAM that the monolithic O(W) item arrays would blow past;
#: here it is sized so the demo workload's full plan exceeds it >= 8x
PLAN_BUDGET_BYTES = 12 << 20

#: workload for the streaming demo — its monolithic packed-item plan is
#: ~130 MB, > 8x PLAN_BUDGET_BYTES: it "does not fit" under the budget
#: and only completes in streaming mode
STREAM_SIZE = ("webgraph", 6_000, 10.0)


def scaled(n: int, scale: float) -> int:
    return max(int(n * scale), 60)


def streaming_demo(devices, scale: float):
    name, n, deg = STREAM_SIZE
    n = scaled(n, scale)
    g = paper_workload(name, n=n, avg_degree=deg, seed=0)
    w_pre = pair_space(g).num_items_preprune
    mono_bytes = 8 * w_pre
    budget = max(int(PLAN_BUDGET_BYTES * scale), 8 * 64)
    max_items = budget // 8                # 8 packed bytes per item
    print(f"== streaming  ({name} n={n} avg_deg={deg})")
    print(f"   monolithic plan: ~{mono_bytes / 1e6:.0f} MB of packed "
          f"items — {mono_bytes / budget:.1f}x over the "
          f"{budget / 1e6:.0f} MB plan budget; streaming instead")
    engine = CensusEngine(devices=devices, backend="fused")
    t0 = time.perf_counter()
    census = engine.run(g, max_items=max_items,
                        progress=lambda k, total, items: print(
                            f"   chunk {k + 1}/{total}: {items} items",
                            end="\r"))
    dt = time.perf_counter() - t0
    st = engine.stats
    print(f"\n   streamed census: {dt:.3f}s, {st.chunks} chunks, "
          f"peak plan bytes {st.peak_plan_bytes / 1e6:.1f} MB "
          f"(vs {st.monolithic_plan_bytes / 1e6:.0f} MB monolithic)")
    # parity on a reduced same-family graph (the oracle is slow python)
    g_small = paper_workload(name, n=scaled(1200, scale), avg_degree=8.0,
                             seed=0)
    eng2 = CensusEngine(devices=devices, backend="fused")
    assert (eng2.run(g_small, max_items=max(max_items // 64, 1)) ==
            census_batagelj_mrvar(g_small)).all()
    print("   reduced-graph streamed census == serial B&M oracle ✓")
    d = census_dict(census)
    print("   top connected triads: "
          + ", ".join(f"{k}={v}" for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[1:5]))
    print()
    print(streaming_section(st))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4, metavar="K",
                    help="logical devices to distribute over (default 4)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain torch versions on the host "
                         "(default: the CUDA cards)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of each workload's vertex count "
                         "(default 1.0)")
    args = ap.parse_args(argv)
    devices = default_devices(args.devices, args.device)
    ndev = len(devices)
    print(f"devices: {ndev} logical on "
          f"{sorted({str(d.device) for d in devices})}\n")

    for name, meta in PAPER_WORKLOADS.items():
        n, deg = SIZES[name]
        g = paper_workload(name, n=scaled(n, args.scale), avg_degree=deg,
                           seed=0)
        plan = build_plan(g, pad_to=ndev)
        st = plan.balance_stats(ndev)
        t0 = time.perf_counter()
        census = triad_census_distributed(plan, devices=devices,
                                          backend="fused")
        dt = time.perf_counter() - t0
        # serial reference (the paper's Fig-5 algorithm) on a reduced
        # same-family graph (the python oracle is O(items) in slow loops)
        g_small = paper_workload(name, n=min(g.n, scaled(1500, args.scale)),
                                 avg_degree=min(deg, 8.0), seed=0)
        t1 = time.perf_counter()
        ref = census_batagelj_mrvar(g_small)
        dt_ref = time.perf_counter() - t1
        assert (triad_census_distributed(
            build_plan(g_small, pad_to=ndev), devices=devices,
            backend="fused") == ref).all()
        d = census_dict(census)
        print(f"== {name}  (outdeg exponent target "
              f"{meta['exponent']})")
        print(f"   n={g.n} arcs={g.num_arcs} work_items={plan.num_items}")
        print(f"   distributed census: {dt:.3f}s "
              f"({plan.num_items / dt:.3g} items/s, incl. the kernel "
              f"build on the first call); serial B&M oracle (reduced "
              f"graph): {dt_ref:.3f}s, equal ✓")
        print(f"   balance (max/mean work): flat plan "
              f"{st['flat_max_over_mean']:.4f} vs naive pair split "
              f"{st['pair_max_over_mean']:.2f}")
        print(f"   top connected triads: "
              + ", ".join(f"{k}={v}" for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[1:5]))
        for shards in (64, 256, 512):
            p = build_plan(g, pad_to=shards)
            s = p.balance_stats(shards)
            print(f"   modeled speedup @{shards} shards: "
                  f"{shards / s['flat_max_over_mean']:.1f}x")
        print()

    streaming_demo(devices, args.scale)


if __name__ == "__main__":
    main()
