"""The paper's application (Figs 3–4) on the PyTorch/CUDA port: triadic
monitoring of computer network traffic with anomaly alarms.

Synthesizes background peer-to-peer traffic, injects a port-scanning burst
(one source fanning out — 021D triads) in later windows, and shows the
monitor flagging exactly those windows.

The monitor runs every window through one resident engine session on the
card (graph buffers written per window, the CUDA kernels launched per
dispatch); with ``--stride`` below the window size, consecutive windows
overlap and are delta-updated incrementally — only the pairs whose rows
the arc churn touched are recounted, bit-identically to a full recompute.
(On this zipf workload every window churns arcs of the hub hosts, so the
affected pairs cover most of the graph and the per-window summary shows
little item reduction.)

    PYTHONPATH=src python examples/network_monitor_torch.py
    PYTHONPATH=src python examples/network_monitor_torch.py \
        --backend hist --stride 600 --verbose
    PYTHONPATH=src python examples/network_monitor_torch.py --devices 4 \
        --stride 600
    PYTHONPATH=src python examples/network_monitor_torch.py \
        --inject-faults 0
    PYTHONPATH=src python examples/network_monitor_torch.py --device cpu

It runs on the CUDA device unless given ``--device cpu`` (the plain torch
versions of the kernels, on the host).
"""

import argparse

import numpy as np

from repro_torch import (
    BACKENDS, SECURITY_PATTERNS, Fault, FaultPlan, TriadMonitor,
    default_devices)

N_HOSTS = 400
SCAN_SIZE = 200
ATTACK_WINDOWS = frozenset({25, 26, 27})


def background_traffic(rng, n_hosts, n_edges):
    # zipf-ish client/server mix with ~30% reciprocity, exactly n_edges
    # (the reciprocated arcs ride inside the budget so the mutual-dyad
    # mix — which keeps the 021D baseline low — is preserved)
    k = int(n_edges / 1.25)
    src = (rng.zipf(1.5, k) - 1) % n_hosts
    dst = rng.integers(0, n_hosts, k)
    back = rng.random(k) < 0.3
    src2 = np.concatenate([src, dst[back]])
    dst2 = np.concatenate([dst, src[back]])
    short = n_edges - src2.size
    if short > 0:
        src2 = np.concatenate([src2, (rng.zipf(1.5, short) - 1) % n_hosts])
        dst2 = np.concatenate([dst2, rng.integers(0, n_hosts, short)])
    return src2[:n_edges], dst2[:n_edges]


def scan_burst(rng, n_hosts, n_targets):
    scanner = int(rng.integers(0, n_hosts))
    targets = rng.choice(n_hosts, size=n_targets, replace=False)
    return np.full(n_targets, scanner), targets


def traffic(per_window: int, windows: int, seed: int = 0):
    """The scenario's stream: per logical window, background traffic and,
    in ``ATTACK_WINDOWS``, a scan burst.  Returns ``(batches,
    attack_spans)``: one ``(src, dst)`` batch per logical window and the
    stream-edge span of each injected burst's window."""
    rng = np.random.default_rng(seed)
    batches, spans = [], []
    for w in range(windows):
        src, dst = background_traffic(
            rng, N_HOSTS,
            per_window - (SCAN_SIZE if w in ATTACK_WINDOWS else 0))
        if w in ATTACK_WINDOWS:
            s2, d2 = scan_burst(rng, N_HOSTS, SCAN_SIZE)
            src, dst = np.concatenate([src, s2]), np.concatenate([dst, d2])
            spans.append((w * per_window, (w + 1) * per_window))
        batches.append((src, dst))
    return batches, spans


def fault_plan(seed: int, ndev: int) -> FaultPlan:
    """The adversarial plan of ``--inject-faults SEED``: a burst of three
    dispatch errors (one more than the default retry budget: exactly one
    degraded window), a lone transient error and a poisoned result."""
    frng = np.random.default_rng(seed)
    dev = int(frng.integers(ndev))
    # occurrences count DISPATCHES, not windows: each window's census is
    # ~20-50 chunk dispatches on the defaults, and a failure in the very
    # first window has no previous census to carry forward, so aim the
    # burst well past it
    burst = int(frng.integers(60, 200))
    return FaultPlan(seed=seed, faults=[
        *(Fault("dispatch", "error", device=dev, occurrence=burst + i)
          for i in range(3)),
        Fault("dispatch", "error", device=dev,
              occurrence=int(frng.integers(250, 400))),
        Fault("dispatch", "poison", device=dev,
              occurrence=int(frng.integers(450, 600))),
    ])


def run(*, backend="fused", device=None, devices=None, window=1200,
        windows=30, stride=None, threshold=3.5, incremental=True,
        emit=None, index=True, inject_faults=None):
    """Build the monitor for these settings and feed it the scenario;
    returns ``(monitor, attack_spans)``.  ``devices=N`` partitions each
    window's graph over N logical devices (``default_devices(N)`` on
    ``device``)."""
    stride = window if stride is None else stride
    # overlapping windows arrive window/stride times as often, so scale
    # the trailing-history length to cover the same span of traffic
    history = 10 * max(1, window // stride)
    lanes = (None if devices is None
             else default_devices(devices, device))
    faults = (None if inject_faults is None
              else fault_plan(inject_faults, devices or 1))
    monitor = TriadMonitor(
        N_HOSTS, window=window, stride=stride, history=history,
        threshold=threshold, backend=backend,
        device=None if lanes is not None else device, devices=lanes,
        incremental=incremental, max_items=4096, emit=emit, index=index,
        partition=lanes is not None, faults=faults)
    batches, spans = traffic(window, windows)
    for src, dst in batches:
        monitor.observe(src, dst)
    return monitor, spans


def detected(monitor, spans) -> tuple[set, set]:
    """Alarm windows, and the injected bursts an alarm window overlaps."""
    flagged = {a["window"] for a in monitor.alarms()}
    hit = set()
    for t in flagged:
        lo = t * monitor.stride
        for k, (alo, ahi) in enumerate(spans):
            if lo < ahi and alo < lo + monitor.window:
                hit.add(k)
    return flagged, hit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=BACKENDS, default="fused",
                    help="census backend for every window (default fused)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain torch versions on the host "
                         "(default: the CUDA device)")
    ap.add_argument("--stride", type=int, default=None,
                    help="edges between windows (default: the window "
                         "size, i.e. tumbling; smaller values slide "
                         "incrementally)")
    ap.add_argument("--window", type=int, default=1200,
                    help="edges per census window")
    ap.add_argument("--windows", type=int, default=30,
                    help="logical traffic windows to synthesize")
    ap.add_argument("--no-incremental", action="store_true",
                    help="full per-window recompute even when sliding")
    ap.add_argument("--threshold", type=float, default=3.5,
                    help="z-score alarm threshold (sliding windows "
                         "dilute a burst across the overlap, so their "
                         "peak z is lower than tumbling)")
    ap.add_argument("--emit", choices=("device", "host"), default=None,
                    help="work-item emission mode (default: the engine "
                         "default, device — stream O(pairs) descriptors "
                         "and expand pairs→items in the kernel)")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="PARTITION each window's graph over N logical "
                         "devices (each holds only its pair shard's "
                         "local subgraph; delta updates dispatch only "
                         "the owning shards); prints the per-window "
                         "shard report")
    ap.add_argument("--inject-faults", type=int, default=None,
                    metavar="SEED",
                    help="adversarial mode: deterministically inject "
                         "transient dispatch failures, a poisoned "
                         "result, and one burst long enough to exhaust "
                         "the retry budget — the monitor must survive, "
                         "retrying what it can and logging the rest as "
                         "degraded windows instead of dying")
    ap.add_argument("--index", dest="index", action="store_true",
                    default=True,
                    help="maintain a persistent pair-space index so "
                         "each slide edits the plan by the delta "
                         "(default)")
    ap.add_argument("--no-index", dest="index", action="store_false",
                    help="rebuild the pair space from scratch every "
                         "window — the parity oracle for --index")
    ap.add_argument("--profile-host", action="store_true",
                    help="print the per-window host planning time split "
                         "(pair-space / delta-merge / item-emission "
                         "buckets) next to the device dispatch numbers")
    ap.add_argument("--verbose", action="store_true",
                    help="print the per-window engine summary lines")
    args = ap.parse_args(argv)

    monitor, attack_spans = run(
        backend=args.backend, device=args.device, devices=args.devices,
        window=args.window, windows=args.windows, stride=args.stride,
        threshold=args.threshold, incremental=not args.no_incremental,
        emit=args.emit, index=args.index,
        inject_faults=args.inject_faults)
    per_window, stride = monitor.window, monitor.stride
    alarms = monitor.alarms()
    print(f"monitored {len(monitor.window_stats)} windows of "
          f"{per_window} flows (stride {stride}) over {N_HOSTS} hosts "
          f"on backend={args.backend} device="
          f"{monitor.engine.device}; injected scans in logical windows "
          f"{sorted(ATTACK_WINDOWS)}\n")
    print("patterns:", {k: v for k, v in SECURITY_PATTERNS.items()})

    # per-window engine summary: items dispatched vs a full recompute,
    # affected pairs for incremental slides, any alarms on that window
    alarms_at = {}
    for a in alarms:
        alarms_at.setdefault(a["window"], []).append(a)
    total_items = total_full = 0
    print("\nper-window engine summary "
          "(items dispatched / full-recompute items):")
    for t, st in enumerate(monitor.window_stats):
        if st is None:      # degraded window: census carried forward
            print(f"  window {t:>3}  DEGRADED (census carried forward; "
                  f"next window recomputes in full)")
            continue
        total_items += st.items
        total_full += st.full_items
        fired = ",".join(f"{a['pattern']}(z={a['zscore']:.1f})"
                         for a in alarms_at.get(t, []))
        shard = ""
        if st.partitioned:
            # per-window shard report: dispatched items per shard, their
            # imbalance, and the per-device resident graph bytes vs what
            # replication would hold
            shard = (f" shards={st.shard_items}"
                     f" mom={st.shard_max_over_mean:.2f}"
                     f" gbytes={st.graph_resident_bytes}"
                     f"/{st.graph_replicated_bytes}")
        host = ""
        if args.profile_host:
            host = (f" host={st.plan_host_seconds * 1e3:.2f}ms"
                    f"[pair={st.host_pair_seconds * 1e3:.2f}"
                    f" merge={st.host_merge_seconds * 1e3:.2f}"
                    f" emit={st.host_emit_seconds * 1e3:.2f}]"
                    f"{'' if st.indexed else ' (no index)'}")
        line = (f"  window {t:>3}  items={st.items:>7}/{st.full_items:<7}"
                f" chunks={st.chunks:<2} affected_pairs="
                f"{st.affected_pairs:<5}{shard}{host} "
                f"{('ALARM ' + fired) if fired else ''}")
        if args.verbose or fired or args.profile_host:
            print(line)
    print(f"\ntotals: {total_items} items dispatched vs {total_full} for "
          f"full per-window recomputes "
          f"({total_full / max(total_items, 1):.2f}x reduction)")
    if args.profile_host:
        live = [s for s in monitor.window_stats if s is not None]
        pair = sum(s.host_pair_seconds for s in live)
        merge = sum(s.host_merge_seconds for s in live)
        emit = sum(s.host_emit_seconds for s in live)
        mode = "indexed" if args.index else "full per-window rebuild"
        print(f"host planning totals ({mode}): "
              f"{(pair + merge + emit) * 1e3:.1f}ms = "
              f"pair-space {pair * 1e3:.1f}ms + delta-merge "
              f"{merge * 1e3:.1f}ms + emission {emit * 1e3:.1f}ms "
              f"over {len(live)} windows")
    if args.inject_faults is not None:
        sess = monitor._session
        print(f"\nfault injection (seed {args.inject_faults}): "
              f"{sess.retries if sess else 0} retried dispatches, "
              f"{len(monitor.degraded)} degraded window(s) — the stream "
              f"survived")
        for d in monitor.degraded:
            print(f"  degraded window {d['window']}: {d['error']}")
    if args.devices is not None and monitor.window_stats:
        last = next(s for s in reversed(monitor.window_stats)
                    if s is not None)
        moms = [s.shard_max_over_mean for s in monitor.window_stats
                if s is not None and s.partitioned and s.items]
        ratio = (last.graph_replicated_bytes
                 / max(last.graph_resident_bytes, 1))
        print(f"\nshard report ({args.devices} logical devices, "
              f"partitioned graph): per-device resident graph bytes "
              f"{last.graph_resident_bytes} vs replicated "
              f"{last.graph_replicated_bytes} ({ratio:.2f}x);"
              f" dispatch max/mean over windows: "
              f"mean {np.mean(moms) if moms else 1.0:.2f} "
              f"max {np.max(moms) if moms else 1.0:.2f}")

    # map flagged stream windows back onto the injected attack spans
    flagged, hit_spans = detected(monitor, attack_spans)
    print(f"\ndetected {len(hit_spans)}/{len(attack_spans)} attack bursts"
          f"{' ✓' if hit_spans else ''}; alarm windows: {sorted(flagged)}")


if __name__ == "__main__":
    main()
