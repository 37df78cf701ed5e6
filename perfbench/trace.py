"""Reduction of a ``torch.profiler`` trace of the measured window.

The window is the host range ``perfbench.window``; each call of the
program inside it is a ``perfbench.call`` range.  The program's own host
ranges (``census.plan``, ``census.window``, ...) are summed by name.  On
the device, every kernel, copy and memset counts as activity: busy time
is the union of their spans inside the window, kernel time the sum of
the kernels' spans.  Each idle gap is named after the host range that
covers most of it.
"""

from __future__ import annotations

from torch.autograd import DeviceType

WINDOW = "perfbench.window"
CALL = "perfbench.call"
#: host ranges whose names start so are annotations, not device work
ANNOTATIONS = ("census.", "perfbench.")
TOP = 10


def _union(spans, lo, hi):
    """Merged ``[start, end)`` intervals of ``spans`` clipped to
    ``[lo, hi)``."""
    merged = []
    for s, e in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> dict:
    """Host range totals, device busy and kernel seconds, the top device
    operations and the longest idle gaps of the traced window."""
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    window = [e for e in host if e.name() == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} {WINDOW} ranges")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    ranges = {}
    for e in host:
        if e.name().startswith(ANNOTATIONS) and e.name() != WINDOW:
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.end_ns()))
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and not e.name().startswith(ANNOTATIONS)
              and e.end_ns() > w0 and e.start_ns() < w1]
    kernels = [e for e in device
               if not e.name().startswith(("Memcpy", "Memset"))]
    busy = _union([(e.start_ns(), e.end_ns()) for e in device], w0, w1)
    by_op = {}
    for e in device:
        by_op[e.name()] = by_op.get(e.name(), 0) + e.end_ns() - e.start_ns()
    gaps, reach = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)

    def cover(lo, hi):
        best, name = 0, "between calls"
        for key, spans in ranges.items():
            got = sum(max(0, min(e, hi) - max(s, lo)) for s, e in spans)
            if key != CALL and got > best:
                best, name = got, key
        if name == "between calls" and any(
                min(e, hi) > max(s, lo) for s, e in ranges.get(CALL, [])):
            name = "call: other host work"
        return name

    return dict(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        kernel_s=sum(e.end_ns() - e.start_ns() for e in kernels) / 1e9,
        device_events=len(device),
        host_s={k: sum(e - s for s, e in v) / 1e9
                for k, v in ranges.items()},
        device_ops=[[k, v / 1e9] for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[cover(s, e), (e - s) / 1e9] for s, e in sorted(
            gaps, key=lambda g: g[0] - g[1])[:TOP]],
    )
