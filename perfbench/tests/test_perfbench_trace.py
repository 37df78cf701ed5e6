"""The trace reduction on a hand-made event list: busy union clipped to
the window, kernel time, host ranges and idle gaps by host range."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import trace  # noqa: E402


class Event:
    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
S = 10**9


def test_summary_of_one_window():
    events = [
        Event(trace.WINDOW, CPU, 0, 10 * S),
        Event(trace.CALL, CPU, 0, 10 * S),
        Event("census.plan", CPU, 0, 4 * S),
        Event("census.window", CPU, 4 * S, 9 * S),
        Event("census.window", CUDA, 4 * S, 9 * S),      # an annotation
        Event("kernel_a", CUDA, 5 * S, 6 * S),
        Event("Memcpy HtoD", CUDA, 5 * S + S // 2, 7 * S),
        Event("kernel_a", CUDA, 8 * S, 8 * S + S // 2),
        Event("kernel_b", CUDA, -S, S),                  # half before
    ]
    got = trace.summarize(profile(events))
    assert got["window_s"] == 10.0
    # [0, 1) + [5, 7) + [8, 8.5) inside the window
    assert got["busy_s"] == pytest.approx(3.5)
    assert got["kernel_s"] == pytest.approx(1.0 + 0.5 + 2.0)
    assert got["host_s"] == {trace.CALL: 10.0, "census.plan": 4.0,
                             "census.window": 5.0}
    assert got["device_ops"][0] == ["kernel_b", 2.0]
    # gaps [1, 5), [8.5, 10), [7, 8), each named by the range covering most
    assert got["idle_gaps"] == [["census.plan", 4.0],
                                ["census.window", 1.5],
                                ["census.window", 1.0]]


def test_a_gap_outside_every_program_range():
    events = [Event(trace.WINDOW, CPU, 0, 4 * S),
              Event(trace.CALL, CPU, 0, 3 * S),
              Event("kernel", CUDA, 0, S)]
    got = trace.summarize(profile(events))
    assert got["idle_gaps"] == [["call: other host work", 3.0]]
    events.append(Event("kernel", CUDA, 2 * S, 3 * S))
    assert trace.summarize(profile(events))["idle_gaps"] == [
        ["call: other host work", 1.0], ["between calls", 1.0]]


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(profile([Event("census.plan", CPU, 0, 1)]))
