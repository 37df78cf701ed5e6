"""Fault tolerance: heartbeat watchdog, checkpoint/restart coordinator,
straggler detection.

The port of ``repro.train.fault``, which imports no JAX; the port keeps
its own copy.  One intended difference: the reference's coordinator
retries any exception, the port's re-raises a device error at once
(:func:`is_device_error`: a CUDA error or ``torch.OutOfMemoryError``),
since replaying a step cannot mend the card or its memory, as the
census engine's retries do not retry one either.  Restoring copies the
checkpoint's values into the live state's tensors
(``CheckpointManager.restore``), so a step the failure left half
applied is overwritten whole.

On a real pod the failure signals come from the runtime (ICI timeouts,
host heartbeats); here the coordinator wraps the step function so the
control-plane logic — detect, restore, replay, mitigate — is real and unit
tested, with failures injected by the tests.

Design points mirroring production systems:
* steps are pure state -> state, so replay-from-checkpoint is exact;
* the data pipeline is addressed by step index (deterministic batches), so
  restarts do not skew the data distribution;
* straggler mitigation is a callback: on TPU pods the usual action is to
  re-shard around the slow host or preemptively checkpoint.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch


class StepTimeoutError(RuntimeError):
    pass


def is_device_error(exc: BaseException) -> bool:
    """Whether ``exc`` is an error of the device itself: out of memory,
    or a CUDA runtime / cuBLAS error, which a replay cannot mend."""
    fatal = (torch.cuda.OutOfMemoryError,) + tuple(
        getattr(torch, name) for name in ("AcceleratorError",)
        if hasattr(torch, name))
    if isinstance(exc, fatal):
        return True
    text = str(exc)
    return isinstance(exc, RuntimeError) and (
        "CUDA error" in text or "CUBLAS_STATUS" in text
        or "cuDNN error" in text)


@dataclass
class Watchdog:
    """Heartbeat monitor: flags a hang if no beat within ``timeout_s``."""
    timeout_s: float = 300.0
    _last: float = field(default_factory=time.monotonic)
    _stop: threading.Event = field(default_factory=threading.Event)
    _fired: threading.Event = field(default_factory=threading.Event)

    def beat(self):
        self._last = time.monotonic()

    def start(self):
        def loop():
            while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
                if time.monotonic() - self._last > self.timeout_s:
                    self._fired.set()
                    return
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    @property
    def fired(self) -> bool:
        return self._fired.is_set()


@dataclass
class StragglerDetector:
    """Flags steps slower than ``factor`` × trailing median."""
    window: int = 50
    factor: float = 3.0
    _durations: deque = field(default_factory=lambda: deque(maxlen=50))
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        hist = sorted(self._durations)
        self._durations.append(seconds)
        if len(hist) < 10:
            return False
        median = hist[len(hist) // 2]
        if seconds > self.factor * median:
            self.events.append({"step": step, "seconds": seconds,
                                "median": median})
            return True
        return False


class Coordinator:
    """Run a training loop with checkpoint/restart on failure.

    ``step_fn(state, batch) -> (state, metrics)`` must be pure.
    ``batch_fn(step) -> batch`` must be deterministic in ``step``.
    """

    def __init__(self, step_fn, batch_fn, ckpt_manager, *,
                 ckpt_every: int = 100, max_failures: int = 3,
                 straggler: StragglerDetector | None = None,
                 on_straggler=None, watchdog: Watchdog | None = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.max_failures = max_failures
        self.straggler = straggler or StragglerDetector()
        self.on_straggler = on_straggler
        self.watchdog = watchdog
        self.failures = 0
        self.restarts = []

    def run(self, state, start_step: int, num_steps: int):
        """Returns (final_state, last_step, history)."""
        step = start_step
        history = []
        if self.watchdog:
            self.watchdog.start()
        while step < start_step + num_steps:
            try:
                t0 = time.monotonic()
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                dt = time.monotonic() - t0
                if self.watchdog:
                    self.watchdog.beat()
                    if self.watchdog.fired:
                        raise StepTimeoutError(f"hang at step {step}")
                if self.straggler.observe(step, dt) and self.on_straggler:
                    self.on_straggler(step, dt)
                history.append({"step": step, **{
                    k: float(v) for k, v in (metrics or {}).items()
                    if hasattr(v, "__float__") or isinstance(v, float)}})
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, {"state": state,
                                                "step": step})
            except Exception as e:  # noqa: BLE001 — recovery path
                if is_device_error(e):
                    raise
                self.failures += 1
                self.restarts.append({"step": step, "error": repr(e)})
                if self.failures > self.max_failures:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is not None:
                    restored, _ = self.ckpt.restore(
                        {"state": state, "step": 0})
                    state = restored["state"]
                    step = int(restored["step"])
                # else: replay from start_step with current state
        if self.watchdog:
            self.watchdog.stop()
        self.ckpt.wait()
        return state, step, history
