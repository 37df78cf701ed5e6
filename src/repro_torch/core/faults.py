"""Deterministic fault injection for the partitioned shard streams.

The port's counterpart of the JAX package's ``core/faults.py``, copied
whole (numpy only): the same plans, the same seeded draws, the same
injector.  The host int64 merge is order-invariant and windows are
independent, so any window can be retried or re-routed to any logical
device without changing the census.  This
module supplies the *adversary* for exercising that property: a seeded
:class:`FaultPlan` describing exactly which producer plan-generations,
host->device uploads, and device dispatches fail (and how), plus the
:class:`FaultInjector` runtime the engine threads the plan through.

Fault sites
-----------
``producer``
    the background plan-generation thread of one shard
    (:class:`~repro_torch.core.plan_stream.ShardStreamPipeline`
    producer).
``upload``
    the host-to-device copy of a window's plan buffer onto its logical
    device (fired before the copy is queued).
``dispatch``
    the kernel launch of a window or megabatch on the logical device's
    stream (fired before the launch).

Fault kinds
-----------
``error``
    raise :class:`InjectedFault` (a transient failure; retried).
``delay``
    sleep ``seconds`` before proceeding (exercises the watchdog and
    slow-device paths without breaking anything).
``poison``
    corrupt the fetched result so landing-time validation must catch
    it and re-dispatch.

A fault with ``persistent=True`` at the ``upload``/``dispatch`` sites
models a *dead device*: every subsequent operation on that logical
device fails, forcing the engine to retire it (its stream gets no
further launch) and fail its queue over to the survivors.  Persistence is keyed by device, so re-routed work succeeds
elsewhere.

All plans are deterministic: :meth:`FaultPlan.seeded` draws from
``numpy.random.default_rng(seed)`` and two runs with the same seed and
topology inject identically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


class FaultError(RuntimeError):
    """Base class for failures raised by the fault-tolerance layer."""


class InjectedFault(FaultError):
    """A deliberately injected failure (transient unless the underlying
    :class:`Fault` is ``persistent``)."""

    def __init__(self, fault: "Fault", site: str, key: tuple):
        self.fault = fault
        self.site = site
        self.key = key
        super().__init__(
            f"injected {fault.kind} fault at {site} (shard={fault.shard}, "
            f"device={fault.device}, occurrence={fault.occurrence}, "
            f"persistent={fault.persistent})"
        )


SITES = ("producer", "upload", "dispatch")
KINDS = ("error", "delay", "poison")


@dataclass(frozen=True)
class Fault:
    """One planned failure.

    ``site``/``kind`` select where and how it fires; ``shard`` and/or
    ``device`` select which stream it hits (``None`` matches any);
    ``occurrence`` is the zero-based index among the matching events at
    that site (the 3rd dispatch on device 2, say).  ``persistent``
    turns an ``upload``/``dispatch`` error into a device retirement:
    the matched device fails this and every later operation.
    """

    site: str
    kind: str = "error"
    shard: int | None = None
    device: int | None = None
    occurrence: int = 0
    seconds: float = 0.05
    persistent: bool = False

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.persistent and self.site == "producer":
            raise ValueError("persistent faults model dead devices; "
                             "use site='upload' or 'dispatch'")


@dataclass
class FaultPlan:
    """An ordered collection of :class:`Fault` specs, shared by every
    component of one engine run via a single :class:`FaultInjector`."""

    faults: list = field(default_factory=list)
    seed: int | None = None

    @classmethod
    def seeded(cls, seed: int, num_shards: int, *, producer_errors: int = 1,
               dispatch_errors: int = 1, retire_devices: int = 0,
               delays: int = 0, poisons: int = 0,
               delay_seconds: float = 0.05) -> "FaultPlan":
        """Draw a deterministic plan: which shards/devices fail and on
        which occurrence is decided by ``default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(producer_errors):
            faults.append(Fault("producer", "error",
                                shard=int(rng.integers(num_shards)),
                                occurrence=int(rng.integers(2))))
        for _ in range(dispatch_errors):
            faults.append(Fault("dispatch", "error",
                                device=int(rng.integers(num_shards)),
                                occurrence=int(rng.integers(2))))
        for _ in range(poisons):
            faults.append(Fault("dispatch", "poison",
                                device=int(rng.integers(num_shards)),
                                occurrence=int(rng.integers(2))))
        for _ in range(delays):
            faults.append(Fault("dispatch", "delay",
                                device=int(rng.integers(num_shards)),
                                occurrence=int(rng.integers(2)),
                                seconds=delay_seconds))
        # retire distinct devices, and never device 0 when there are
        # survivors to take the work (keeps the plan always completable)
        if retire_devices:
            lo = 1 if num_shards > 1 else 0
            pool = rng.permutation(np.arange(lo, num_shards))
            for d in pool[:retire_devices]:
                faults.append(Fault("dispatch", "error", device=int(d),
                                    occurrence=int(rng.integers(2)),
                                    persistent=True))
        return cls(faults=faults, seed=seed)

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """Runtime for one engine run: counts matching events per
    ``(site, shard, device)`` stream and fires the planned faults.

    Thread-safe by construction for the engine's actual topology
    (producers hit only their own ``(site, shard)`` counter; the
    consumer thread owns all upload/dispatch counters), so no lock is
    needed on the hot path.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counts: dict = {}
        self._dead: set = set()
        self.fired: list = []

    def device_is_dead(self, device: int) -> bool:
        return device in self._dead

    def _matches(self, f: Fault, site: str, shard, device) -> bool:
        if f.site != site:
            return False
        if f.shard is not None and f.shard != shard:
            return False
        if f.device is not None and f.device != device:
            return False
        return True

    def fire(self, site: str, *, shard: int | None = None,
             device: int | None = None) -> None:
        """Record one event at ``site`` for the given stream and raise /
        sleep if a planned fault matches.  Call *before* the real work
        (producer plan-gen, upload, dispatch)."""
        if device is not None and device in self._dead:
            raise InjectedFault(
                Fault(site, "error", device=device, persistent=True),
                site, (site, shard, device))
        key = (site, shard, device)
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        # every fault matching THIS event fires (two faults planned on
        # the same stream + occurrence must both take effect — e.g. a
        # transient error colliding with a device retirement); among
        # matched errors the persistent one wins the raise, so the
        # retirement is never shadowed by a transient
        err = None
        for f in self.plan.faults:
            if not self._matches(f, site, shard, device):
                continue
            if f.occurrence != n:
                continue
            self.fired.append((f, key))
            if f.kind == "delay":
                time.sleep(f.seconds)
            elif f.kind == "poison":
                # the caller checks take_poison() after fetching
                self._poison = key
            else:
                if f.persistent and device is not None:
                    self._dead.add(device)
                if err is None or (f.persistent and not err.persistent):
                    err = f
        if err is not None:
            raise InjectedFault(err, site, key)

    _poison: tuple | None = None

    def take_poison(self) -> bool:
        """True exactly once after a matching ``poison`` fault fired at
        the most recent :meth:`fire`; the caller corrupts the fetched
        result so landing-time validation must reject it."""
        if self._poison is not None:
            self._poison = None
            return True
        return False


def poison_result(hist: np.ndarray, inter: np.ndarray):
    """Corrupt a fetched (hist, inter) partial the way a flaky device
    would: negate the histogram lanes.  Landing-time validation rejects
    negative counts, forcing a re-dispatch."""
    return -hist - 1, inter


__all__ = [
    "Fault",
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "InjectedFault",
    "poison_result",
]
