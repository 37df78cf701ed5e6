"""Temporal triadic monitoring (the paper's security application, Figs 3-4).

The port's counterpart of the JAX package's ``core/temporal.py``: the
same windowing, delta updates, degradation contract and robust-z alarms,
over the port's :class:`~repro_torch.core.engine.EngineSession`.

Computes the triad census of a dynamic edge stream over sliding windows,
tracks the proportion of each triad type relative to its trailing history,
and flags windows where monitored patterns deviate beyond a z-score
threshold.

Windowing model
---------------
The monitor ingests an ordered stream of directed edges in arbitrary
batches (:meth:`TriadMonitor.observe`).  A census is emitted for every
window of the last ``window`` stream edges, advancing by ``stride`` edges;
``stride == window`` (the default) is tumbling, ``stride < window`` gives
overlapping sliding windows.  Each window's graph is the *set* of its
arcs (duplicates collapse, self-loops drop), exactly as
:func:`repro_torch.core.digraph.from_edges` would build it.

Delta-update contract
---------------------
All censuses run through one resident session on the monitor's backend
and devices, so the graph is uploaded once per window and its buffers
stay on the card.  When consecutive windows overlap (``stride < window``)
and ``incremental=True``, window k+1's census is computed as the delta
update

    C_{k+1} = C_k + contrib(affected, G_{k+1}) − contrib(affected, G_k)

re-counting only the pairs with an endpoint whose row the arc delta
changed (:mod:`repro_torch.core.incremental`).  This is **bit-identical**
to a from-scratch census of window k+1 on every backend and orient mode,
and processes O(affected) work items instead of the window's full O(W).

With ``partition=True`` (and ``devices``) the session shards each
window's graph itself: every logical device holds only its pair shard's
local subgraph, and a sliding-window delta dispatches only the shards
owning affected pairs (:mod:`repro_torch.core.partition`).

Anomaly detection uses robust statistics (median + MAD over the trailing
``history`` windows) so an ongoing attack does not poison its own
baseline; per-window proportions and alarm verdicts are cached
incrementally as windows are observed, so :meth:`TriadMonitor.alarms` is
O(new windows), not a quadratic rescan of the history.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.digraph import from_edges
from repro_torch.core.engine import (
    EMIT_MODES, MAX_WINDOWS_PER_DISPATCH, PIPELINE_DEPTH, CensusEngine,
    EngineStats)
from repro_torch.core.faults import FaultError
from repro_torch.core.tricode import TRIAD_NAMES

#: Paper Fig 3: triad patterns relevant to computer-network monitoring.
SECURITY_PATTERNS = {
    "scanning": ("021D",),            # one source fanning out
    "ddos": ("021U",),                # many sources converging
    "relay": ("021C", "030T"),        # stepping-stone chains
    "p2p_exfil": ("102", "201", "300"),  # unusual mutual cliques
}


def _indices_for(types: tuple) -> np.ndarray:
    """Census indices for a pattern's triad-type tuple, memoized by the
    tuple itself — so the per-window alarm loop never calls
    ``TRIAD_NAMES.index``, while patterns added to (or edited in) the
    public ``SECURITY_PATTERNS`` dict at runtime are still honored."""
    got = _PATTERN_INDEX_CACHE.get(types)
    if got is None:
        got = _PATTERN_INDEX_CACHE[types] = np.array(
            [TRIAD_NAMES.index(t) for t in types], dtype=np.int64)
    return got


_PATTERN_INDEX_CACHE: dict[tuple, np.ndarray] = {}

#: Precomputed census indices for the stock patterns.
SECURITY_PATTERN_INDICES = {
    pattern: _indices_for(types)
    for pattern, types in SECURITY_PATTERNS.items()
}


class TriadMonitor:
    """Sliding-window census tracker with z-score anomaly detection.

    Parameters
    ----------
    n_nodes : fixed vertex-id space of the stream.
    window : edges per census window.
    history : trailing windows forming the robust alarm baseline.
    threshold : z-score alarm threshold (a live attribute — retuning it
        re-filters past windows too).
    stride : keyword-only; edges between consecutive windows (default
        ``window`` — tumbling).  Must satisfy ``1 <= stride <= window``.
    backend / device / devices / orient / max_items : engine routing —
        every window's census runs on this backend (``"fused"`` by
        default, as the port's engine) through one resident session.
        ``device=None`` is the CUDA device and raises without one;
        ``device="cpu"`` runs the plain torch versions on the host.
        ``devices`` (a :func:`~repro_torch.core.distributed.default_devices`
        list, instead of ``device``) spreads each window over several
        logical devices.
    partition : shard each window's GRAPH across ``devices`` instead of
        replicating it — every device holds only its pair shard's local
        subgraph, sliding-window deltas dispatch only the owning shards
        (:class:`~repro_torch.core.engine.PartitionedEngineSession`), and
        the per-window :class:`~repro_torch.core.engine.EngineStats`
        carry the shard balance/residency report.  Requires ``devices``;
        censuses are bit-identical either way.
    schedule / pipeline_depth / max_windows_per_dispatch : forwarded to
        the engine (partitioned execution discipline, async queue depth,
        megastep cap K); bit-identical for any value.
    auto_rebalance_threshold : partitioned only — re-shard the resident
        session with a fresh LPT whenever sliding-window churn pushes
        the shard load max/mean past this value.
    incremental : delta-update overlapping windows instead of recomputing
        them from scratch (bit-identical either way).
    emit : work-item emission mode for every window census and delta
        update (``None`` — the engine default, ``"device"`` — descriptor
        windows expanded in the kernel, ``"host"`` — items materialized
        in numpy; bit-identical either way).
    index : keep a persistent
        :class:`~repro_torch.core.pair_index.PairSpaceIndex` in the
        resident session so each slide edits the pair space by the delta
        instead of rebuilding it (default True; False is the
        rebuild-from-scratch parity oracle).
    faults / max_retries / retry_backoff / watchdog_timeout : forwarded
        to the :class:`~repro_torch.core.engine.CensusEngine`
        fault-tolerance layer.  A window whose census still fails with a
        :class:`~repro_torch.core.faults.FaultError` after the retry
        budget does NOT kill the monitor: the window is recorded as
        *degraded* (:attr:`degraded` — the previous census is carried
        forward so the alarm baseline stays aligned) and the next window
        forces a full recompute, re-syncing the resident session.  Any
        other exception, a CUDA error included, surfaces.
    """

    def __init__(self, n_nodes: int, window: int = 1000,
                 history: int = 20, threshold: float = 3.0, *,
                 stride: int | None = None, backend: str = "fused",
                 device=None, devices=None, orient: str = "none",
                 incremental: bool = True,
                 max_items: int | None = None,
                 emit: str | None = None,
                 partition: bool = False,
                 schedule: str = "async",
                 pipeline_depth: int = PIPELINE_DEPTH,
                 max_windows_per_dispatch: int =
                 MAX_WINDOWS_PER_DISPATCH,
                 auto_rebalance_threshold: float | None = None,
                 index: bool = True,
                 faults=None, max_retries: int = 2,
                 retry_backoff: float = 0.01,
                 watchdog_timeout: float | None = None):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if history < 1:
            raise ValueError(f"history must be >= 1, got {history}")
        stride = window if stride is None else int(stride)
        if not 1 <= stride <= window:
            raise ValueError(
                f"stride must be in [1, window={window}], got {stride}")
        self.n_nodes = int(n_nodes)
        self.window = int(window)
        self.stride = stride
        self.history = int(history)
        self.threshold = float(threshold)
        if emit is not None and emit not in EMIT_MODES:
            raise ValueError(
                f"unknown emit mode {emit!r}; one of {EMIT_MODES}")
        self.incremental = bool(incremental)
        self.orient = orient
        self.max_items = max_items
        self.emit = emit
        if auto_rebalance_threshold is not None and not partition:
            raise ValueError(
                "auto_rebalance_threshold requires partition=True")
        self.auto_rebalance_threshold = auto_rebalance_threshold
        self.index = bool(index)
        self.engine = CensusEngine(
            device=device, devices=devices, backend=backend,
            partition=partition, schedule=schedule,
            pipeline_depth=pipeline_depth,
            max_windows_per_dispatch=max_windows_per_dispatch,
            faults=faults, max_retries=max_retries,
            retry_backoff=retry_backoff,
            watchdog_timeout=watchdog_timeout)
        self._session = None
        self._buf = np.zeros(0, dtype=np.int64)     # pending eid tail
        self._arcset: np.ndarray | None = None      # current window's arcs
        #: multiplicity of each ``_arcset`` arc in the current window —
        #: maintained incrementally so a slide diffs the window by its
        #: O(stride) boundary batches instead of re-sorting all W edges
        self._arcmult: np.ndarray | None = None
        self._censuses: list[np.ndarray] = []
        self._props: list[np.ndarray] = []
        self.window_stats: list[EngineStats] = []
        self._alarm_cache: list[dict] = []
        self._next_alarm_t = self.history
        #: windows whose census failed past the retry budget and were
        #: recorded by carrying the previous census forward
        self.degraded: list[dict] = []
        self._force_full = False
        self.last_t: float | None = None

    # ------------------------------------------------------------ ingest
    def _validate(self, src, dst) -> np.ndarray:
        """Ravel + validate one batch the way ``from_edges`` does, plus
        explicit errors for empty batches, ragged (object-dtype) arrays,
        non-finite float ids, and out-of-range vertices."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        if src.dtype == object or dst.dtype == object:
            raise ValueError(
                "ragged edge batch: src/dst must be rectangular numeric "
                "arrays (got object dtype — rows of unequal length?)")
        for name, a in (("src", src), ("dst", dst)):
            if np.issubdtype(a.dtype, np.floating) \
                    and not np.isfinite(a).all():
                raise ValueError(
                    f"non-finite vertex id (NaN/inf) in {name}")
        src = src.astype(np.int64).ravel()
        dst = dst.astype(np.int64).ravel()
        if src.shape != dst.shape:
            raise ValueError(
                f"src/dst length mismatch: {src.shape[0]} != "
                f"{dst.shape[0]}")
        if src.size == 0:
            raise ValueError(
                "empty edge batch: a census window cannot be empty")
        if (src.min() < 0 or dst.min() < 0
                or max(src.max(), dst.max()) >= self.n_nodes):
            raise ValueError(
                f"vertex id out of range [0, {self.n_nodes})")
        return src * self.n_nodes + dst

    def _validate_times(self, t, count: int) -> None:
        t = np.asarray(t, dtype=np.float64).ravel()
        if t.shape[0] != count:
            raise ValueError(
                f"timestamps/edges length mismatch: {t.shape[0]} != "
                f"{count}")
        if np.isnan(t).any():
            raise ValueError("NaN timestamp in edge batch")
        if (t < 0).any():
            raise ValueError(
                f"negative timestamp in edge batch (min {t.min()})")
        if self.last_t is not None and t.size and t[0] < self.last_t:
            raise ValueError(
                f"timestamps regressed: batch starts at {t[0]} but the "
                f"stream is already at {self.last_t}")
        if t.size:
            self.last_t = float(t[-1])

    def observe(self, src, dst, t=None) -> np.ndarray:
        """Ingest a batch of stream edges; returns the ``(k, 16)`` censuses
        of the windows this batch completed (possibly empty).

        Feeding exactly ``window`` edges per call with the default
        tumbling stride emits exactly one census per call.  ``t``
        (optional per-edge timestamps) is validated — NaN, negative, or
        regressing values are rejected at the edge — but does not affect
        windowing, which is count-based.
        """
        eids = self._validate(src, dst)
        if t is not None:
            self._validate_times(t, eids.shape[0])
        self._buf = np.concatenate([self._buf, eids])
        out = []
        w, s = self.window, self.stride
        while True:
            if self._arcset is None:
                if self._buf.shape[0] < w:
                    break
                out.append(self._guarded(self._emit_full, self._buf[:w]))
            else:
                if self._buf.shape[0] < w + s:
                    break
                out.append(self._guarded(self._emit_slide,
                                         self._buf[s:s + w]))
                self._buf = self._buf[s:]
        return (np.stack(out) if out
                else np.zeros((0, len(TRIAD_NAMES)), dtype=np.int64))

    def _guarded(self, emit, win: np.ndarray) -> np.ndarray:
        """Run one window emission under the monitor's degradation
        contract: a census that fails with a ``FaultError`` past the
        engine's retry budget is recorded as a *degraded* window carrying
        the previous census forward (the alarm baseline stays aligned
        with the stream), and the next window forces a full recompute to
        re-sync the resident session.  Only the very first window — with
        no census to carry — re-raises."""
        try:
            census = emit(win)
        except FaultError as exc:
            if not self._censuses:
                raise
            self.degraded.append(
                {"window": len(self._censuses), "error": str(exc)})
            self._force_full = True
            self.window_stats.append(None)   # keeps lengths aligned
            return self._record(self._censuses[-1].copy())
        self._force_full = False
        return census

    def _emit_full(self, win: np.ndarray) -> np.ndarray:
        """Full census of a window (first window, tumbling slides, or
        incremental disabled)."""
        arcs, mult = np.unique(win, return_counts=True)
        n = self.n_nodes
        g = from_edges(arcs // n, arcs % n, n=n)
        if self._session is None:
            kw = {}
            if self.auto_rebalance_threshold is not None:
                kw["auto_rebalance_threshold"] = \
                    self.auto_rebalance_threshold
            self._session = self.engine.session(
                g, orient=self.orient, max_items=self.max_items,
                emit=self.emit, index=self.index, **kw)
        else:
            self._session.set_graph(g)
        census = self._session.census()
        self._arcset = arcs
        self._arcmult = mult
        self.window_stats.append(self._session.stats)
        return self._record(census)

    def _slide_diff(self) -> tuple:
        """Arc add/remove sets of the next slide plus the slid window's
        (arcset, multiplicity) arrays, computed from the O(stride)
        boundary batches — the ``stride`` edges leaving the window and
        the ``stride`` edges entering it — instead of re-sorting all W
        window edges.  The window's arc multiset is maintained in
        ``_arcset``/``_arcmult``; an arc is removed only when its
        multiplicity drains to zero, added only when it appears from
        zero."""
        w, s = self.window, self.stride
        eids, mult = self._arcset, self._arcmult.copy()
        lv, lc = np.unique(self._buf[:s], return_counts=True)
        ev, ec = np.unique(self._buf[w:w + s], return_counts=True)
        mult[np.searchsorted(eids, lv)] -= lc
        pos = np.searchsorted(eids, ev)
        safe = np.minimum(pos, eids.shape[0] - 1)
        hit = (pos < eids.shape[0]) & (eids[safe] == ev)
        mult[pos[hit]] += ec[hit]
        add, add_mult = ev[~hit], ec[~hit]
        dead = mult == 0
        rem = eids[dead]
        if dead.any() or add.size:
            # splice out the drained arcs, splice in the new ones (same
            # positional arithmetic as PairSpaceIndex.apply)
            del_pos = np.nonzero(dead)[0]
            ins_raw = pos[~hit]
            ipos = ins_raw - np.searchsorted(del_pos, ins_raw)
            keep = ~dead
            j = np.arange(eids.shape[0] - del_pos.shape[0])
            dest_surv = j + np.searchsorted(ipos, j, side="right")
            dest_ins = ipos + np.arange(ipos.shape[0])
            out_e = np.empty(j.shape[0] + ipos.shape[0], dtype=eids.dtype)
            out_m = np.empty_like(out_e)
            out_e[dest_surv] = eids[keep]
            out_e[dest_ins] = add
            out_m[dest_surv] = mult[keep]
            out_m[dest_ins] = add_mult
            eids, mult = out_e, out_m
        return add, rem, eids, mult

    def _emit_slide(self, win: np.ndarray) -> np.ndarray:
        """Census of the next window, delta-updated when it overlaps the
        previous one and ``incremental`` is on (or from scratch after a
        degraded window — the resident session must re-sync)."""
        if self._force_full or not self.incremental \
                or self.stride >= self.window:
            return self._emit_full(win)
        add, rem, arcs, mult = self._slide_diff()
        n = self.n_nodes
        census = self._session.update(add // n, add % n,
                                      rem // n, rem % n)
        self._arcset = arcs
        self._arcmult = mult
        self.window_stats.append(self._session.stats)
        return self._record(census)

    def _record(self, census: np.ndarray) -> np.ndarray:
        """Append a window census + its cached proportion row.  Engine
        stats are appended by the observe-driven emit paths only, so a
        replayed census never duplicates a stale stats entry."""
        census = np.asarray(census, dtype=np.int64)
        self._censuses.append(census)
        denom = max(float(census[1:].sum()), 1.0)
        self._props.append(census / denom)
        return census

    record = _record      # public alias: inject precomputed censuses

    # ------------------------------------------------------------ state
    @property
    def censuses(self) -> np.ndarray:
        """(windows, 16) emitted window censuses."""
        return (np.stack(self._censuses) if self._censuses
                else np.zeros((0, len(TRIAD_NAMES)), dtype=np.int64))

    def proportions(self) -> np.ndarray:
        """(windows, 16) census proportions over non-null triads
        (cached incrementally as windows are observed)."""
        return (np.stack(self._props) if self._props
                else np.zeros((0, len(TRIAD_NAMES))))

    # ------------------------------------------------------------ alarms
    def alarms(self) -> list[dict]:
        """Windows whose monitored patterns *exceed* their trailing
        history (one-sided: a pattern draining away is not a threat).

        Uses robust statistics (median + MAD) so that an ongoing attack
        does not poison its own detection baseline; the robust sd is
        floored at a small fraction of the median plus an absolute 1e-3
        proportion, so neither a freakishly stable baseline (tiny MAD)
        nor a rare triad type absent from the whole history (MAD = 0)
        can turn one noise triad into a huge z-score.  Scores are cached
        threshold-free — each call only evaluates windows observed since
        the last one and filters by the *current* ``threshold``, so
        retuning the attribute re-screens the whole history for free.
        """
        props = self._props
        for t in range(self._next_alarm_t, len(props)):
            base = np.stack(props[t - self.history:t])
            mu = np.median(base, axis=0)
            mad = np.median(np.abs(base - mu), axis=0)
            sd = np.maximum(1.4826 * mad, 0.05 * mu) + 1e-3
            z = (props[t] - mu) / sd
            for pattern, types in SECURITY_PATTERNS.items():
                idx = _indices_for(tuple(types))
                self._alarm_cache.append(
                    {"window": t, "pattern": pattern,
                     "zscore": float(np.max(z[idx]))})
        self._next_alarm_t = max(self._next_alarm_t, len(props))
        return [dict(a) for a in self._alarm_cache
                if a["zscore"] > self.threshold]
