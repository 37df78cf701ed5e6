"""Named host spans of the census path.

A :func:`span` is one ``torch.profiler`` range and, at the same two
boundaries, ``time.perf_counter()`` seconds added to an optional totals
dict under the span's name.  Every host-seconds field of
:class:`repro_torch.core.engine.EngineStats` is such a total, so a trace
of a run and the run's stats read the same intervals.  With no profiler
active a span costs one range enter and exit and two clock reads.

Every name starts with ``census.``: trace readers take ranges so named
for host annotations, never for device work (the profiler mirrors a
range onto the device's timeline as a user annotation).

Top-level spans of a census: :data:`PLAN`, :data:`PARTITION`,
:data:`GRAPH`, :data:`WINDOW`, :data:`ANCHORS` (one per device-emission
dispatch of one window, at its launch), :data:`UPLOAD` and
:data:`WAIT`.  Of a session update: :data:`MERGE`, :data:`PAIR`,
:data:`EMIT`, :data:`ANCHORS` (under device emission), :data:`INSTALL`,
:data:`UPLOAD` and :data:`WAIT`.  The megastep's rows carry host-built
tables: there :data:`ANCHORS` opens wherever a row's window is built.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from torch.profiler import record_function

#: pair space, bases and window shapes of a run
PLAN = "census.plan"
#: a partitioned run's pair space, LPT and shard extraction
PARTITION = "census.partition"
#: a run's graph arrays and flat item index onto its devices
GRAPH = "census.graph"
#: one window's descriptors or item words (engine runs)
WINDOW = "census.window"
#: the anchor table of one descriptor window: the build's enqueue on
#: the card (or the plain version on the CPU) at the window's launch
ANCHORS = "census.window.anchors"
#: a dispatch's host copy into its pinned buffer and the copy's enqueue
UPLOAD = "census.upload"
#: the host blocked on a device event: a buffer's last copy, partials
WAIT = "census.wait"
#: a session's ``apply_delta`` graph edit
MERGE = "census.session.merge"
#: a session's pair-space build or index edit, affected-pair discovery
PAIR = "census.session.pair"
#: a session's descriptor windows or item words, one per ``next()``
EMIT = "census.session.emit"
#: a session's resident graph buffers: padding and the copies
INSTALL = "census.session.install"

_END = object()


@contextmanager
def span(name: str, totals: dict | None = None):
    """The profiler range ``name``; with ``totals``, its seconds are
    added to ``totals[name]``."""
    with record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if totals is not None:
                totals[name] = (totals.get(name, 0.0)
                                + time.perf_counter() - t0)


def spanned(iterable, name: str, totals: dict | None = None):
    """``iterable``'s items with each ``next()`` inside the span ``name``:
    the host cost of a lazy stream, without the consumer's time between
    items."""
    it = iter(iterable)
    while True:
        with span(name, totals):
            item = next(it, _END)
        if item is _END:
            return
        yield item
