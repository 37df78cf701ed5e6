"""Partitions with a chosen number of windows per shard, shared by the
CPU tests (against the JAX package) and the card's tests (against the
CPU): shards whose last megastep batch holds fewer windows than the
batch's rows."""

import numpy as np

#: windows of each of 4 shards: under a megastep cap of 8 (5 here, the
#: longest queue) every shard but the last ends on a partial batch
SHARD_WINDOWS = (1, 2, 3, 5)


def windows_owner(space, windows=SHARD_WINDOWS):
    """``(owner, max_items)``: an owner array over ``space``'s pairs and
    the run's item budget (over ``len(windows)`` devices) under which
    shard ``s`` holds exactly ``windows[s]`` windows.  Pairs go to the
    shards in order; shard ``s`` takes them until its items reach
    ``windows[s] - 1/2`` windows, the last shard takes the rest."""
    counts = space.counts.astype(np.int64)
    total = int(counts.sum())
    chunk = int(total / (sum(windows) - len(windows) / 2))
    owner = np.full(counts.shape[0], len(windows) - 1, np.int64)
    cum = np.cumsum(counts)
    start = 0
    for s, w in enumerate(windows[:-1]):
        stop = int(np.searchsorted(cum, start + (w - 0.5) * chunk)) + 1
        owner[np.searchsorted(cum, start, side="right"):stop] = s
        start = int(cum[stop - 1])
    return owner, chunk * len(windows)
