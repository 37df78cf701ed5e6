"""Deterministic, resumable data pipeline.

The port's copy of ``repro.data.pipeline`` (numpy only, so copied whole:
``batch_at`` gives the same arrays bit for bit), plus
:func:`device_batch`, which moves a batch onto the device the model is
on.

Batches are a pure function of (seed, step) — the property the fault
coordinator relies on for exact replay after restart. A background
prefetch thread keeps a bounded queue of upcoming batches; the iterator
can be fast-forwarded to any step for resume.

Sources: synthetic Zipf token streams (matching the scale-free flavor of
the paper's workloads) or a binary token file (memmapped).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    source: str = "synthetic"        # synthetic | file
    path: str = ""
    zipf_a: float = 1.3


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._tokens = None
        if cfg.source == "file":
            self._tokens = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    def batch_at(self, step: int) -> dict:
        """Pure function of step -> {tokens, labels}."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        if self._tokens is None:
            toks = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len + 1))
            toks = (toks - 1) % cfg.vocab_size
        else:
            n = self._tokens.shape[0] - cfg.seq_len - 1
            starts = rng.integers(0, n, size=cfg.batch)
            toks = np.stack([
                np.asarray(self._tokens[s:s + cfg.seq_len + 1])
                for s in starts]).astype(np.int64) % cfg.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterate(self, start_step: int = 0, prefetch: int = 2):
        """Prefetching iterator, resumable at any step."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    q.put((step, self.batch_at(step)), timeout=0.25)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def host_shard(batch: dict, process_index: int, process_count: int) -> dict:
    """Per-host slice of the global batch (multi-host data loading)."""
    def sl(a):
        n = a.shape[0]
        chunk = n // process_count
        return a[process_index * chunk:(process_index + 1) * chunk]
    return {k: sl(v) for k, v in batch.items()}


def device_batch(batch: dict, device) -> dict:
    """A numpy batch as torch tensors on ``device`` (``tokens`` and
    ``labels`` stay int32; the embedding indexes with them)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}
