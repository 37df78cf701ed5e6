"""Abstract input construction for every (arch × shape) cell.

The port of ``repro.parallel.inputs``: the stand-ins of a cell's step
inputs are tensors on the ``meta`` device (shape and dtype, no storage),
beside their placements (``repro_torch.parallel.sharding``), as the
reference pairs ``ShapeDtypeStruct``s with ``NamedSharding``s.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.model import init_cache
from repro_torch.parallel.sharding import (
    Placement, batch_axes, cache_shardings)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _seq_split_encdec(cfg: ArchConfig, seq_len: int) -> tuple[int, int]:
    """Enc/dec budget split for encoder-decoder cells: the cell's seq_len
    covers source frames and target tokens 50/50."""
    return seq_len // 2, seq_len // 2


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """(batch of ``meta`` tensors, their placements) of one train step."""
    b, s = shape.global_batch, shape.seq_len
    b_ax = batch_axes(mesh, b)
    batch, shard = {}, {}
    if cfg.is_encdec:
        ss, st = _seq_split_encdec(cfg, s)
        batch["src_embeds"] = _meta((b, ss, cfg.d_model), torch.bfloat16)
        shard["src_embeds"] = Placement(mesh, (b_ax, None, None))
        s = st
    batch["tokens"] = _meta((b, s), torch.int32)
    batch["labels"] = _meta((b, s), torch.int32)
    shard["tokens"] = Placement(mesh, (b_ax, None))
    shard["labels"] = Placement(mesh, (b_ax, None))
    if cfg.modality == "vlm":
        batch["vision_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        batch["vision_mask"] = _meta((b, s), torch.bool)
        batch["positions3"] = _meta((3, b, s), torch.int32)
        shard["vision_embeds"] = Placement(mesh, (b_ax, None, None))
        shard["vision_mask"] = Placement(mesh, (b_ax, None))
        shard["positions3"] = Placement(mesh, (None, b_ax, None))
    return batch, shard


def decode_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                  kv_quant: bool = False):
    """(token, cache, placements) of one decode step, the token and the
    cache's tensors on ``meta`` (the cache is ``init_cache``'s, its
    ``pos`` the Python 0)."""
    b, s = shape.global_batch, shape.seq_len
    b_ax = batch_axes(mesh, b)
    src_len = _seq_split_encdec(cfg, s)[0] if cfg.is_encdec else 0
    cache = init_cache(cfg, batch=b, seq_len=s, src_len=src_len,
                       kv_quant=kv_quant, device="meta")
    token = _meta((b, 1), torch.int32)
    shardings = {
        "token": Placement(mesh, (b_ax, None)),
        "cache": cache_shardings(cache, mesh, b),
    }
    return token, cache, shardings


def make_concrete_batch(cfg: ArchConfig, b: int, s: int, rng=None,
                        device=None) -> dict:
    """Small concrete batch for examples and tests (mirrors
    :func:`train_batch_specs`), drawn from ``rng`` (a
    ``np.random.default_rng(0)`` when not given) in the reference's
    order, on ``device`` (the card unless given another)."""
    from repro_torch.core.engine import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                         dtype=dtype)
    batch = {}
    if cfg.is_encdec:
        ss, st = _seq_split_encdec(cfg, s)
        batch["src_embeds"] = put(rng.normal(size=(b, ss, cfg.d_model)),
                                  torch.bfloat16)
        s = st
    batch["tokens"] = put(rng.integers(0, cfg.vocab_size, (b, s)),
                          torch.int32)
    batch["labels"] = put(rng.integers(0, cfg.vocab_size, (b, s)),
                          torch.int32)
    if cfg.modality == "vlm":
        batch["vision_embeds"] = put(rng.normal(size=(b, s, cfg.d_model)),
                                     torch.bfloat16)
        batch["vision_mask"] = put(rng.random((b, s)) < 0.25, torch.bool)
        batch["positions3"] = put(np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)), torch.int32)
    return batch
