"""Plain torch versions of every CUDA kernel (the correctness contract).

Each wrapper in :mod:`repro_torch.kernels.ops` runs its plain version
when its tensors lie on the CPU; on the card the plain versions are what
the kernels are held against.
"""

from __future__ import annotations

import torch

from repro_torch.core.census import (
    census_partials, census_partials_desc, census_partials_desc_batch)
from repro_torch.core.planner import DESC_ANCHOR_STRIDE


def tricode_histogram_ref(tricode_masked: torch.Tensor) -> torch.Tensor:
    """64-bin int32 histogram; values outside [0, 64) are dropped."""
    valid = (tricode_masked >= 0) & (tricode_masked < 64)
    return torch.zeros(64, dtype=torch.int32,
                       device=tricode_masked.device).index_add_(
        0, torch.where(valid, tricode_masked, 0), valid.to(torch.int32))


def pair_codes_ref(q: torch.Tensor, k: torch.Tensor,
                   kc: torch.Tensor) -> torch.Tensor:
    """Per query, the sum of the codes of every equal key in its row (the
    matched key code, or 0 if the id is absent from a unique-key row),
    wrapped to int32 as the JAX package's int32 sum wraps."""
    eq = q[:, :, None] == k[:, None, :]
    return torch.where(eq, kc[:, None, :], 0).sum(2).to(torch.int32)


def fused_census_partials_ref(indptr, packed, pair_u, pair_v, pair_code,
                              item_sp, item_pv, search_iters: int):
    """``(hist64 (64,), inter (2,))`` int32 from packed host items."""
    return census_partials(indptr, packed, pair_u, pair_v, pair_code,
                           item_sp, item_pv, search_iters)


def fused_census_desc_partials_ref(indptr, packed, pair_u, pair_v,
                                   pair_code, desc_pair, desc_cum,
                                   desc_within0, anchors, num_valid, idx,
                                   search_iters: int, desc_iters: int,
                                   orient: str, prune_self: bool):
    """``(hist64 (64,), inter (3,))`` int32 from a descriptor window."""
    return census_partials_desc(
        indptr, packed, pair_u, pair_v, pair_code, desc_pair, desc_cum,
        desc_within0, anchors, num_valid, idx, search_iters, desc_iters,
        orient, prune_self)


def fused_census_desc_partials_batch_ref(indptr, packed, pair_u, pair_v,
                                         pair_code, words_batch, idx,
                                         search_iters: int, desc_iters: int,
                                         orient: str, prune_self: bool,
                                         real: int | None = None):
    """``(hist64s (K, 64), inter3s (K, 3))`` int32 from the first ``real``
    rows (every row when None) of a ``(K, words)`` batch of descriptor
    windows; zero rows and rows past ``real`` give zeros."""
    return census_partials_desc_batch(
        indptr, packed, pair_u, pair_v, pair_code, words_batch, idx,
        search_iters, desc_iters, orient, prune_self, real=real)


def desc_anchors_ref(desc_cum: torch.Tensor,
                     num_anchors: int) -> torch.Tensor:
    """A descriptor window's ``(num_anchors,)`` int32 anchor table from
    its padded ``desc_cum``: entry ``a`` is the last descriptor starting
    at or before item ``16 a`` (``DESC_ANCHOR_STRIDE``), at least 0 --
    what :func:`repro_torch.core.planner.descriptor_window` builds on the
    host, entry for entry."""
    grid = torch.arange(num_anchors, dtype=torch.int32,
                        device=desc_cum.device) * DESC_ANCHOR_STRIDE
    found = torch.searchsorted(desc_cum, grid, right=True, out_int32=True)
    return (found - 1).clamp_(min=0)
