"""Public wrappers around the CUDA kernels.

Each wrapper takes its plain torch version (:mod:`repro_torch.kernels.ref`)
only when its tensors lie on the CPU.  On CUDA tensors it launches its
kernel or raises — a missing ``nvcc``, a failed build or a refused launch
is an error, never a fallback.  Each wrapper carries an integer
``launches`` attribute that counts its kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import census_fused, ref, tricode_hist
from repro_torch.kernels.census_fused import BLOCK_ITEMS, PACKED_PAD
from repro_torch.kernels.pair_codes import LANES, pair_codes_kernel

#: padding value for a flat-index array handed to the desc kernel:
#: >= any possible valid-lane count (so padding lanes decode invalid) and
#: small enough that ``idx + 1`` can never overflow int32
IDX_PAD = 2**31 - 2

tricode_histogram_ref = ref.tricode_histogram_ref
pair_codes_ref = ref.pair_codes_ref
fused_census_partials_ref = ref.fused_census_partials_ref
fused_census_desc_partials_ref = ref.fused_census_desc_partials_ref
fused_census_desc_partials_batch_ref = ref.fused_census_desc_partials_batch_ref
desc_anchors_ref = ref.desc_anchors_ref

__all__ = [
    "BLOCK_ITEMS", "IDX_PAD", "PACKED_PAD", "desc_anchors",
    "desc_anchors_ref", "fused_census_desc_partials",
    "fused_census_desc_partials_batch",
    "fused_census_desc_partials_batch_ref",
    "fused_census_desc_partials_ref", "fused_census_partials",
    "fused_census_partials_ref", "pair_codes", "pair_codes_ref",
    "reset_launch_counts", "tricode_histogram", "tricode_histogram_ref",
]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every tensor
    lies on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors span several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cpu"


def tricode_histogram(tricode: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """64-bin int32 histogram of ``tricode`` where ``mask`` is set.

    Drop-in histogram for :func:`repro_torch.core.census.census_partials`
    (backend ``"hist"``).  On the card the kernel applies the mask
    itself; only inputs that are not already 1-D int32 codes and a bool
    mask of their shape are converted first (the census path passes
    those, so it makes no pass of its own).
    """
    if _on_cpu(tricode, mask):
        masked = torch.where(mask, tricode, 64).to(torch.int32).contiguous()
        return tricode_histogram_ref(masked)
    if tricode.shape != mask.shape:
        tricode, mask = torch.broadcast_tensors(tricode, mask)
    out = tricode_hist.tricode_histogram_kernel(
        tricode.to(torch.int32).contiguous(),
        mask.to(torch.bool).contiguous())
    tricode_histogram.launches += 1
    return out


def pair_codes(q: torch.Tensor, k: torch.Tensor,
               kc: torch.Tensor) -> torch.Tensor:
    """Matched-key codes for (B, 128) int32 tiles: per query id, the code
    of the equal key id in its row, else 0 (the sum over every equal key
    when a row repeats one).  Any B; returns (B, 128) int32."""
    if _on_cpu(q, k, kc):
        for name, t in (("q", q), ("k", k), ("kc", kc)):
            if t.dtype != torch.int32 or t.shape != q.shape \
                    or t.dim() != 2 or t.shape[1] != LANES:
                raise ValueError(f"{name} must be (B, 128) int32 like q, "
                                 f"got {tuple(t.shape)} {t.dtype}")
        return pair_codes_ref(q, k, kc)
    out = pair_codes_kernel(q, k, kc)
    if q.shape[0]:
        pair_codes.launches += 1
    return out


def fused_census_partials(indptr, packed, pair_u, pair_v, pair_code,
                          item_sp, item_pv, search_iters: int):
    """Fused single-pass census partials: ``(hist64 (64,), inter (2,))``.

    Drop-in replacement for :func:`repro_torch.core.census
    .census_partials` (backend ``"fused"``): gather, binary search,
    classification and histogram in one kernel.  Zero item words are
    padding and contribute nothing.
    """
    if _on_cpu(indptr, packed, pair_u, pair_v, pair_code, item_sp, item_pv):
        return fused_census_partials_ref(indptr, packed, pair_u, pair_v,
                                         pair_code, item_sp, item_pv,
                                         search_iters)
    out = census_fused.census_fused_kernel(indptr, packed, pair_u, pair_v,
                                           pair_code, item_sp, item_pv)
    fused_census_partials.launches += 1
    return out[:64], out[64:66]


def fused_census_desc_partials(indptr, packed, pair_u, pair_v, pair_code,
                               desc_pair, desc_cum, desc_within0,
                               anchors, num_valid, idx,
                               search_iters: int, desc_iters: int,
                               orient: str, prune_self: bool):
    """Fused device-emission census partials: ``(hist64 (64,), inter (3,))``.

    Drop-in replacement for :func:`repro_torch.core.census
    .census_partials_desc` (backend ``"fused"``): descriptor expansion,
    gather, binary search, classification and histogram in one kernel.
    Lanes at or past ``num_valid`` (e.g. ``IDX_PAD``) are padding.  The
    kernel searches to convergence, so ``search_iters``/``desc_iters``
    only matter to the plain version.
    """
    if _on_cpu(indptr, packed, pair_u, pair_v, pair_code, desc_pair,
               desc_cum, desc_within0, anchors, num_valid, idx):
        return fused_census_desc_partials_ref(
            indptr, packed, pair_u, pair_v, pair_code, desc_pair, desc_cum,
            desc_within0, anchors, num_valid, idx, search_iters,
            desc_iters, orient, prune_self)
    out = census_fused.census_fused_desc_kernel(
        indptr, packed, pair_u, pair_v, pair_code, desc_pair, desc_cum,
        desc_within0, anchors, num_valid, idx, orient, prune_self)
    fused_census_desc_partials.launches += 1
    return out[:64], out[64:67]


def fused_census_desc_partials_batch(indptr, packed, pair_u, pair_v,
                                     pair_code, words_batch, idx,
                                     search_iters: int, desc_iters: int,
                                     orient: str, prune_self: bool,
                                     real: int | None = None):
    """K-window megastep partials: ``(hist64s (K, 64), inter3s (K, 3))``.

    Drop-in replacement for :func:`repro_torch.core.census
    .census_partials_desc_batch` (backend ``"fused"``): one launch runs
    the first ``real`` rows (every row when None) of the ``(K, words)``
    descriptor-window batch through the desc kernel's stage and fold;
    rows whose word 0 is 0, and every row past ``real`` (never read),
    come back as zeros.  Counts its own launches, apart from the
    single-window wrapper's.
    """
    if _on_cpu(indptr, packed, pair_u, pair_v, pair_code, words_batch, idx):
        return fused_census_desc_partials_batch_ref(
            indptr, packed, pair_u, pair_v, pair_code, words_batch, idx,
            search_iters, desc_iters, orient, prune_self, real=real)
    out = census_fused.census_fused_desc_batch_kernel(
        indptr, packed, pair_u, pair_v, pair_code, words_batch, idx,
        orient, prune_self, real=real)
    fused_census_desc_partials_batch.launches += 1
    return out[:, :64], out[:, 64:67]


def desc_anchors(desc_cum: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """Write a descriptor window's anchor table into ``out`` and return
    it: ``out[a] = max(upper_bound(desc_cum, 16 a) - 1, 0)`` over the
    window's padded ``desc_cum`` (int32, both 1-D), which equals the
    table :func:`repro_torch.core.planner.descriptor_window` builds on the
    host.  On the card one kernel launch on the current stream, which
    does not synchronise, and none for an empty ``out``; on the CPU the
    plain version.
    """
    if _on_cpu(desc_cum, out):
        return out.copy_(desc_anchors_ref(desc_cum, out.shape[0]))
    if out.shape[0]:
        census_fused.desc_anchors_kernel(desc_cum, out)
        desc_anchors.launches += 1
    return out


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in (tricode_histogram, fused_census_partials,
               fused_census_desc_partials, fused_census_desc_partials_batch,
               pair_codes, desc_anchors):
        fn.launches = 0


reset_launch_counts()
