"""Hand-written CUDA kernels of the census and their plain torch versions.

Public wrappers live in :mod:`repro_torch.kernels.ops`; the kernels are
built from ``csrc/`` by :mod:`repro_torch.kernels.build` at first CUDA
use.
"""

from repro_torch.kernels.ops import (
    BLOCK_ITEMS, IDX_PAD, PACKED_PAD, desc_anchors, desc_anchors_ref,
    fused_census_desc_partials,
    fused_census_desc_partials_batch, fused_census_desc_partials_batch_ref,
    fused_census_desc_partials_ref, fused_census_partials,
    fused_census_partials_ref, pair_codes, pair_codes_ref,
    reset_launch_counts, tricode_histogram, tricode_histogram_ref)

__all__ = [
    "BLOCK_ITEMS", "IDX_PAD", "PACKED_PAD", "desc_anchors",
    "desc_anchors_ref", "fused_census_desc_partials",
    "fused_census_desc_partials_batch",
    "fused_census_desc_partials_batch_ref", "fused_census_desc_partials_ref",
    "fused_census_partials", "fused_census_partials_ref", "pair_codes",
    "pair_codes_ref",
    "reset_launch_counts", "tricode_histogram", "tricode_histogram_ref",
]
