"""CUDA kernels: the whole census per-item pipeline, fused.

Counterpart of the Pallas kernels in the JAX package's
``kernels/census_fused.py``.  Each launch expands (device emission) or
decodes (host emission) its work items, gathers ``w`` and its direction
code from the packed CSR, binary-searches the other endpoint's row,
classifies the triad and folds a 64-bin histogram plus the counter lanes
— the per-item tricode never reaches device memory.  The kernels live in
``csrc/census_fused.cu``; see its header for what bounds them and how
the design answers it.

The graph arrays are read in place from device memory, so unlike the
Pallas kernels there is no on-chip size limit on the graph.  Inputs are
true-length, unpadded int32 vectors; the kernels handle the ragged tail.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: work items per CUDA block (256 threads, 32 items each)
BLOCK_ITEMS = 8192

#: the packed-CSR sentinel of the JAX package (larger than any entry, so a
#: padded row tail stays sorted and unmatchable); the CUDA searches take
#: explicit row bounds and never read past a row, so nothing is padded
PACKED_PAD = 2**31 - 1

#: output words: hist64, inter-asym, inter-mut, kept
OUT_WORDS = 67

#: ``keep_mode`` codes of ``census_fused_desc_launch`` (lane 2's
#: plan-time pruning predicate)
_KEEP_ALL, _KEEP_NOT_SELF, _KEEP_DEGREE = 1, 2, 3


def _keep_mode(orient: str, prune_self: bool) -> int:
    if orient == "degree":
        return _KEEP_DEGREE
    if orient != "none":
        raise ValueError(f"unknown orient mode {orient!r}")
    return _KEEP_NOT_SELF if prune_self else _KEEP_ALL


def _graph_pointers(what: str, indptr, packed, pair_u, pair_v, pair_code):
    """Validate the graph arrays (CUDA, int32, contiguous, consistent
    pair lengths); return their device and data pointers."""
    if not isinstance(packed, torch.Tensor) or packed.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors")
    device = packed.device
    ptrs = [build.require_vector("indptr", indptr, device),
            build.require_vector("packed", packed, device),
            build.require_vector("pair_u", pair_u, device)]
    num_pairs = pair_u.shape[0]
    ptrs += [build.require_vector("pair_v", pair_v, device, num_pairs),
             build.require_vector("pair_code", pair_code, device,
                                  num_pairs)]
    return device, ptrs


def census_fused_desc_kernel(indptr, packed, pair_u, pair_v, pair_code,
                             desc_pair, desc_cum, desc_within0, anchors,
                             num_valid, idx, orient: str,
                             prune_self: bool) -> torch.Tensor:
    """Launch the device-emission kernel on CUDA tensors.

    Returns the zero-initialised-then-accumulated ``int32[67]`` output:
    ``hist64`` then lanes [inter-asym, inter-mut, kept].  Launches on the
    current stream and does not synchronise.
    """
    device, ptrs = _graph_pointers("census_fused_desc_kernel", indptr,
                                   packed, pair_u, pair_v, pair_code)
    num_descs = desc_pair.shape[0]
    num_anchors = anchors.shape[0]
    if num_descs < 1 or num_anchors < 1:
        raise ValueError("a descriptor window needs >= 1 descriptor and "
                         ">= 1 anchor")
    ptrs += [
        build.require_vector("desc_pair", desc_pair, device),
        build.require_vector("desc_cum", desc_cum, device, num_descs),
        build.require_vector("desc_within0", desc_within0, device,
                             num_descs),
        build.require_vector("anchors", anchors, device),
        build.require_vector("num_valid", num_valid, device, 1),
        build.require_vector("idx", idx, device),
    ]
    keep_mode = _keep_mode(orient, prune_self)
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.census_fused_desc_launch(
            *ptrs, idx.shape[0], num_descs, num_anchors, keep_mode,
            out.data_ptr(), stream)
    build.check(lib, err, "census_fused_desc")
    return out


def census_fused_kernel(indptr, packed, pair_u, pair_v, pair_code,
                        item_sp, item_pv) -> torch.Tensor:
    """Launch the host-emission kernel on CUDA tensors.

    Returns the ``int32[67]`` output: ``hist64`` then lanes [inter-asym,
    inter-mut, 0].  Zero item words are padding.  Launches on the current
    stream and does not synchronise.
    """
    device, ptrs = _graph_pointers("census_fused_kernel", indptr, packed,
                                   pair_u, pair_v, pair_code)
    num_items = item_sp.shape[0]
    ptrs += [
        build.require_vector("item_sp", item_sp, device),
        build.require_vector("item_pv", item_pv, device, num_items),
    ]
    out = torch.zeros(OUT_WORDS, dtype=torch.int32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.census_fused_items_launch(*ptrs, num_items,
                                            out.data_ptr(), stream)
    build.check(lib, err, "census_fused_items")
    return out
