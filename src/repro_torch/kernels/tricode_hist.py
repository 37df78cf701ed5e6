"""CUDA kernel: 64-bin tricode histogram (backend ``hist``).

Counterpart of the Pallas kernel in the JAX package's
``kernels/tricode_hist.py``, with the mask applied in the kernel: an item
counts where its mask is set and its code lies in [0, 64).  A persistent
grid streams the codes (16-byte loads) and the mask's bytes once, each
lane counting into private shared counters, and each block adds its
counts to the output once (``csrc/tricode_hist.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def tricode_histogram_kernel(tricode: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Launch the histogram kernel on a 1-D int32 CUDA tensor and a bool
    mask of the same length; returns the ``int32[64]`` histogram of the
    codes in [0, 64) where the mask is set.  Queues a memset of the
    output and one kernel on the current stream and does not
    synchronise."""
    device = tricode.device
    if device.type != "cuda":
        raise ValueError(f"tricode_histogram_kernel needs a CUDA tensor, "
                         f"got {device}")
    ptr = build.require_vector("tricode", tricode, device)
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool:
        raise TypeError("mask must be a bool tensor")
    if mask.device != device or mask.shape != tricode.shape \
            or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous {tuple(tricode.shape)} "
                         f"tensor on {device}")
    out = torch.empty(64, dtype=torch.int32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tricode_hist_launch(ptr, mask.data_ptr(),
                                      tricode.shape[0], out.data_ptr(),
                                      stream)
    build.check(lib, err, "tricode_hist")
    return out
