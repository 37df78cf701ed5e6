"""CUDA kernel: 64-bin tricode histogram (backend ``hist``).

Counterpart of the Pallas kernel in the JAX package's
``kernels/tricode_hist.py``.  Each CUDA block counts an 8,192-item tile
into a block-private shared histogram and adds it to the zeroed output
once (``csrc/tricode_hist.cu``).  Values outside [0, 64) are dropped.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: work items per CUDA block (256 threads, 32 items each)
BLOCK_ITEMS = 8192


def tricode_histogram_kernel(tricode_masked: torch.Tensor) -> torch.Tensor:
    """Launch the histogram kernel on a 1-D int32 CUDA tensor; returns
    the ``int32[64]`` histogram.  Launches on the current stream and does
    not synchronise."""
    device = tricode_masked.device
    if device.type != "cuda":
        raise ValueError(f"tricode_histogram_kernel needs a CUDA tensor, "
                         f"got {device}")
    ptr = build.require_vector("tricode_masked", tricode_masked, device)
    out = torch.zeros(64, dtype=torch.int32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tricode_hist_launch(ptr, tricode_masked.shape[0],
                                      out.data_ptr(), stream)
    build.check(lib, err, "tricode_hist")
    return out
