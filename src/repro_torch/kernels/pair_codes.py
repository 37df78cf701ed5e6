"""CUDA kernel: matched-key codes for (B, 128) tiles.

Counterpart of the Pallas kernel in the JAX package's
``kernels/pair_codes.py``: for each query id, the sum of the codes of
every equal key id in its row (the code of the matching key, or 0, when
keys are unique).  Each CUDA block stages the keys and codes of
``ROWS_PER_BLOCK`` rows in shared memory and each thread compares one
query with its row's 128 keys (``csrc/pair_codes.cu``).  Any number of
rows is taken as it is: there is no padding to a tile.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: lanes per row (keys and queries per tile row)
LANES = 128

#: rows per CUDA block (128 threads each)
ROWS_PER_BLOCK = 4


def require_tiles(name: str, t, device, rows: int | None = None) -> int:
    """Check that ``t`` is a contiguous (rows, 128) int32 tensor on
    ``device``; return its data pointer.

    The checks run on ``t`` itself: a non-contiguous view raises, and no
    temporary copy (whose storage could be freed before the launch) is
    ever made of it."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != LANES or (
            rows is not None and t.shape[0] != rows):
        raise ValueError(f"{name} must have shape (B, {LANES}) with the "
                         f"other tiles' B, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major), got "
                         f"strides {t.stride()}")
    if t.shape[0] >= 2**31:
        raise ValueError(f"{name} has more rows than int32 counts")
    return t.data_ptr()


def pair_codes_kernel(q: torch.Tensor, k: torch.Tensor,
                      kc: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on (B, 128) int32 CUDA tensors; returns the
    (B, 128) int32 codes.  Launches on the current stream and does not
    synchronise; B = 0 launches nothing."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"pair_codes_kernel needs CUDA tensors, got "
                         f"{device}")
    rows = q.shape[0] if q.dim() == 2 else None
    ptrs = [require_tiles("q", q, device),
            require_tiles("k", k, device, rows),
            require_tiles("kc", kc, device, rows)]
    out = torch.empty((rows, LANES), dtype=torch.int32, device=device)
    lib = build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.pair_codes_launch(*ptrs, rows, out.data_ptr(), stream)
    build.check(lib, err, "pair_codes")
    return out
