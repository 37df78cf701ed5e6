"""Frozen work counts and device peaks for the census's roofline share.

The least time of one census is the larger of the bytes it must move
over the memory bandwidth and the int32 operations it must issue over
the int32 peak.  Both counts are taken from the graph alone, never from
the program's windows, descriptors or anchors, so the same census reads
the same work whatever implements it:

* bytes: the compressed adjacency read once, one 4-byte entry per arc
  end of each adjacent pair (``2 * pairs``) and one 4-byte row offset
  per vertex (``n + 1``);
* operations: every exact census intersects the two rows of each
  adjacent pair (the triangles on the pair fix its one-dyad count), which
  takes at least one comparison per entry of the shorter row:
  ``sum over pairs of min(deg(u), deg(v))``.
"""

from __future__ import annotations

import torch

#: NVIDIA H100 SXM5 data sheet: HBM3 bandwidth, bytes/s (700 W part)
HBM_BYTES_PER_S = 3.35e12
#: NVIDIA H100 Tensor Core GPU Architecture whitepaper: 64 INT32 units per
#: SM x 132 SMs (SXM5) x 1,980 MHz maximum boost clock, int32 op/s
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def census_work(keys: torch.Tensor, n: int) -> dict:
    """Bytes and int32 operations one census of the digraph with the
    sorted unique arc keys ``src * n + dst`` needs at least."""
    src, dst = keys // n, keys % n
    pkey = torch.unique(torch.minimum(src, dst) * n + torch.maximum(src, dst))
    lo, hi = pkey // n, pkey % n
    deg = torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n)
    pairs = int(pkey.shape[0])
    return dict(bytes=4 * (2 * pairs) + 4 * (n + 1),
                ops=int(torch.minimum(deg[lo], deg[hi]).sum()),
                pairs=pairs)


def least_seconds(work: dict) -> float:
    """The larger of the byte and the operation bound, in seconds."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["ops"] / INT32_OPS_PER_S)
