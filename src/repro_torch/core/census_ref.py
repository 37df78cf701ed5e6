"""Reference triad-census oracles (host-side, exact integer arithmetic).

Two independent implementations used to validate the torch / CUDA paths:

* :func:`census_bruteforce` — O(n^3) enumeration of every node triple.
* :func:`census_batagelj_mrvar` — a direct serial transcription of the
  paper's Fig 5 pseudocode (Batagelj & Mrvar 2001) over the compact
  structure, including the pointer-merge union walk of Fig 8.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.digraph import CompactDigraph, to_dense
from repro_torch.core.tricode import (
    NUM_CLASSES, TRICODE_TO_CLASS, TRIAD_NAMES)


def _pair_code(a: np.ndarray, i: int, j: int) -> int:
    return int(a[i, j]) | (int(a[j, i]) << 1)


def census_bruteforce(g: CompactDigraph | np.ndarray) -> np.ndarray:
    """Exact 16-bin census by enumerating all C(n,3) triples."""
    a = g if isinstance(g, np.ndarray) else to_dense(g)
    n = a.shape[0]
    out = np.zeros(NUM_CLASSES, dtype=np.int64)
    for u in range(n):
        for v in range(u + 1, n):
            c_uv = _pair_code(a, u, v)
            for w in range(v + 1, n):
                t = c_uv * 16 + _pair_code(a, u, w) * 4 + _pair_code(a, v, w)
                out[TRICODE_TO_CLASS[t]] += 1
    return out


def census_batagelj_mrvar(g: CompactDigraph) -> np.ndarray:
    """Serial Batagelj–Mrvar census (paper Fig 5, with the Fig 8 merge)."""
    n = g.n
    census = np.zeros(NUM_CLASSES, dtype=np.int64)
    indptr, packed = g.indptr, g.packed
    nbr, code = packed >> 2, packed & 3

    for u in range(n):
        for iu in range(indptr[u], indptr[u + 1]):
            v, c_uv = int(nbr[iu]), int(code[iu])
            if not u < v:
                continue
            # dyadic triads: n - |S| - 2 third nodes see neither u nor v
            tritype = 2 if c_uv == 3 else 1          # 102 : 012 (0-based)
            # pointer-merge union walk over N(u), N(v)  (paper Fig 8)
            pu, pv = indptr[u], indptr[v]
            eu, ev = indptr[u + 1], indptr[v + 1]
            union_size = 0
            while pu < eu or pv < ev:
                wu = int(nbr[pu]) if pu < eu else n
                wv = int(nbr[pv]) if pv < ev else n
                if wu < wv:
                    w, c_uw, c_vw = wu, int(code[pu]), 0
                    u_adj_w = True
                    pu += 1
                elif wv < wu:
                    w, c_uw, c_vw = wv, 0, int(code[pv])
                    u_adj_w = False
                    pv += 1
                else:
                    w, c_uw, c_vw = wu, int(code[pu]), int(code[pv])
                    u_adj_w = True
                    pu += 1
                    pv += 1
                if w == u or w == v:
                    continue
                union_size += 1
                # canonical-selection predicate (step 2.1.4)
                if v < w or (u < w < v and not u_adj_w):
                    t = c_uv * 16 + c_uw * 4 + c_vw
                    census[TRICODE_TO_CLASS[t]] += 1
            census[tritype] += n - union_size - 2
    total = n * (n - 1) * (n - 2) // 6
    census[0] = total - census[1:].sum()
    return census


def census_dict(census: np.ndarray) -> dict[str, int]:
    return {name: int(census[i]) for i, name in enumerate(TRIAD_NAMES)}
