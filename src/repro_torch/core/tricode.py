"""Triad isomorphism coding (the paper's ``IsoTricode`` lookup table).

A triad over nodes (u, v, w) is described by three *dyad codes*, one per
unordered node pair.  For an ordered pair (a, b) the code is::

    c_ab = (a->b ? 1 : 0) | (b->a ? 2 : 0)        # 2 bits, paper Fig 7

The *tricode* packs the three dyad codes of (u,v), (u,w), (v,w)::

    tricode = c_uv * 16 + c_uw * 4 + c_vw         # in [0, 64)

``TRICODE_TO_CLASS`` maps each of the 64 tricodes onto one of the 16
isomorphism classes (Holland-Leinhardt M-A-N types).  The table is *derived*
at import time by canonicalising every 6-arc configuration under the 6 node
permutations — not hand-copied — and is validated against networkx and a
brute-force oracle in the tests.
"""

from __future__ import annotations

import itertools

import numpy as np

#: Standard Holland-Leinhardt triad type names, index 0..15.
TRIAD_NAMES = (
    "003", "012", "102", "021D", "021U", "021C", "111D", "111U",
    "030T", "030C", "201", "120D", "120U", "120C", "210", "300",
)

NUM_CLASSES = 16


def _adj_from_tricode(t: int) -> np.ndarray:
    """3x3 directed adjacency matrix for a tricode."""
    c_uv, c_uw, c_vw = (t >> 4) & 3, (t >> 2) & 3, t & 3
    a = np.zeros((3, 3), dtype=bool)
    a[0, 1], a[1, 0] = bool(c_uv & 1), bool(c_uv & 2)
    a[0, 2], a[2, 0] = bool(c_uw & 1), bool(c_uw & 2)
    a[1, 2], a[2, 1] = bool(c_vw & 1), bool(c_vw & 2)
    return a


def _tricode_from_adj(a: np.ndarray) -> int:
    c_uv = int(a[0, 1]) | (int(a[1, 0]) << 1)
    c_uw = int(a[0, 2]) | (int(a[2, 0]) << 1)
    c_vw = int(a[1, 2]) | (int(a[2, 1]) << 1)
    return c_uv * 16 + c_uw * 4 + c_vw


def _classify(a: np.ndarray) -> str:
    """Name the M-A-N class of a 3-node digraph (canonical rules)."""
    codes = [
        int(a[0, 1]) | (int(a[1, 0]) << 1),
        int(a[0, 2]) | (int(a[2, 0]) << 1),
        int(a[1, 2]) | (int(a[2, 1]) << 1),
    ]
    m = sum(c == 3 for c in codes)
    asym = sum(c in (1, 2) for c in codes)
    n = sum(c == 0 for c in codes)
    arcs = [(i, j) for i in range(3) for j in range(3) if i != j and a[i, j]]
    if (m, asym, n) == (0, 0, 3):
        return "003"
    if (m, asym, n) == (0, 1, 2):
        return "012"
    if (m, asym, n) == (1, 0, 2):
        return "102"
    if (m, asym, n) == (0, 2, 1):
        (s0, t0), (s1, t1) = arcs
        if s0 == s1:
            return "021D"          # both arcs diverge from one sender
        if t0 == t1:
            return "021U"          # both arcs converge on one receiver
        return "021C"              # directed path
    if (m, asym, n) == (1, 1, 1):
        # the asymmetric arc either points INTO the mutual dyad or out of it
        mutual_pair = {i for i in range(3) for j in range(3)
                       if i != j and a[i, j] and a[j, i]}
        (s, t) = [e for e in arcs
                  if not (e[0] in mutual_pair and e[1] in mutual_pair)][0]
        # Holland-Leinhardt: 111D has the arc directed toward the dyad,
        # 111U has the arc directed away from it (validated vs networkx).
        return "111D" if t in mutual_pair else "111U"
    if (m, asym, n) == (0, 3, 0):
        outdeg = a.sum(axis=1)
        return "030C" if (outdeg == 1).all() else "030T"
    if (m, asym, n) == (2, 0, 1):
        return "201"
    if (m, asym, n) == (1, 2, 0):
        mutual_pair = {i for i in range(3) for j in range(3)
                       if i != j and a[i, j] and a[j, i]}
        asym_arcs = [e for e in arcs
                     if not (e[0] in mutual_pair and e[1] in mutual_pair)]
        (s0, t0), (s1, t1) = asym_arcs
        if s0 == s1:
            return "120D"
        if t0 == t1:
            return "120U"
        return "120C"
    if (m, asym, n) == (2, 1, 0):
        return "210"
    if (m, asym, n) == (3, 0, 0):
        return "300"
    raise AssertionError(f"unclassifiable triad {codes}")


def _build_table() -> np.ndarray:
    table = np.zeros(64, dtype=np.int32)
    perms = list(itertools.permutations(range(3)))
    for t in range(64):
        a = _adj_from_tricode(t)
        # canonical representative: classification is permutation-invariant
        names = {_classify(a[np.ix_(p, p)]) for p in perms}
        assert len(names) == 1, (t, names)
        table[t] = TRIAD_NAMES.index(names.pop())
    return table


#: 64-entry lookup: tricode -> isomorphism class index (0..15).
TRICODE_TO_CLASS = _build_table()

#: (16, 64) 0/1 fold matrix: hist16 = FOLD @ hist64.
FOLD_64_TO_16 = np.zeros((NUM_CLASSES, 64), dtype=np.int64)
FOLD_64_TO_16[TRICODE_TO_CLASS, np.arange(64)] = 1


def swap_code(c):
    """Dyad code of (b, a) given the code of (a, b): swaps the 2 bits."""
    return ((c & 1) << 1) | ((c & 2) >> 1)
