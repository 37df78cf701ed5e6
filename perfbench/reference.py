"""Plain PyTorch reference: the 16-type triad census and arc deltas.

Independent of the program: it builds its own graph from the seeded edge
list and counts by another method than the program's pair items.

* Triangles (three connected dyads) are enumerated once each, as wedges
  of a degree-ordered orientation closed by a ``searchsorted`` lookup,
  and typed from their three dyad codes.
* Triads with two connected dyads are wedges whose far pair is empty:
  all wedges at a centre follow from the counts of its out-only, in-only
  and mutual neighbours, less the three closed wedges of each triangle.
* Triads with one connected dyad: for a pair (u, v), ``n - deg(u) -
  deg(v) + t(u, v)`` third vertices touch neither, ``t`` counting the
  triangles on the pair.
* 003 is C(n, 3) less the rest.

The 64-code type table is derived here by canonicalising each labelled
triad under the six vertex permutations against one drawing of each of
the 16 Holland-Leinhardt types.  Counts accumulate in ``acc`` (int64; the
lower-precision control passes int32, which wraps as a kernel's int32
counters would).
"""

from __future__ import annotations

import itertools
import math

import torch

TRIAD_NAMES = ("003", "012", "102", "021D", "021U", "021C", "111D", "111U",
               "030T", "030C", "201", "120D", "120U", "120C", "210", "300")

#: one drawing of each type: arcs among vertices A=0, B=1, C=2
_DRAWINGS = (
    (), ((0, 1),), ((0, 1), (1, 0)),
    ((1, 0), (1, 2)),                          # 021D  A<-B->C
    ((0, 1), (2, 1)),                          # 021U  A->B<-C
    ((0, 1), (1, 2)),                          # 021C  A->B->C
    ((0, 1), (1, 0), (2, 1)),                  # 111D  A<->B<-C
    ((0, 1), (1, 0), (1, 2)),                  # 111U  A<->B->C
    ((0, 1), (2, 1), (0, 2)),                  # 030T
    ((1, 0), (2, 1), (0, 2)),                  # 030C
    ((0, 1), (1, 0), (1, 2), (2, 1)),          # 201
    ((1, 0), (1, 2), (0, 2), (2, 0)),          # 120D
    ((0, 1), (2, 1), (0, 2), (2, 0)),          # 120U
    ((0, 1), (1, 2), (0, 2), (2, 0)),          # 120C
    ((0, 1), (1, 2), (2, 1), (0, 2), (2, 0)),  # 210
    tuple((a, b) for a in range(3) for b in range(3) if a != b),  # 300
)


def dyad(arcs: set, a: int, b: int) -> int:
    """Dyad code of (a, b): bit 0 for a->b, bit 1 for b->a."""
    return int((a, b) in arcs) | (int((b, a) in arcs) << 1)


def tricode(arcs: set, u: int, v: int, w: int) -> int:
    """``c_uv * 16 + c_uw * 4 + c_vw``."""
    return dyad(arcs, u, v) * 16 + dyad(arcs, u, w) * 4 + dyad(arcs, v, w)


def _canonical(arcs: set) -> int:
    return min(tricode({(p[a], p[b]) for a, b in arcs}, 0, 1, 2)
               for p in itertools.permutations(range(3)))


def _type_table() -> tuple[int, ...]:
    by_form = {_canonical(set(d)): k for k, d in enumerate(_DRAWINGS)}
    table = []
    for t in range(64):
        c_uv, c_uw, c_vw = t >> 4, (t >> 2) & 3, t & 3
        arcs = {arc for code, (a, b) in ((c_uv, (0, 1)), (c_uw, (0, 2)),
                                          (c_vw, (1, 2)))
                for bit, arc in ((1, (a, b)), (2, (b, a))) if code & bit}
        table.append(by_form[_canonical(arcs)])
    return tuple(table)


#: tricode -> type index
TYPE_OF = _type_table()


def swap(code: torch.Tensor) -> torch.Tensor:
    """Code of (b, a) from the code of (a, b)."""
    return ((code & 1) << 1) | ((code & 2) >> 1)


def arc_keys(src: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Sorted unique arc keys ``src * n + dst``, self-loops dropped."""
    keep = src != dst
    return torch.unique(src[keep] * n + dst[keep])


def apply_delta(keys: torch.Tensor, n: int, add_src, add_dst,
                del_src, del_dst) -> torch.Tensor:
    """Arc set semantics: the deletions first, then the insertions;
    absent deletions and present insertions change nothing, self-loops
    are dropped."""
    def as_keys(s, d):
        s = torch.as_tensor(s, dtype=torch.int64, device=keys.device)
        d = torch.as_tensor(d, dtype=torch.int64, device=keys.device)
        return arc_keys(s, d, n)
    keys = keys[~torch.isin(keys, as_keys(del_src, del_dst))]
    return torch.unique(torch.cat([keys, as_keys(add_src, add_dst)]))


def _wrap(value: int, acc: torch.dtype) -> int:
    bits = torch.iinfo(acc).bits
    return (value + 2**(bits - 1)) % 2**bits - 2**(bits - 1)


def census(keys: torch.Tensor, n: int, acc: torch.dtype = torch.int64,
           block: int = 2**24) -> list[int]:
    """The 16 counts of the digraph on ``n`` vertices whose arcs are the
    sorted unique ``keys`` (no self-loops).  ``block`` bounds the wedges
    held at once."""
    device = keys.device
    table = torch.tensor(TYPE_OF, dtype=torch.int64, device=device)
    out = torch.zeros(16, dtype=acc, device=device)

    # pairs: key lo * n + hi, code relative to lo (sum == OR: one bit an arc)
    src, dst = keys // n, keys % n
    pkey, order = torch.sort(torch.minimum(src, dst) * n
                             + torch.maximum(src, dst))
    bit = torch.where(src < dst, 1, 2)[order]
    pkey, inv = torch.unique_consecutive(pkey, return_inverse=True)
    code = torch.zeros(pkey.shape[0], dtype=torch.int64,
                       device=device).index_add_(0, inv, bit)
    del src, dst, order, bit, inv
    num_pairs = pkey.shape[0]
    lo, hi = pkey // n, pkey % n
    deg = (torch.bincount(lo, minlength=n) + torch.bincount(hi, minlength=n))

    # all wedges (open and closed) by the centre's view of its two arms
    def arms(c: int) -> torch.Tensor:
        return (torch.bincount(lo[code == c], minlength=n)
                + torch.bincount(hi[swap(code) == c], minlength=n)).to(acc)
    o, i, m = arms(1), arms(2), arms(3)
    for count, (c1, c2) in ((o * (o - 1) // 2, (1, 1)),
                            (i * (i - 1) // 2, (2, 2)), (o * i, (1, 2)),
                            (m * o, (3, 1)), (m * i, (3, 2)),
                            (m * (m - 1) // 2, (3, 3))):
        out[TYPE_OF[c1 * 16 + c2 * 4]] += count.sum(dtype=acc)
    del o, i, m

    # orient each pair from the lower (degree, id) end to the higher
    rank = deg * n + torch.arange(n, dtype=torch.int64, device=device)
    lo_first = rank[lo] < rank[hi]
    a = torch.where(lo_first, lo, hi)
    b = torch.where(lo_first, hi, lo)
    ca = torch.where(lo_first, code, swap(code))
    _, order = torch.sort(a * n + b)
    a, b, ca, pid = a[order], b[order], ca[order], order
    del rank, lo_first, order
    row_end = torch.cumsum(torch.bincount(a, minlength=n), 0)
    later = row_end[a] - torch.arange(a.shape[0], device=device) - 1
    starts = torch.cumsum(later, 0) - later
    tri = torch.zeros(num_pairs, dtype=torch.int64, device=device)
    e0, total = 0, a.shape[0]
    while e0 < total:
        # the edges whose wedges fit in one block (at least one edge)
        e1 = int(torch.searchsorted(starts, starts[e0] + block, right=True))
        e1 = min(max(e1, e0 + 1), total)
        cnt = later[e0:e1]
        first = torch.repeat_interleave(
            torch.arange(e0, e1, device=device), cnt)
        if first.numel():
            off = (torch.arange(first.shape[0], device=device)
                   - (starts[first] - starts[e0]))
            second = first + 1 + off
            vb, vc = b[first], b[second]
            q = torch.minimum(vb, vc) * n + torch.maximum(vb, vc)
            pos = torch.searchsorted(pkey, q).clamp_(max=num_pairs - 1)
            hit = pkey[pos] == q
            first, second, pos = first[hit], second[hit], pos[hit]
            c_bc = torch.where(b[first] < b[second], code[pos],
                               swap(code[pos]))
            tc = ca[first] * 16 + ca[second] * 4 + c_bc
            out.add_(torch.bincount(table[tc], minlength=16).to(acc))
            # each triangle closes one wedge at each of its corners
            for closed in (tc & ~3, tc & ~12, tc & ~48):
                out.sub_(torch.bincount(table[closed], minlength=16)
                         .to(acc))
            for p in (pid[first], pid[second], pos):
                tri.index_add_(0, p, torch.ones_like(p))
        e0 = e1
    del a, b, ca, pid, later, starts

    # one connected dyad: third vertices adjacent to neither end
    free = (n - deg[lo] - deg[hi] + tri).to(acc)
    mutual = code == 3
    out[TYPE_OF[1 * 16]] += free[~mutual].sum(dtype=acc)
    out[TYPE_OF[3 * 16]] += free[mutual].sum(dtype=acc)
    counts = [int(v) for v in out.cpu()]
    counts[0] = _wrap(math.comb(n, 3) - sum(counts[1:]), acc)
    return counts
