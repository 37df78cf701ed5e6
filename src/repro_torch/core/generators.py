"""Scale-free directed graph generators for the paper's three workloads.

The paper evaluates on US patents (outdeg power-law exponent 3.126), Orkut
(2.127) and a .uk webgraph (1.516).  We re-synthesize statistically similar
graphs at configurable scale: bounded-Zipf out-degree sequences with either
uniform or preferential target attachment, plus a direction mix so all 16
triad types occur.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.digraph import CompactDigraph, from_edges

#: The paper's workloads: (outdegree power-law exponent, mutual-edge rate).
PAPER_WORKLOADS = {
    "patents": {"exponent": 3.126, "mutual_p": 0.0},   # citations: acyclic-ish
    "orkut": {"exponent": 2.127, "mutual_p": 0.5},     # social: many mutual
    "webgraph": {"exponent": 1.516, "mutual_p": 0.25}, # hyperlinks
}


def powerlaw_outdegrees(n: int, exponent: float, avg_degree: float,
                        rng: np.random.Generator,
                        max_degree: int | None = None) -> np.ndarray:
    """Bounded discrete power-law sample scaled to the target average."""
    if max_degree is None:
        max_degree = max(4, int(np.sqrt(n) * 4))
    ks = np.arange(1, max_degree + 1, dtype=np.float64)
    pmf = ks ** (-exponent)
    pmf /= pmf.sum()
    deg = rng.choice(ks.astype(np.int64), size=n, p=pmf)
    # rescale to the requested average (keeps the tail shape)
    scale = avg_degree / max(deg.mean(), 1e-9)
    deg = np.maximum(0, np.round(deg * scale)).astype(np.int64)
    return np.minimum(deg, n - 1)


def scale_free_digraph(n: int, avg_degree: float, exponent: float,
                       mutual_p: float = 0.2, preferential: bool = True,
                       seed: int = 0) -> CompactDigraph:
    """Directed scale-free graph with a power-law outdegree distribution.

    Targets are sampled preferentially (proportional to 1 + indegree-weight
    approximated by a static Zipf weight) or uniformly. ``mutual_p`` is the
    probability that an edge gets a reciprocal partner, controlling the
    mutual-dyad density (social nets high, citation nets ~0).
    """
    rng = np.random.default_rng(seed)
    outdeg = powerlaw_outdegrees(n, exponent, avg_degree, rng)
    m = int(outdeg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), outdeg)
    if preferential:
        # static preferential weights ~ Zipf over a random permutation
        perm = rng.permutation(n)
        w = 1.0 / (1.0 + np.argsort(perm))
        w /= w.sum()
        dst = rng.choice(n, size=m, p=w)
    else:
        dst = rng.integers(0, n, size=m)
    # reciprocal edges
    flip = rng.random(m) < mutual_p
    rs, rd = dst[flip], src[flip]
    src = np.concatenate([src, rs])
    dst = np.concatenate([dst, rd])
    return from_edges(src, dst, n=n)


def paper_workload(name: str, n: int, avg_degree: float,
                   seed: int = 0) -> CompactDigraph:
    """Scaled-down analogue of one of the paper's three graphs."""
    cfg = PAPER_WORKLOADS[name]
    return scale_free_digraph(n=n, avg_degree=avg_degree,
                              exponent=cfg["exponent"],
                              mutual_p=cfg["mutual_p"], seed=seed)


def erdos_renyi_digraph(n: int, p: float, seed: int = 0) -> CompactDigraph:
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    np.fill_diagonal(a, False)
    src, dst = np.nonzero(a)
    return from_edges(src, dst, n=n)


def measured_exponent(g: CompactDigraph) -> float:
    """Crude MLE of the outdegree power-law exponent (for fig6 checks)."""
    out = np.zeros(g.n, dtype=np.int64)
    code = g.packed & 3
    nbr = g.packed >> 2
    rows = np.repeat(np.arange(g.n), g.degrees)
    np.add.at(out, rows, (code & 1).astype(np.int64))
    d = out[out >= 1].astype(np.float64)
    if d.size < 10:
        return float("nan")
    dmin = 1.0
    return 1.0 + d.size / np.log(d / dmin + 1e-12).sum()
