"""The benchmark's own inputs: seeded scale-free digraphs and citation deltas.

A copy of the port's generator (``repro_torch.core.generators``: a bounded
Zipf out-degree sequence, static Zipf-preferential targets over a random
permutation of the vertices or uniform ones, reciprocal arcs at rate
``mutual_p``) that
draws the same distribution by inverse CDF: ``searchsorted`` of uniform
draws into the cumulative weights, in a few large calls on the device.
The port's ``rng.choice(n, size=m, p=w)`` draws the same targets one
weighted choice at a time on the host.

Two options the port's generator lacks, for graphs published with their
arc count and largest in-degree: ``top_indegree`` bounds the Zipf
targets by an offset, weights ``1 / (r0 + 1 + rank)``, with ``r0`` set so
that the top-ranked vertex expects that many arcs; ``arcs`` keeps exactly that
many distinct arcs, drawing at a raised average degree until enough
remain and thinning the rest by a seeded permutation.

The citation deltas copy ``chip_smoke.py``'s ``citation_delta``: k arcs
deleted from the graph's arcs, k added from uniform sources to the heads
of existing arcs (cited patents get cited again).  Delta ``i`` is a pure
function of the seed, ``i`` and the starting graph's arcs, so the program
and the reference are handed the same stream.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any
    whole number; reduced modulo 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    return gen


def powerlaw_outdegrees(n: int, exponent: float, avg_degree: float,
                        gen: torch.Generator,
                        max_degree: int | None = None) -> torch.Tensor:
    """Bounded discrete power law on ``1..max_degree`` (default
    ``max(4, int(sqrt(n) * 4))``), rescaled to the target average and
    rounded half to even, clipped to ``[0, n - 1]`` (int64)."""
    device = gen.device
    if max_degree is None:
        max_degree = max(4, int(np.sqrt(n) * 4))
    ks = torch.arange(1, max_degree + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ks ** (-exponent), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    deg = (torch.searchsorted(cdf, u, right=True) + 1).clamp_(max=max_degree)
    scale = avg_degree / max(float(deg.double().mean()), 1e-9)
    deg = torch.round(deg.double() * scale).clamp_(min=0).long()
    return deg.clamp_(max=n - 1)


def zipf_offset(n: int, arcs: int, top_indegree: float) -> float:
    """The offset ``r0 >= 0`` of the target weights ``1 / (r0 + 1 + r)``
    over ranks ``r = 0 .. n - 1`` at which the top-ranked vertex expects
    ``top_indegree`` of ``arcs`` arcs (0 where it expects no more than
    that unbounded)."""
    def top(r0: float) -> float:
        x = torch.tensor([r0 + 1.0, n + r0 + 1.0], dtype=torch.float64)
        h = torch.special.digamma(x)               # sum of 1 / (r0 + 1 + r)
        return arcs / (r0 + 1.0) / float(h[1] - h[0])

    if top(0.0) <= top_indegree:
        return 0.0
    lo, hi = 0.0, float(n)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if top(mid) > top_indegree else (lo, mid)
    return 0.5 * (lo + hi)


def scale_free_edges(n: int, avg_degree: float, exponent: float,
                     mutual_p: float, gen: torch.Generator,
                     preferential: bool = True, target_offset: float = 0.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw directed edge list ``(src, dst)`` (int64, on the generator's
    device) of the port's ``scale_free_digraph``: duplicates and
    self-loops included, as the generator hands them to ``from_edges``.
    Targets are Zipf-preferential, weights ``1 / (target_offset + 1 +
    rank)`` (the port's at offset 0), or, with ``preferential=False``,
    uniform."""
    device = gen.device
    outdeg = powerlaw_outdegrees(n, exponent, avg_degree, gen)
    m = int(outdeg.sum())
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=device), outdeg)
    if preferential:
        # static preferential weights: Zipf over a random permutation
        perm = torch.randperm(n, generator=gen, device=device)
        rank = torch.argsort(perm)
        cdf = torch.cumsum(1.0 / (1.0 + target_offset + rank.double()), 0)
        cdf /= cdf[-1].clone()
        u = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        dst = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
    else:
        dst = torch.randint(0, n, (m,), generator=gen, device=device)
    # reciprocal arcs
    flip = torch.rand(m, generator=gen, device=device) < mutual_p
    return (torch.cat([src, dst[flip]]), torch.cat([dst, src[flip]]))


def config_edges(cfg: dict, seed: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge list of a configuration file's graph: raw, or with
    ``arcs`` exactly that many distinct arcs (no self-loops), ascending
    by ``src * n + dst``."""
    n, gen = cfg["n"], generator(seed, device)
    arcs = cfg.get("arcs")
    offset = (zipf_offset(n, arcs or round(n * cfg["avg_degree"]),
                          cfg["top_indegree"])
              if "top_indegree" in cfg else 0.0)

    def draw(avg_degree: float):
        return scale_free_edges(n, avg_degree, cfg["exponent"],
                                cfg["mutual_p"], gen, cfg["preferential"],
                                offset)

    if arcs is None:
        return draw(cfg["avg_degree"])
    avg_degree = cfg["avg_degree"]
    while True:
        src, dst = draw(avg_degree)
        keys = torch.unique((src * n + dst)[src != dst])
        del src, dst
        if keys.shape[0] >= arcs:
            break
        # rounding the degrees and duplicate arcs lose some of a draw
        avg_degree *= 1.01 * arcs / keys.shape[0]
    keep = torch.randperm(keys.shape[0], generator=gen,
                          device=device)[:arcs]
    keys = torch.sort(keys[keep]).values
    return keys // n, keys % n


def citation_delta(keys: np.ndarray, order: np.ndarray, n: int, k: int,
                   seed: int, i: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Delta ``i`` of a citation stream over a graph whose arcs are the
    sorted keys ``src * n + dst``: ``(add_src, add_dst, del_src,
    del_dst)``.  It deletes the arcs ``keys[order[j]]`` for ``j`` in
    ``i*k .. (i+1)*k - 1`` modulo the arc count (``order`` is a seeded
    permutation of the arcs, so no arc is deleted twice in the first
    ``len(keys) // k`` deltas) and adds k arcs from uniform sources to
    the heads of arcs drawn uniformly from ``keys``."""
    gone = keys[order[np.arange(i * k, (i + 1) * k) % keys.shape[0]]]
    rng = np.random.default_rng([int(seed) % 2**64, i])
    add_src = rng.integers(0, n, k)
    add_dst = keys[rng.integers(0, keys.shape[0], k)] % n
    return add_src, add_dst, gone // n, gone % n
