"""Closed loop of session updates: one caller, the next edge delta sent
when the last update returns the edited graph's census.

Traffic parameters: ``orient`` and ``max_items`` of
``CensusEngine.session``, ``k`` arcs deleted and ``k`` added per update
(:func:`perfbench.graphs.citation_delta`), ``warm`` updates of set-up and
``sampled`` updates of the window compared with the reference.  Set-up
builds the graph with the program's ``from_edges``, opens the session,
takes its baseline census and applies deltas 0 .. ``warm - 1``; the
window applies the deltas after them.  The reference applies the same deltas to its own arc set and counts
the graphs after the last update of the window and after ``sampled - 1``
others drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import graphs, reference

END_TO_END = "update_s"


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch import CensusEngine, from_edges
        self.cfg, self.seed, self.device = cfg, seed, device
        self.n = cfg["n"]
        self.k = traffic["k"]
        self.sampled = traffic["sampled"]
        t = time.perf_counter()
        src, dst = graphs.config_edges(cfg, seed, device)
        keys = reference.arc_keys(src, dst, self.n)
        # the stream's arcs to delete: a seeded permutation of the arcs
        order = torch.randperm(keys.shape[0],
                               generator=graphs.generator(seed, device),
                               device=device)
        self.keys, self.order = keys.cpu().numpy(), order.cpu().numpy()
        src, dst = src.cpu().numpy(), dst.cpu().numpy()
        del keys, order
        self.phases = {"edges": time.perf_counter() - t}
        t = time.perf_counter()
        graph = from_edges(src, dst, n=self.n)
        self.phases["from_edges"] = time.perf_counter() - t
        del src, dst
        eng = cfg["engine"]
        t = time.perf_counter()
        engine = CensusEngine(device=device, backend=eng["backend"],
                              emit=eng["emit"])
        self.session = engine.session(graph, orient=traffic["orient"],
                                      max_items=traffic["max_items"])
        self.phases["session_open"] = time.perf_counter() - t
        t = time.perf_counter()
        self.session.census()
        self.phases["baseline_census"] = time.perf_counter() - t
        t = time.perf_counter()
        self.applied = 0
        for _ in range(traffic["warm"]):
            self.call()
        self.warm = self.applied
        self.phases["warm_update"] = time.perf_counter() - t

    def delta(self, i: int):
        return graphs.citation_delta(self.keys, self.order, self.n, self.k,
                                     self.seed, i)

    def call(self):
        out = self.session.update(*self.delta(self.applied))
        self.applied += 1
        return out

    def record(self) -> dict:
        st = self.session.stats
        return dict(merge_s=st.host_merge_seconds,
                    pair_s=st.host_pair_seconds,
                    emit_s=st.host_emit_seconds)

    def release(self) -> None:
        self.session.close()
        self.session = None

    def expected(self, calls: int, acc=torch.int64) -> tuple[dict, None]:
        """The reference's counts for the last call of the window and
        ``sampled - 1`` others drawn from the seed.  Call ``i`` of the
        window applied delta ``warm + i``."""
        rng = np.random.default_rng([int(self.seed) % 2**64, 2**32])
        rest = rng.permutation(calls - 1)[:self.sampled - 1]
        due = sorted({calls - 1, *rest.tolist()})
        keys = torch.from_numpy(self.keys).to(self.device)
        want = {}
        for i in range(self.warm + due[-1] + 1):
            keys = reference.apply_delta(keys, self.n, *self.delta(i))
            if i - self.warm in due:
                want[i - self.warm] = reference.census(keys, self.n, acc=acc)
        return want, None
