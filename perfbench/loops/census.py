"""Closed loop of whole censuses: one caller, the next census sent when
the last returns its counts.

Traffic parameters: ``orient`` and ``max_items`` of
``CensusEngine.run``, and ``warm``, the censuses of set-up.  Set-up builds
the graph with the program's ``from_edges`` from the seeded edge list and
runs ``warm`` censuses on the same shapes.  Every census of the window is compared with the
reference's census of the same edge list.
"""

from __future__ import annotations

import time

import torch

from perfbench import graphs, reference, roofline

END_TO_END = "census_s"


class Loop:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch import CensusEngine, from_edges
        self.cfg, self.seed, self.device = cfg, seed, device
        self.n = cfg["n"]
        self.orient = traffic["orient"]
        self.max_items = traffic["max_items"]
        t = time.perf_counter()
        src, dst = graphs.config_edges(cfg, seed, device)
        src, dst = src.cpu().numpy(), dst.cpu().numpy()
        self.phases = {"edges": time.perf_counter() - t}
        t = time.perf_counter()
        self.graph = from_edges(src, dst, n=self.n)
        self.phases["from_edges"] = time.perf_counter() - t
        del src, dst
        eng = cfg["engine"]
        t = time.perf_counter()
        self.engine = CensusEngine(device=device, backend=eng["backend"],
                                   emit=eng["emit"])
        for _ in range(traffic["warm"]):
            self.call()
        self.phases["warm_census"] = time.perf_counter() - t

    def call(self):
        return self.engine.run(self.graph, max_items=self.max_items,
                               orient=self.orient)

    def record(self) -> dict:
        st = self.engine.stats
        return dict(upload_bytes=st.plan_upload_bytes * st.chunks * st.ndev)

    def release(self) -> None:
        self.engine = self.graph = None

    def expected(self, calls: int, acc=torch.int64) -> tuple[dict, dict]:
        """The reference's counts for every call of the window, and the
        graph's least census work for the roofline."""
        src, dst = graphs.config_edges(self.cfg, self.seed, self.device)
        keys = reference.arc_keys(src, dst, self.n)
        del src, dst
        want = reference.census(keys, self.n, acc=acc)
        return ({i: want for i in range(calls)},
                roofline.census_work(keys, self.n))
