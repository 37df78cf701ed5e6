"""Carry the JAX package's host state across to the port.

The JAX package's graphs, descriptor windows and plans are numpy-backed
dataclasses; these functions read their attributes (duck-typed — nothing
of the JAX package is imported) and build the port's equivalents, copying
every array, so that both packages can be handed the identical graph.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.planner import CensusPlan, DescriptorWindow


def graph_from_arrays(n: int, indptr, packed, num_arcs: int
                      ) -> CompactDigraph:
    """A :class:`CompactDigraph` from its CSR arrays."""
    indptr = np.array(indptr, dtype=np.int64)
    packed = np.array(packed, dtype=np.int32)
    if indptr.shape != (int(n) + 1,) or indptr[-1] != packed.shape[0]:
        raise ValueError(f"indptr of shape {indptr.shape} does not "
                         f"describe {packed.shape[0]} entries over n={n}")
    return CompactDigraph(n=int(n), indptr=indptr, packed=packed,
                          num_arcs=int(num_arcs))


def graph_from_reference(g) -> CompactDigraph:
    """The port's copy of a JAX-package ``CompactDigraph``."""
    return graph_from_arrays(g.n, g.indptr, g.packed, g.num_arcs)


def window_from_reference(w) -> DescriptorWindow:
    """The port's copy of a JAX-package ``DescriptorWindow``."""
    return DescriptorWindow(
        start=int(w.start), stop=int(w.stop),
        num_preprune=int(w.num_preprune), num_descs=int(w.num_descs),
        desc_pair=np.array(w.desc_pair, dtype=np.int32),
        desc_cum=np.array(w.desc_cum, dtype=np.int32),
        desc_within0=np.array(w.desc_within0, dtype=np.int32),
        anchors=np.array(w.anchors, dtype=np.int32))


def plan_from_reference(p) -> CensusPlan:
    """The port's copy of a JAX-package ``CensusPlan``."""
    return CensusPlan(
        n=int(p.n), num_pairs=int(p.num_pairs), num_items=int(p.num_items),
        max_degree=int(p.max_degree), search_iters=int(p.search_iters),
        orient=str(p.orient),
        indptr=np.array(p.indptr, dtype=np.int32),
        packed=np.array(p.packed, dtype=np.int32),
        pair_u=np.array(p.pair_u, dtype=np.int32),
        pair_v=np.array(p.pair_v, dtype=np.int32),
        pair_code=np.array(p.pair_code, dtype=np.int32),
        item_sp=np.array(p.item_sp, dtype=np.int32),
        item_pv=np.array(p.item_pv, dtype=np.int32),
        base_asym=int(p.base_asym), base_mut=int(p.base_mut))
