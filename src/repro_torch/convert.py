"""Carry the JAX package's host state across to the port.

The JAX package's graphs, descriptor windows and plans are numpy-backed
dataclasses; these functions read their attributes (duck-typed — nothing
of the JAX package is imported) and build the port's equivalents, copying
every array, so that both packages can be handed the identical graph.
The LM functions do the same for a model's parameter tree and its caches,
given as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.digraph import CompactDigraph
from repro_torch.core.planner import CensusPlan, DescriptorWindow
from repro_torch.models.model import (
    _group_layer_params, _tree_map, layer_groups)


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


# ---------------------------------------------------------------- LM

def _tensor(a) -> torch.Tensor:
    """A torch copy of a numpy array, bfloat16 ones included (numpy holds
    those as the ``ml_dtypes`` type, which ``torch.from_numpy`` refuses)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flat_items(prefix: str, node, out: dict) -> dict:
    for k, v in node.items():
        if isinstance(v, dict):
            _flat_items(f"{prefix}{k}.", v, out)
        else:
            out[f"{prefix}{k}"] = _tensor(v)
    return out


def lm_params_from_reference(cfg, tree, num_layers: int | None = None
                             ) -> dict:
    """The port's ``LanguageModel`` state dict from a JAX parameter tree
    of numpy arrays (``jax.tree.map(np.asarray, make_params(cfg))``).

    Each scanned group's leaves are un-stacked over their leading
    ``reps`` axis into ``layers.{i}``, in ``_group_layer_params`` order;
    the encoder's stacked blocks into ``encoder.layers.{i}``.
    """
    sd = _flat_items("", {k: v for k, v in tree.items()
                          if k in ("embed", "lm_head", "out_norm")}, {})
    for i, block in enumerate(_group_layer_params(cfg, tree, num_layers)):
        _flat_items(f"layers.{i}.", block, sd)
    if cfg.is_encdec:
        enc = tree["encoder"]
        _flat_items("encoder.out_norm.", enc["out_norm"], sd)
        for i in range(cfg.encoder_layers):
            _flat_items(f"encoder.layers.{i}.",
                        _tree_map(lambda a: a[i], enc["g0"]["b0"]), sd)
    return sd


def lm_cache_from_reference(cfg, cache):
    """The port's copy of a JAX package cache, as torch tensors on the
    CPU.

    A decode cache (``{"pos", "layers"}``, one entry per layer) becomes
    ``{"pos": int, "layers": [...]}``; ``serve_prefill``'s caches (a list
    per layer group, leaves stacked over a scanned group's repeats)
    become the port's per-layer list, in layer order.
    """
    if isinstance(cache, dict):
        return {"pos": int(np.asarray(cache["pos"])),
                "layers": [_tree_map(_tensor, entry)
                           for entry in cache["layers"]]}
    flat = []
    for (chunk, reps), group in zip(layer_groups(cfg), cache):
        if reps == 1:
            flat.extend(group)
        else:
            for r in range(reps):
                flat.extend(_tree_map(lambda a: a[r], blk) for blk in group)
    return [_tree_map(_tensor, entry) for entry in flat]
