"""Delta algebra for incremental triad censuses.

The census decomposes over canonical pairs::

    C = complement(base_asym + base_mut + Σ_p partials(p))

where ``partials(p)`` for pair p = (u, v) depends *only* on the dyad code
c_uv, the two CSR rows N(u) and N(v) (contents + direction codes), and the
vertex ids — nothing else (see
:func:`repro_torch.core.census.classify_items`).
An edge delta Δ changes the rows of exactly the *touched* vertices
T = endpoints of pairs whose dyad code changed
(:class:`repro_torch.core.digraph.GraphDelta`).  Hence any pair with both
endpoints outside T contributes bit-identical partials and closed-form
base terms in G_old and G_new, and with

    A(G) = pairs of G with an endpoint in T         (affected pairs)

the update

    C_new = C_old − contrib(A(G_old), G_old) + contrib(A(G_new), G_new)

is *exact* in integer arithmetic — bit-identical to a from-scratch census
of G_new, on every backend and orient mode (the streaming literature's
touched-neighborhood principle, arXiv:1308.2166, composed with the
per-partition additive recounts of arXiv:1706.05151).

This module owns the pure host-side algebra: affected-pair discovery,
subset contributions (via
:func:`repro_torch.core.planner.emit_items_for_pairs` + subset-additive
bases), the combine step, and the exactness invariant checker used by the
tests.  Device dispatch of the subset items lives in
:class:`repro_torch.core.engine.EngineSession`.

Host-side numpy, framework-free, except :func:`host_runner`, which
dispatches through the torch partials.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.digraph import GraphDelta
from repro_torch.core.planner import (
    PairSpace, base_for_pairs, emit_items_for_pairs,
    iter_descriptor_windows)
from repro_torch.core.tricode import FOLD_64_TO_16

#: runner signature: (item_pair, item_slot, item_side) -> (hist64, inter)
ItemRunner = Callable[[np.ndarray, np.ndarray, np.ndarray],
                      tuple[np.ndarray, np.ndarray]]


def affected_pair_ids(space, touched) -> np.ndarray:
    """Indices of the pairs with an endpoint in ``touched`` — the pairs
    whose census contribution may differ after the delta (their item sets,
    item codes, or closed-form terms read a changed row/degree).

    ``space`` may be a :class:`PairSpace` (O(P) mask scan — the oracle)
    or a :class:`~repro_torch.core.pair_index.PairSpaceIndex`, which answers
    the same query in O(Σ deg(touched) · log P) from its touched-row
    walk; results are identical."""
    if hasattr(space, "affected_pair_ids"):   # a PairSpaceIndex
        return space.affected_pair_ids(touched)
    touched = np.asarray(touched, dtype=np.int64).ravel()
    if touched.size == 0 or space.num_pairs == 0:
        return np.zeros(0, dtype=np.int64)
    mask = np.zeros(space.n, dtype=bool)
    mask[touched] = True
    return np.nonzero(mask[space.pair_u] | mask[space.pair_v])[0]


def contribution_counts(base_asym: int, base_mut: int, hist64, inter
                        ) -> np.ndarray:
    """Fold device partials + closed-form bases of a pair subset into its
    additive 16-type contribution.  Slot 0 (the 003 null triads) is left
    at zero — it is a global complement, restored by :func:`combine`."""
    hist64 = np.asarray(hist64, dtype=np.int64)
    inter = np.asarray(inter, dtype=np.int64)
    c = FOLD_64_TO_16 @ hist64
    c[1] += base_asym + int(inter[0])   # 012
    c[2] += base_mut + int(inter[1])    # 102
    c[0] = 0
    return c


def subset_contribution(space: PairSpace, pair_ids: np.ndarray,
                        run_items: ItemRunner
                        ) -> tuple[np.ndarray, int]:
    """16-type contribution of an arbitrary pair subset + its item count.

    ``run_items`` computes the ``(hist64, inter)`` partials of the emitted
    items on whatever backend/device the caller owns; zero-item subsets
    never dispatch.
    """
    ids = np.asarray(pair_ids, dtype=np.int64).ravel()
    base_asym, base_mut = base_for_pairs(space, ids)
    item_pair, item_slot, item_side = emit_items_for_pairs(space, ids)
    num_items = int(item_pair.shape[0])
    if num_items == 0:
        hist64 = np.zeros(64, np.int64)
        inter = np.zeros(2, np.int64)
    else:
        hist64, inter = run_items(item_pair, item_slot, item_side)
    return contribution_counts(base_asym, base_mut, hist64, inter), \
        num_items


def subset_descriptor_windows(space, pair_ids: np.ndarray,
                              max_items: int, desc_shape: int,
                              num_anchors: int):
    """Descriptor windows covering an arbitrary pair subset's item space —
    the device-emission counterpart of :func:`emit_items_for_pairs`.

    A delta update that routes its affected pairs through these windows
    uploads O(affected pairs) descriptor words per window instead of the
    subset's O(items) packed work items; the device expands and prunes in
    place (:func:`repro_torch.core.census.census_partials_desc`), so the
    incremental path's host→device traffic shrinks with the same delta
    algebra and bit-identical results.

    ``space`` may be a :class:`PairSpace` or a
    :class:`~repro_torch.core.pair_index.PairSpaceIndex` (its live space is
    used — the windows it yields are bit-identical either way).
    """
    space = getattr(space, "space", space)   # unwrap a PairSpaceIndex
    ids = np.asarray(pair_ids, dtype=np.int64).ravel()
    if ids.size and (ids.min() < 0 or ids.max() >= space.num_pairs):
        raise ValueError(f"pair id outside [0, {space.num_pairs})")
    offsets = np.zeros(ids.shape[0] + 1, dtype=np.int64)
    np.cumsum(space.counts[ids], out=offsets[1:])
    yield from iter_descriptor_windows(offsets, max_items, desc_shape,
                                       num_anchors, pair_ids=ids)


def combine(census_old: np.ndarray, contrib_old: np.ndarray,
            contrib_new: np.ndarray, n: int) -> np.ndarray:
    """Apply the affected-pair diff: ``C_new = C_old − old + new`` on the
    15 non-null types, with the 003 count restored as the complement of
    the fixed triad total ``C(n, 3)``."""
    out = np.asarray(census_old, dtype=np.int64).copy()
    out[1:] += contrib_new[1:] - contrib_old[1:]
    total = n * (n - 1) * (n - 2) // 6
    out[0] = total - out[1:].sum()
    return out


def host_runner(space: PairSpace, backend: str = "torch",
                device=None) -> ItemRunner:
    """Non-resident reference runner: packs the items and dispatches the
    single-device partials for ``backend`` ad hoc (no session reuse).
    The exactness oracle for :class:`repro_torch.core.engine
    .EngineSession` and the convenience path for standalone host-side
    incremental updates.  ``device=None`` means the CUDA device (and
    raises without one); ``device="cpu"`` runs the plain versions."""
    import torch

    from repro_torch.core.census import partials_fn
    from repro_torch.core.engine import resolve_device
    from repro_torch.core.planner import pad_and_pack

    device = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def run(item_pair, item_slot, item_side):
        item_sp, item_pv = pad_and_pack(item_pair, item_slot, item_side,
                                        item_pair.shape[0])
        fn = partials_fn(backend, space.search_iters)
        hist64, inter = fn(
            put(space.indptr.astype(np.int32)), put(space.packed),
            put(space.pair_u.astype(np.int32)),
            put(space.pair_v.astype(np.int32)), put(space.pair_code),
            put(item_sp), put(item_pv))
        return (hist64.cpu().numpy().astype(np.int64),
                inter.cpu().numpy().astype(np.int64))

    return run


def verify_delta_closure(space_old: PairSpace, space_new: PairSpace,
                         delta: GraphDelta) -> None:
    """Exactness invariant: every pair whose presence or dyad code differs
    between the two spaces must be inside BOTH affected sets (old and new),
    and the delta's recorded codes must match the graphs.  O(P) — used by
    the tests and debug paths, never on the hot path."""
    n = space_old.n
    assert space_new.n == n, "incremental updates require a fixed n"
    key_old = space_old.pair_u * n + space_old.pair_v
    key_new = space_new.pair_u * n + space_new.pair_v
    keys = np.union1d(key_old, key_new)

    def codes_on(space, key_side, keys):
        out = np.zeros(keys.shape[0], dtype=np.int64)
        if key_side.size:
            pos = np.searchsorted(key_side, keys)
            safe = np.minimum(pos, key_side.shape[0] - 1)
            hit = (pos < key_side.shape[0]) & (key_side[safe] == keys)
            out[hit] = (space.pair_code[safe[hit]] & 3)
        return out

    c_old = codes_on(space_old, key_old, keys)
    c_new = codes_on(space_new, key_new, keys)
    changed = keys[c_old != c_new]
    dkeys = delta.pair_lo * n + delta.pair_hi
    assert np.isin(changed, dkeys).all(), \
        "a changed pair escaped the recorded delta"
    rec_old = codes_on(space_old, key_old, dkeys)
    rec_new = codes_on(space_new, key_new, dkeys)
    assert np.array_equal(rec_old, delta.old_code & 3), "stale old codes"
    assert np.array_equal(rec_new, delta.new_code & 3), "stale new codes"

    for space, key_side in ((space_old, key_old), (space_new, key_new)):
        aff = affected_pair_ids(space, delta.touched)
        aff_keys = (space.pair_u[aff] * n + space.pair_v[aff]
                    if aff.size else np.zeros(0, np.int64))
        present_changed = changed[np.isin(changed, key_side)]
        assert np.isin(present_changed, aff_keys).all(), \
            "a changed pair is outside the affected set"
