"""Gradient compression for the cross-pod all-reduce: quantized psum.

The port of ``repro.parallel.compression`` over logical shards: a
sharded value is the list of its per-device blocks
(``repro_torch.parallel.collectives``).  Scheme: a global max-abs scale
(one scalar ``pmax``), symmetric ``bits``-bit rounding (half to even, as
``jnp.round``), an int32 ``psum`` (exact: |Σq| ≤ shards · qmax ≪ 2³¹),
then the dequantize.  Error feedback keeps what a shard failed to
communicate for its next step (Seide et al., the 1-bit SGD lineage).
Each division by a constant (``qmax``, the shard count) is a multiply
by its float32 reciprocal, as XLA compiles the reference's, so the
results are the reference's bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.parallel import collectives as coll


def quantize(x, scale, bits: int = 8):
    """Each element of ``x`` as a signed integer of ``bits`` bits against
    ``scale``, in int32."""
    qmax = float(2 ** (bits - 1) - 1)
    q = torch.clamp(torch.round(x.float() / scale * qmax), -qmax, qmax)
    return q.to(torch.int32)


def quantized_psum(blocks, mesh, axis, bits: int = 8):
    """All-reduce the blocks over ``axis`` with int-``bits`` quantization;
    returns the float32 blocks."""
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")
    amax = coll.map_shards(lambda i, x: x.float().abs().max(), mesh, blocks)
    scales = coll.map_shards(lambda i, s: torch.clamp(s, min=1e-30), mesh,
                             coll.pmax(amax, mesh, axis))
    q = coll.map_shards(lambda i, x, s: quantize(x, s, bits), mesh, blocks,
                        scales)
    totals = coll.psum(q, mesh, axis)
    qmax = float(2 ** (bits - 1) - 1)
    # the reference's compiled program divides by the constant qmax as
    # a multiply by its float32 reciprocal
    return coll.map_shards(lambda i, t, s: t.float() * (s * (1.0 / qmax)),
                           mesh, totals, scales)


def quantized_tree_psum(trees, mesh, axis, bits: int = 8, residual=None):
    """Leaf-wise quantized psum of per-device trees (dicts of tensors, one
    per flat device) with optional error feedback.

    Returns (reduced trees, new residual trees).  Pass the residual back
    in on the next step to keep the long-run quantization error
    unbiased."""
    names = sorted(trees[0])
    if residual is not None:
        trees = coll.map_shards(
            lambda i, t, r: {k: t[k].float() + r[k] for k in names}, mesh,
            trees, residual)
    reduced = [{} for _ in trees]
    for k in names:
        for i, r in enumerate(quantized_psum([t[k] for t in trees], mesh,
                                             axis, bits)):
            reduced[i][k] = r
    # residual = what this shard failed to communicate
    n = mesh.axis_size(axis)
    new_res = coll.map_shards(
        lambda i, t, r: {k: t[k].float() - r[k] * (1.0 / n) for k in names},
        mesh, trees, reduced)
    return reduced, new_res
