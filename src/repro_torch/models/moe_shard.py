"""Sharded MoE dispatch over the logical devices of a mesh.

The port of ``repro.models.moe_shard`` (its ``shard_map`` dispatch), the
per-device body run on each logical device's stream
(``repro_torch.parallel.collectives``):

* each device's tokens form exactly one dispatch group: routing,
  positions and capacity need no collective;
* the expert exchange is ONE ``all_to_all`` over the ``model`` axis each
  way when the experts divide it (EP);
* router and load statistics are per-device partials merged by one
  ``psum``/``pmean``;
* FSDP weight gathers are explicit ``all_gather``s (their gradient a
  reduce-scatter); under EP the experts' ``model`` split stays, since it
  is the expert-to-device assignment.

Numerics match the grouped path (``apply_moe``) with the same per-group
capacity; the top-k and the combine keep ``apply_moe``'s deterministic
rules (a stable sort; each token's k slots added in item order).  In
bfloat16 they follow the reference's compiled ``shard_map`` program,
which rounds in two places where its grouped path does not: the router
logits are a float32 product of the bfloat16 inputs, never rounded, and
each token's k weighted items are summed in float32 and rounded once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.ffn import activate
from repro_torch.models.moe import _expert_ffn
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    Placement, mesh_axis_sizes, shard_tensor, unshard)


def _gather_weight(blocks, spec: tuple, mesh, skip: tuple = ()):
    """Explicit FSDP: all-gather a weight's blocks along every sharded
    dim, except over the axes in ``skip``."""
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for ax in (part if isinstance(part, tuple) else (part,)):
            if ax in skip:
                continue
            blocks = coll.all_gather(blocks, mesh, ax, dim)
    return blocks


def _local_dispatch(xt, logits32, e: int, k: int, cap: int):
    """One device's routing and scatter (no collective): the (E, C, d)
    expert buffer, (slot, gate) per item, (probs, onehot, keep)."""
    tl, d = xt.shape
    probs = torch.softmax(logits32, dim=-1)
    # top-k by a stable descending sort: ties keep the lower index first
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    ge = expert_idx.reshape(tl * k)
    gg = gate_vals.reshape(tl * k)
    onehot = F.one_hot(ge, e).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, 0, dtype=torch.int32) - onehot,
                       1, ge[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, ge * cap + pos, e * cap)
    # kept slots are unique: a plain write equals a scatter-add into zeros
    buf = xt.new_zeros((e * cap + 1, d))
    buf.index_put_((slot,), xt.repeat_interleave(k, dim=0))
    return buf[:-1].reshape(e, cap, d), (slot, gg), (probs, onehot, keep)


def _blocks(v, placement: Placement):
    return list(v) if isinstance(v, (list, tuple)) else shard_tensor(
        v, placement)


def make_sharded_moe(cfg, mesh, batch_axes_, expert_specs: dict,
                     capacity_factor: float = 1.25):
    """Build ``apply(p, x) -> (y, metrics)`` running the dispatch on the
    logical devices of ``mesh``.  ``expert_specs`` are the weights' specs
    (from the sharding rules, ``spec_for_axes`` of ``moe_schema``); the
    router is replicated.  Each weight of ``p`` and ``x`` (B, S, d) is a
    whole tensor, cut into its blocks by ``shard_tensor`` (``x`` over
    the batch axes and ``model`` on the sequence), or already a list of
    those blocks; ``y`` comes back in the form ``x`` came in.  The
    metrics are replicated; the first device's are returned."""
    sizes = mesh_axis_sizes(mesh)
    nm = sizes.get("model", 1)
    e, k = cfg.num_experts, cfg.top_k
    ep = e % nm == 0 and nm > 1
    all_axes = tuple(mesh.axis_names)
    b_axes = (batch_axes_ if isinstance(batch_axes_, tuple)
              else ((batch_axes_,) if batch_axes_ else ()))
    x_spec = (b_axes if len(b_axes) > 1 else
              (b_axes[0] if b_axes else None), "model", None)
    p_specs = dict(expert_specs)
    p_specs["router"] = (None, None)
    skip = ("model",) if ep else ()

    def apply(p, x):
        x_place = Placement(mesh, x_spec)
        pb = {key: _blocks(p[key], Placement(mesh, p_specs[key]))
              for key in p_specs if key in p}
        xb = _blocks(x, x_place)
        b_l, s_l, d = xb[0].shape
        tl = b_l * s_l
        cap = max(int(math.ceil(tl * k / e * capacity_factor)), 4)

        def route(i, xl, wr):
            xt = xl.reshape(tl, d)
            # the reference's compiled program computes this product in
            # float32 and keeps it unrounded
            logits32 = xt.float() @ wr.to(xt.dtype).float()
            xe, items, stats = _local_dispatch(xt, logits32, e, k, cap)
            return xt, logits32, xe, items, stats
        xt, logits32, xe, items, stats = coll.map_shards(
            route, mesh, xb, pb["router"])

        # EP: weights stay model-sharded on the expert dim; FSDP dims are
        # gathered
        ws = {key: _gather_weight(pb[key], expert_specs[key], mesh, skip)
              for key in ("w_up", "w_down", "w_gate") if key in pb}
        names = sorted(ws)

        def ffn(i, xe_i, *w):
            return _expert_ffn(cfg, dict(zip(names, w)), xe_i)
        if ep:
            # ONE all-to-all each way over `model`: (E, C, d) -> (E/nm,
            # nm*C, d) gathers each owner's expert buffers from its row
            xe = coll.all_to_all(xe, mesh, "model", 0, 1)
            ye = coll.map_shards(ffn, mesh, xe, *(ws[n] for n in names))
            ye = coll.all_to_all(ye, mesh, "model", 1, 0)
        else:
            ye = coll.map_shards(ffn, mesh, xe, *(ws[n] for n in names))

        shared = {key: _gather_weight(pb[key], expert_specs[key], mesh)
                  for key in ("shared_up", "shared_down", "shared_gate")
                  if key in pb}
        snames = sorted(shared)

        def combine(i, ye_i, item, xt_i, *sw):
            slot, gg = item
            ye_i = torch.cat([ye_i.reshape(e * cap, d),
                              ye_i.new_zeros((1, d))])
            out_items = (ye_i[slot] * gg[:, None].to(ye_i.dtype)).reshape(
                tl, k, d)
            # each token's k items added in item order in float32, then
            # rounded once, as the reference's compiled scatter-add does
            out = out_items.new_zeros((tl, d), dtype=torch.float32)
            for j in range(k):
                out = out + out_items[:, j].float()
            out = out.to(ye_i.dtype)
            if sw:
                s = dict(zip(snames, sw))
                h = xt_i @ s["shared_up"].to(xt_i.dtype)
                if "shared_gate" in s:
                    h = activate("swiglu", h,
                                 xt_i @ s["shared_gate"].to(xt_i.dtype))
                else:
                    h = activate("gelu", h)
                out = out + h @ s["shared_down"].to(h.dtype)
            return out.reshape(b_l, s_l, d)
        out = coll.map_shards(combine, mesh, ye, items, xt,
                              *(shared[n] for n in snames))

        # privatized stats -> ONE reduction each (the census pattern)
        probs, onehot, keep = zip(*stats)
        me = coll.pmean(coll.map_shards(lambda i, pr: pr.mean(dim=0), mesh,
                                        probs), mesh, all_axes)
        load = coll.psum(coll.map_shards(
            lambda i, oh: oh.sum(dim=0, dtype=torch.int32), mesh, onehot),
            mesh, all_axes)
        tk = float(tl * k * mesh.axis_size(all_axes))
        z = coll.pmean(coll.map_shards(
            lambda i, lg: torch.mean(torch.logsumexp(lg, dim=-1) ** 2),
            mesh, logits32), mesh, all_axes)
        dropped = coll.psum(coll.map_shards(
            lambda i, kp: torch.sum(1 - kp.to(torch.int32),
                                    dtype=torch.int32), mesh, keep),
            mesh, all_axes)
        aux_loss = e * torch.sum(me[0] * (load[0].float() / tk))
        metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z[0],
                   "expert_load": load[0], "dropped_tokens": dropped[0]}
        y = out if isinstance(x, (list, tuple)) else unshard(out, x_place)
        return y, metrics

    return apply
