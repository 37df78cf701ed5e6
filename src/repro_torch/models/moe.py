"""Mixture-of-Experts: top-k router + capacity-based scatter dispatch.

The port of ``repro.models.moe``.  Tokens split into ``groups`` contiguous groups,
each with capacity C = max(ceil(T_g·k/E · cf), 4); an item past its
expert's capacity goes to the group's drop bin and contributes nothing.

Two choices keep the card's output deterministic and equal to the
reference's rule:

* the top-k is a stable descending sort, so a tie picks the lower expert
  index first, as ``jax.lax.top_k`` does (``torch.topk`` promises no
  order on ties);
* the combine adds each token's k weighted expert outputs in item order,
  one slot at a time in the activation dtype, where a scatter-add
  (``index_add_``) on the card would add them with atomics in an order
  that changes from run to run.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef
from repro_torch.models.ffn import GATED, activate, apply_ffn


def moe_schema(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": ParamDef((d, e), ("embed", "experts"), "normal"),
        "w_up": ParamDef((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ParamDef((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.ffn_activation in GATED:
        s["w_gate"] = ParamDef((e, d, f), ("experts", "embed", "ffn"))
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared_up"] = ParamDef((d, fs), ("embed", "ffn"))
        s["shared_down"] = ParamDef((fs, d), ("ffn", "embed"))
        if cfg.ffn_activation in GATED:
            s["shared_gate"] = ParamDef((d, fs), ("embed", "ffn"))
    return s


def _expert_ffn(cfg, p, xe):
    """xe: (E, C, d) -> (E, C, d), batched over experts."""
    up = torch.bmm(xe, p["w_up"].to(xe.dtype))
    gate = (torch.bmm(xe, p["w_gate"].to(xe.dtype))
            if cfg.ffn_activation in GATED else None)
    h = activate(cfg.ffn_activation, up, gate)
    return torch.bmm(h, p["w_down"].to(h.dtype))


def apply_moe(cfg, p, x, capacity_factor: float = 1.25, groups: int = 1,
              ep_sharder=None, group_sharder=None):
    """x: (B, S, d) -> (out, aux_metrics).

    ``group_sharder`` holds every (G, ...) dispatch tensor to the groups'
    layout and ``ep_sharder`` the (E, G·C, d) expert batch to EP
    (``repro_torch.parallel.sharding.moe_dispatch_plan``): constraints,
    which return their tensor unchanged.

    Metrics as the reference's: ``moe_aux_loss``, ``moe_z_loss``,
    ``expert_load`` (int32 items routed to each expert, dropped ones
    included) and ``dropped_tokens`` (items past capacity), each a
    tensor on x's device.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    g = groups if t % max(groups, 1) == 0 else 1
    tl = t // g
    gsh = group_sharder or (lambda a: a)
    xg = gsh(x.reshape(g, tl, d))                              # (G, Tl, d)
    xt = xg.reshape(t, d)

    logits32 = gsh((xg @ p["router"].to(xg.dtype)).float())
    probs = torch.softmax(logits32, dim=-1)
    # top-k by a stable descending sort: ties keep the lower index first
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    cap = max(int(math.ceil(tl * k / e * capacity_factor)), 4)

    # flat work items per group, k consecutive items per token
    i_items = tl * k
    ge = gsh(expert_idx.reshape(g, i_items))                   # (G, I)
    gg = gsh(gate_vals.reshape(g, i_items))
    onehot = gsh(F.one_hot(ge, e).to(torch.int32))             # (G, I, E)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_e, 2, ge[..., None])[..., 0]     # (G, I)
    keep = pos < cap
    slot = torch.where(keep, ge * cap + pos, e * cap)          # (G, I)

    # tokens into (G, E*C+1, d); the last row per group is the drop bin.
    # Kept slots are unique, so a plain write equals the reference's
    # scatter-add into zeros (the drop bin is discarded)
    items_in = xg.repeat_interleave(k, dim=1)                  # (G, I, d)
    g_idx = torch.arange(g, device=x.device)[:, None].expand(g, i_items)
    buf = gsh(torch.zeros((g, e * cap + 1, d), dtype=xt.dtype,
                          device=x.device))
    buf = gsh(buf.index_put_((g_idx, slot), items_in))

    # (G, E, C, d) -> (E, G*C, d)
    xe = buf[:, :-1].reshape(g, e, cap, d).transpose(0, 1)
    xe = xe.reshape(e, g * cap, d)
    if ep_sharder is not None:
        xe = ep_sharder(xe)
    ye = _expert_ffn(cfg, p, xe)
    if ep_sharder is not None:
        ye = ep_sharder(ye)
    ye = gsh(ye.reshape(e, g, cap, d).transpose(0, 1).reshape(
        g, e * cap, d))
    ye = torch.cat([ye, ye.new_zeros((g, 1, d))], dim=1)

    # combine: gather back per group, weighted by gates, the k slots of
    # each token added in item order
    out_items = torch.gather(ye, 1, slot[..., None].expand(g, i_items, d))
    out_items = (out_items * gg[..., None].to(ye.dtype)).reshape(
        g, tl, k, d)
    out = gsh(torch.zeros((g, tl, d), dtype=ye.dtype, device=x.device))
    for j in range(k):
        out = out + out_items[:, :, j]
    out = gsh(out).reshape(t, d)

    if cfg.num_shared_experts:
        sp = {"w_up": p["shared_up"], "w_down": p["shared_down"]}
        if "shared_gate" in p:
            sp["w_gate"] = p["shared_gate"]
        out = out + apply_ffn(cfg, sp, xt[None]).reshape(t, d)

    me = probs.mean(dim=(0, 1))                                # (E,)
    load = onehot.sum(dim=(0, 1), dtype=torch.int32)           # (E,)
    ce = load.float() / max(t * k, 1)
    aux_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits32, dim=-1) ** 2)
    dropped = torch.sum(1 - keep.to(torch.int32), dtype=torch.int32)
    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "expert_load": load, "dropped_tokens": dropped}
    return out.reshape(b, s, d), metrics
