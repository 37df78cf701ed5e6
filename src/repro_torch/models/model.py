"""Model assembly for all 10 architectures: dense, MoE, vision-language
(M-RoPE), encoder-decoder and the recurrent ones (xLSTM's mLSTM and sLSTM,
RecurrentGemma's RG-LRU with local attention).

The port of ``repro.models.model``'s serving path, its training loss
(:func:`loss_fn`, with ``remat``) and its abstract parameters
(:func:`make_abstract_params`, :func:`params_axes`).  The reference groups
layers of one signature into stacked, scanned supergroups; the port keeps
one module per layer instead (:class:`LanguageModel`: an ``nn.ModuleList``
of blocks, each leaf named as the reference names it — ``norm1.scale``,
``mixer.wq``, ``ffn.w_up``, ``moe.router``, ``cross_attn.wk``, …), and
runs them in a Python loop.  :func:`param_schema`, :func:`layer_groups`
and :func:`count_params` keep the reference's grouped layout, so counts
and group structure compare one to one, and
``repro_torch.convert.lm_params_from_reference`` un-stacks a JAX
parameter tree into the port's layers in :func:`_group_layer_params`
order.

Parameters are float32 and activations bfloat16; every matmul casts its
weight to the activation dtype, so a copy of the weights in the dtype
each is read in (:func:`compute_copy`) computes the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.common import (
    ParamDef, ParamTree, abstract_params, apply_norm, init_params,
    norm_schema, pad_vocab, schema_axes, tree_paths)

Sig = tuple  # (mixer_kind, ffn_kind)

#: the norm subtrees, whose parameters the forward applies in float32
NORMS = ("norm1", "norm2", "norm_cross", "out_norm")
#: a recurrent block's state tuple, by the names of its decode cache entry
STATE_KEYS = {"mlstm": ("c", "n", "m"), "slstm": ("c", "n", "h", "m"),
              "rglru": ("conv", "h")}
_INIT_STATE = {"mlstm": rec_mod.mlstm_init_state,
               "slstm": rec_mod.slstm_init_state,
               "rglru": rec_mod.rglru_init_state}


# ---------------------------------------------------------- layer grouping

def layer_sigs(cfg: ArchConfig, num_layers: int | None = None) -> list[Sig]:
    n = cfg.num_layers if num_layers is None else num_layers
    kinds = cfg.pattern_for(n)
    sigs = []
    for i, kind in enumerate(kinds):
        if cfg.d_ff == 0:
            ffn_kind = "none"
        elif cfg.is_moe:
            ffn_kind = ("dense_first" if (cfg.first_layer_dense and i == 0)
                        else "moe")
        else:
            ffn_kind = "dense"
        sigs.append((kind, ffn_kind))
    return sigs


def layer_groups(cfg: ArchConfig,
                 num_layers: int | None = None) -> list[tuple[list, int]]:
    """[(sig_chunk, repeats)]: the reference's scanned supergroups."""
    sigs = layer_sigs(cfg, num_layers)
    groups, i = [], 0
    if sigs and cfg.first_layer_dense:
        groups.append(([sigs[0]], 1))
        i = 1
    k = len(cfg.block_pattern)
    rem = len(sigs) - i
    reps = rem // k
    if reps > 0 and all(sigs[i + j * k: i + (j + 1) * k] == sigs[i:i + k]
                        for j in range(reps)):
        groups.append((sigs[i:i + k], reps))
        i += reps * k
    while i < len(sigs):                        # run-length the remainder
        j = i
        while j < len(sigs) and sigs[j] == sigs[i]:
            j += 1
        groups.append(([sigs[i]], j - i))
        i = j
    return groups


# ---------------------------------------------------------- schemas

def _mixer_schema(cfg, kind):
    if kind in ("attn", "local_attn"):
        return attn_mod.attn_schema(cfg)
    if kind == "mlstm":
        return rec_mod.mlstm_schema(cfg)
    if kind == "slstm":
        return rec_mod.slstm_schema(cfg)
    if kind == "rglru":
        return rec_mod.rglru_schema(cfg)
    raise ValueError(kind)


def block_schema(cfg, sig: Sig, cross: bool = False) -> dict:
    kind, ffn_kind = sig
    s = {"norm1": norm_schema(cfg), "mixer": _mixer_schema(cfg, kind)}
    if cross:
        s["norm_cross"] = norm_schema(cfg)
        s["cross_attn"] = attn_mod.attn_schema(cfg)
    if ffn_kind != "none":
        s["norm2"] = norm_schema(cfg)
        if ffn_kind == "moe":
            s["moe"] = moe_mod.moe_schema(cfg)
        elif ffn_kind == "dense_first":
            s["ffn"] = ffn_mod.ffn_schema(cfg, d_ff=cfg.dense_d_ff)
        else:
            s["ffn"] = ffn_mod.ffn_schema(cfg)
    return s


def _stack_defs(schema, n: int):
    def walk(node):
        if isinstance(node, ParamDef):
            return ParamDef((n,) + node.shape, ("layers",) + node.axes,
                            node.init, node.dtype)
        return {k: walk(v) for k, v in node.items()}
    return walk(schema)


def _top_schema(cfg) -> dict:
    vp = pad_vocab(cfg.vocab_size)
    s = {
        "embed": ParamDef((vp, cfg.d_model), ("vocab", "embed"), "embed"),
        "out_norm": norm_schema(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((cfg.d_model, vp), ("embed", "vocab"))
    return s


def param_schema(cfg: ArchConfig, num_layers: int | None = None) -> dict:
    """The reference's grouped schema (``g{i}.b{j}``, stacked over each
    group's repeats)."""
    s = _top_schema(cfg)
    for gi, (chunk, reps) in enumerate(layer_groups(cfg, num_layers)):
        g = {f"b{bi}": block_schema(cfg, sig, cross=cfg.is_encdec)
             for bi, sig in enumerate(chunk)}
        s[f"g{gi}"] = _stack_defs(g, reps) if reps > 1 else g
    if cfg.is_encdec:
        enc_sig = layer_sigs(cfg, cfg.encoder_layers)[0]
        s["encoder"] = {
            "out_norm": norm_schema(cfg),
            "g0": _stack_defs({"b0": block_schema(cfg, enc_sig)},
                              cfg.encoder_layers)}
    return s


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count from the schema (no allocation)."""
    total = 0
    for path, d in tree_paths(param_schema(cfg)):
        size = int(np.prod(d.shape))
        if active_only and "moe" in path and path[-1] in (
                "w_up", "w_down", "w_gate"):
            size = size * cfg.top_k // max(cfg.num_experts, 1)
        if active_only and path[-1] in ("embed", "lm_head"):
            continue
        total += size
    return total


def make_abstract_params(cfg: ArchConfig, num_layers: int | None = None):
    """The reference's grouped parameter tree as ``meta`` tensors (shape
    and dtype, no storage)."""
    return abstract_params(param_schema(cfg, num_layers))


def params_axes(cfg: ArchConfig, num_layers: int | None = None):
    """The logical axes of each leaf of :func:`make_abstract_params`."""
    return schema_axes(param_schema(cfg, num_layers))


# ---------------------------------------------------------- the module

class LanguageModel(ParamTree):
    """The parameters of one model: ``embed``, ``out_norm``, ``lm_head``
    (untied configs), ``layers`` (one block per layer) and, for an
    encoder-decoder, ``encoder`` (its ``layers`` and ``out_norm``).
    Allocated uninitialised on ``device``; :func:`make_params` fills it.
    """

    def __init__(self, cfg: ArchConfig, num_layers: int | None = None,
                 device=None):
        super().__init__(_top_schema(cfg), device)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            ParamTree(block_schema(cfg, sig, cross=cfg.is_encdec), device)
            for sig in layer_sigs(cfg, num_layers))
        if cfg.is_encdec:
            enc_sig = layer_sigs(cfg, cfg.encoder_layers)[0]
            self.encoder = ParamTree({"out_norm": norm_schema(cfg)}, device)
            self.encoder.layers = nn.ModuleList(
                ParamTree(block_schema(cfg, enc_sig), device)
                for _ in range(cfg.encoder_layers))


def make_params(cfg: ArchConfig, seed: int = 0,
                num_layers: int | None = None, device=None,
                generator: torch.Generator | None = None,
                trainable: bool = False) -> LanguageModel:
    """A :class:`LanguageModel` on ``device`` (the card unless given
    another), filled by the reference's recipes from ``generator`` (a
    ``torch.Generator`` on that device seeded with ``seed`` when not
    given).  ``trainable`` makes every float32 leaf require a gradient:
    the master weights of training, which the forward casts at use as it
    casts a frozen model's (``model.requires_grad_()`` does the same to a
    model made otherwise)."""
    device = resolve_device(device)
    model = LanguageModel(cfg, num_layers, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    init_params(model, generator)
    return model.requires_grad_(trainable)


def compute_copy(model: LanguageModel, device=None) -> LanguageModel:
    """A copy of ``model`` on ``device`` (``model``'s when not given)
    holding each leaf in the dtype the forward reads it in: float32 for
    the norms and the recurrent blocks' gate biases, recurrent weights,
    norm scales, conv and decay (``recurrent.F32_LEAVES``), bfloat16 for
    every other matrix, embedding and bias.  The two RG-LRU gate
    matrices, read in float32 by the decode step and in bfloat16 by the
    prefill, are kept in float32 with a bfloat16 twin (``<name>_bf16``).
    The forward casts each weight to its dtype at use, so this copy
    computes the same numbers without a cast per step."""
    device = model.embed.device if device is None else torch.device(device)
    out = LanguageModel(model.cfg, len(model.layers), device="meta")
    for path, tree in out.named_modules():
        if not isinstance(tree, ParamTree):
            continue
        src = model.get_submodule(path)
        norm = path.rsplit(".", 1)[-1] in NORMS
        for name in list(tree.inits):
            w = src[name].detach()
            keep = norm or name in rec_mod.F32_LEAVES | \
                rec_mod.TWO_DTYPE_LEAVES
            tree._parameters[name] = nn.Parameter(
                w.to(device) if keep else w.to(device, torch.bfloat16),
                requires_grad=False)
            if name in rec_mod.TWO_DTYPE_LEAVES:
                tree._parameters[f"{name}_bf16"] = nn.Parameter(
                    w.to(device, torch.bfloat16), requires_grad=False)
    return out


# ---------------------------------------------------------- block forward

def _residual(x, y):
    """x + y in x's dtype, and the float32 sum before its rounding."""
    s = x.float() + y.float()
    return s.to(x.dtype), s


def _recurrent_block(cfg, kind, p, h, *, state=None, decode=False,
                     chunk: int = 256):
    """The recurrent block of ``kind`` over ``h`` -> (y, its state); the
    sLSTM decodes as its block over one position."""
    if kind == "mlstm":
        return rec_mod.mlstm_block(cfg, p, h, chunk=chunk, state=state,
                                   decode=decode)
    if kind == "slstm":
        return rec_mod.slstm_block(cfg, p, h, state=state)
    return rec_mod.rglru_block(cfg, p, h, state=state, decode=decode)


def apply_block(cfg, sig: Sig, p, x, ctx, s=None):
    """One block, full-sequence mode; its first norm reads ``s``, the
    float32 sum the previous block left, when given, else ``x``.
    Returns (x, aux); ``aux["sum"]`` is the float32 sum of the block's
    last residual."""
    kind, ffn_kind = sig
    metrics = {}
    cache = {}
    h = apply_norm(cfg, p["norm1"], x if s is None else s).to(x.dtype)
    if kind in ("attn", "local_attn"):
        window = cfg.window if kind == "local_attn" else 0
        y, k, v = attn_mod.attention_kv(
            cfg, p["mixer"], h, positions=ctx["positions"],
            layer_window=window, causal=ctx["causal"],
            q_chunk=ctx["q_chunk"])
        if ctx["want_cache"]:
            cache = {"k": k, "v": v}
    elif kind in STATE_KEYS:
        y, state = _recurrent_block(cfg, kind, p["mixer"], h,
                                    chunk=ctx["rec_chunk"])
        cache = {"state": state} if ctx["want_cache"] else {}
    else:
        raise ValueError(kind)
    x, s = _residual(x, y)
    if "cross_attn" in p and ctx.get("enc_out") is not None:
        hc = apply_norm(cfg, p["norm_cross"], s).to(x.dtype)
        yc = attn_mod.attention(
            cfg, p["cross_attn"], hc, positions=ctx["positions"],
            causal=False, xkv=ctx["enc_out"], q_chunk=ctx["q_chunk"],
            kv_positions=ctx.get("enc_positions"))
        x, s = _residual(x, yc)
    if ffn_kind != "none":
        h2 = apply_norm(cfg, p["norm2"], s).to(x.dtype)
        if ffn_kind == "moe":
            if ctx.get("moe_fn") is not None:
                y2, moe_metrics = ctx["moe_fn"](p["moe"], h2)
            else:
                y2, moe_metrics = moe_mod.apply_moe(
                    cfg, p["moe"], h2, groups=ctx.get("moe_groups", 1),
                    ep_sharder=ctx.get("ep_sharder"),
                    group_sharder=ctx.get("moe_group_sharder"))
            metrics.update(moe_metrics)
        else:
            y2 = ffn_mod.apply_ffn(cfg, p["ffn"], h2)
        x, s = _residual(x, y2)
    return x, {"metrics": metrics, "cache": cache, "sum": s}


def _zero_metrics(cfg, device):
    if not cfg.is_moe:
        return {}
    return {"moe_aux_loss": torch.zeros((), device=device),
            "moe_z_loss": torch.zeros((), device=device),
            "expert_load": torch.zeros((cfg.num_experts,),
                                       dtype=torch.int32, device=device),
            "dropped_tokens": torch.zeros((), dtype=torch.int32,
                                          device=device)}


def _merge_metrics(acc, new):
    for k, v in new.items():
        acc[k] = acc.get(k, 0) + v
    return acc


# ---------------------------------------------------------- full forward

def embed_tokens(cfg, params, batch):
    x = params["embed"][batch["tokens"].long()].to(torch.bfloat16)
    if cfg.modality == "vlm" and "vision_embeds" in batch:
        x = torch.where(batch["vision_mask"][..., None],
                        batch["vision_embeds"].to(x.dtype), x)
    return x


def _positions_for(cfg, batch, b, s, device):
    if cfg.rope_variant == "mrope":
        if "positions3" in batch:
            return batch["positions3"]
        pos = torch.arange(s, dtype=torch.int32, device=device)
        return pos.expand(3, b, s)
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def carried_inputs(groups) -> tuple[list, list, bool]:
    """(each layer's signature, whether its first norm reads the rounded
    residual, whether the final norm does), ``groups`` being the
    reference's (``layer_groups``).

    The reference's compiled program keeps a residual sum unrounded up to
    the next norm wherever no scan boundary lies between them; a scan's
    carry (the first block of each repeat of a scanned group, and the
    block after one) and the embedding are rounded to bfloat16.
    """
    sigs, reads_carry = [], []
    scanned = True                          # the embedding is rounded
    for chunk, reps in groups:
        for r in range(reps):
            for i, sig in enumerate(chunk):
                sigs.append(sig)
                reads_carry.append(i == 0 and (reps > 1 or (
                    r == 0 and scanned)))
        scanned = reps > 1
    return sigs, reads_carry, scanned


def run_stack(cfg, layers, groups, x, ctx):
    """Apply each layer in turn, ``groups`` being the reference's
    (``layer_groups``) -> (x, the float32 sum the final norm reads or
    ``None`` when it reads ``x`` (:func:`carried_inputs`), summed
    metrics, per-layer caches).

    With ``ctx["remat"]`` each layer runs under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the
    reference wraps each scan body in ``jax.checkpoint``: the backward
    recomputes a layer from its inputs instead of keeping its
    activations.  ``ctx["sharder"]`` constrains the residual stream after
    every block, as the reference's does."""
    metrics = _zero_metrics(cfg, x.device)
    caches = []
    sigs, reads_carry, scanned = carried_inputs(groups)
    sharder = ctx.get("sharder") or (lambda t: t)
    s = None
    for sig, p, carry in zip(sigs, layers, reads_carry):
        if ctx.get("remat"):
            x, aux = checkpoint(apply_block, cfg, sig, p, x, ctx,
                                None if carry else s, use_reentrant=False)
        else:
            x, aux = apply_block(cfg, sig, p, x, ctx, None if carry else s)
        x = sharder(x)
        s = aux["sum"]
        metrics = _merge_metrics(metrics, aux["metrics"])
        caches.append(aux["cache"])
    return x, None if scanned else s, metrics, caches


def encode(cfg, params, src_embeds, *, q_chunk: int = 512,
           remat: bool = False, sharder=None):
    """The encoder stack over ``src_embeds`` (B, S_src, d) ->
    (encoder output in bfloat16, its positions)."""
    src = src_embeds.to(torch.bfloat16)
    bs, ss, _ = src.shape
    positions = torch.arange(ss, dtype=torch.int32,
                             device=src.device).expand(bs, ss)
    ctx = dict(positions=positions, causal=False, q_chunk=q_chunk,
               want_cache=False, enc_out=None, remat=remat, sharder=sharder)
    enc = params["encoder"]
    groups = [([layer_sigs(cfg, 1)[0]], cfg.encoder_layers)]
    x, s, _, _ = run_stack(cfg, enc.layers, groups, src, ctx)
    return (apply_norm(cfg, enc["out_norm"], x if s is None else s).to(
        x.dtype), positions)


def forward(cfg: ArchConfig, params, batch, *, q_chunk: int = 512,
            rec_chunk: int = 256, want_cache: bool = False,
            sharder=None, remat: bool = False, scan_layers: bool = True,
            rec_unroll: bool = False, moe_groups: int = 1,
            ep_sharder=None, moe_group_sharder=None, moe_fn=None,
            enc_out=None):
    """Full-sequence forward -> (final hidden states, metrics, per-layer
    caches).  An encoder-decoder encodes ``batch["src_embeds"]`` unless
    given its ``enc_out`` (from :func:`encode`).  ``rec_chunk`` is the
    mLSTM's chunk length; ``remat`` recomputes each layer in the backward
    (:func:`run_stack`).

    The parallel layer's hooks, with the reference's names: ``sharder``
    constrains the residual stream (after the embedding and each block),
    ``moe_groups``, ``ep_sharder`` and ``moe_group_sharder`` go to each
    ``apply_moe`` (``parallel.sharding.moe_dispatch_plan``), and
    ``moe_fn(p, x) -> (y, metrics)`` replaces ``apply_moe`` when given
    (``models.moe_shard.make_sharded_moe``).  ``scan_layers`` and
    ``rec_unroll`` choose how the reference compiles its layer loop and
    the mLSTM's chunk loop; the port runs both eagerly, so they change
    nothing here."""
    del scan_layers, rec_unroll
    x = embed_tokens(cfg, params, batch)
    if sharder is not None:
        x = sharder(x)
    b, s, _ = x.shape
    ctx = dict(positions=_positions_for(cfg, batch, b, s, x.device),
               causal=True, q_chunk=q_chunk, rec_chunk=rec_chunk,
               want_cache=want_cache, enc_out=None, sharder=sharder,
               remat=remat, moe_groups=moe_groups, ep_sharder=ep_sharder,
               moe_group_sharder=moe_group_sharder, moe_fn=moe_fn)
    if cfg.is_encdec:
        if enc_out is None:
            enc_out = encode(cfg, params, batch["src_embeds"],
                             q_chunk=q_chunk, remat=remat, sharder=sharder)
        ctx["enc_out"], ctx["enc_positions"] = enc_out
    x, s, metrics, caches = run_stack(
        cfg, params.layers, layer_groups(cfg, len(params.layers)), x, ctx)
    x = apply_norm(cfg, params["out_norm"], x if s is None else s).to(
        x.dtype)
    return x, metrics, caches


def logits_from_hidden(cfg, params, x):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return x @ head.to(x.dtype)


def _mask_padded_vocab(cfg, logits):
    vp = logits.shape[-1]
    neg = torch.arange(vp, device=logits.device) >= cfg.vocab_size
    return torch.where(neg, attn_mod.NEG_INF, logits)


def loss_fn(cfg: ArchConfig, params, batch, *, q_chunk: int = 512,
            rec_chunk: int = 256, sharder=None, logits_sharder=None,
            remat: bool = False, scan_layers: bool = True,
            rec_unroll: bool = False, moe_groups: int = 1, ep_sharder=None,
            moe_group_sharder=None, moe_fn=None):
    """Cross-entropy + MoE aux losses -> (loss, metrics).  labels < 0 are
    masked; the loss is the masked mean over ``max(count, 1)``.

    As the reference's: the logits over the padded vocabulary are masked
    to ``NEG_INF`` in the activation dtype, then read in float32; an MoE
    config adds ``router_aux_coef · moe_aux_loss + 1e-3 · moe_z_loss``.
    ``metrics`` holds the forward's (the MoE ones) and ``nll``.  The
    label's logit is a ``gather``, where the reference reduces a one-hot
    mask (to keep GSPMD from gathering the vocabulary): both pick the
    same element.  ``logits_sharder`` constrains the logits; the other
    hooks are :func:`forward`'s.
    """
    x, metrics, _ = forward(cfg, params, batch, q_chunk=q_chunk,
                            rec_chunk=rec_chunk, sharder=sharder,
                            remat=remat, scan_layers=scan_layers,
                            rec_unroll=rec_unroll, moe_groups=moe_groups,
                            ep_sharder=ep_sharder,
                            moe_group_sharder=moe_group_sharder,
                            moe_fn=moe_fn)
    labels = batch["labels"].long()
    logits = logits_from_hidden(cfg, params, x)
    if logits_sharder is not None:
        logits = logits_sharder(logits)
    logits = _mask_padded_vocab(cfg, logits).float()
    lse = torch.logsumexp(logits, dim=-1)                       # (b, s)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    msk = (labels >= 0).float()
    nll = torch.sum((lse - ll) * msk) / torch.clamp(msk.sum(), min=1.0)
    loss = nll
    if cfg.is_moe:
        loss = (loss + cfg.router_aux_coef * metrics["moe_aux_loss"]
                + 1e-3 * metrics["moe_z_loss"])
    return loss, dict(metrics, nll=nll)


def serve_prefill(cfg: ArchConfig, params, batch, *, q_chunk: int = 512,
                  rec_chunk: int = 256, sharder=None,
                  scan_layers: bool = True, rec_unroll: bool = False,
                  moe_groups: int = 1, ep_sharder=None,
                  moe_group_sharder=None, moe_fn=None, enc_out=None):
    """Prefill: full forward -> (last-position logits (B, 1, V_pad), the
    padded vocab masked to ``NEG_INF``; per-layer caches: ``{"k", "v"}``
    for attention, ``{"state": (...)}`` for a recurrent block).  The
    hooks are :func:`forward`'s."""
    x, _, caches = forward(cfg, params, batch, q_chunk=q_chunk,
                           rec_chunk=rec_chunk, want_cache=True,
                           sharder=sharder, scan_layers=scan_layers,
                           rec_unroll=rec_unroll, moe_groups=moe_groups,
                           ep_sharder=ep_sharder,
                           moe_group_sharder=moe_group_sharder,
                           moe_fn=moe_fn, enc_out=enc_out)
    logits = logits_from_hidden(cfg, params, x[:, -1:])
    return _mask_padded_vocab(cfg, logits), caches


# ---------------------------------------------------------- decode path

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               src_len: int = 0, dtype=torch.bfloat16,
               kv_quant: bool = False, device=None) -> dict:
    """Zeroed decode cache: ``{"pos": 0, "layers": [one dict per
    layer]}``; a recurrent layer's entry holds its initial state."""
    layers = []
    for kind, _ in layer_sigs(cfg):
        if kind in STATE_KEYS:
            layers.append(dict(zip(STATE_KEYS[kind], _INIT_STATE[kind](
                cfg, batch, device))))
            continue
        window = cfg.window if kind == "local_attn" else 0
        entry = attn_mod.init_kv_cache(cfg, batch, seq_len, window,
                                       dtype, kv_quant=kv_quant,
                                       device=device)
        if cfg.is_encdec:
            entry["cross_k"] = torch.zeros(
                (batch, src_len, cfg.num_kv_heads, cfg.head_dim),
                dtype=dtype, device=device)
            entry["cross_v"] = torch.zeros_like(entry["cross_k"])
        layers.append(entry)
    return {"pos": 0, "layers": layers}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _group_layer_params(cfg, params, num_layers: int | None = None):
    """Flatten a grouped tree (``g{i}.b{j}``, leaves stacked over each
    scanned group's repeats — the reference's layout) to a per-layer
    list of block trees, in layer order."""
    out = []
    for gi, (chunk, reps) in enumerate(layer_groups(cfg, num_layers)):
        gp = params[f"g{gi}"]
        for r in range(reps):
            for bi, _ in enumerate(chunk):
                bp = gp[f"b{bi}"]
                out.append(_tree_map(lambda a: a[r], bp)
                           if reps > 1 else bp)
    return out


def decode_step(cfg: ArchConfig, params, token, cache):
    """One-token decode. token: (B, 1) int. Returns (logits, cache); the
    cache is updated in place (a recurrent layer's entry gets its new
    state) and its ``pos`` advanced."""
    pos = cache["pos"]
    x = params["embed"][token.long()].to(torch.bfloat16)
    s = x                           # what the next norm reads
    sigs = layer_sigs(cfg, len(params.layers))
    for (kind, ffn_kind), p, entry in zip(sigs, params.layers,
                                          cache["layers"]):
        h = apply_norm(cfg, p["norm1"], s).to(x.dtype)
        if kind in STATE_KEYS:
            y, state = _recurrent_block(
                cfg, kind, p["mixer"], h, decode=True,
                state=tuple(entry[key] for key in STATE_KEYS[kind]))
            entry.update(zip(STATE_KEYS[kind], state))
        else:
            window = cfg.window if kind == "local_attn" else 0
            y, _ = attn_mod.decode_attention(cfg, p["mixer"], h, entry,
                                             pos, layer_window=window)
        x, s = _residual(x, y)
        if "cross_attn" in p:
            hc = apply_norm(cfg, p["norm_cross"], s).to(x.dtype)
            yc, _ = attn_mod.decode_attention(
                cfg, p["cross_attn"], hc, entry, pos,
                cross_kv={"k": entry["cross_k"], "v": entry["cross_v"]})
            x, s = _residual(x, yc)
        if ffn_kind != "none":
            h2 = apply_norm(cfg, p["norm2"], s).to(x.dtype)
            if ffn_kind == "moe":
                y2, _ = moe_mod.apply_moe(cfg, p["moe"], h2)
            else:
                y2 = ffn_mod.apply_ffn(cfg, p["ffn"], h2)
            x, s = _residual(x, y2)
    x = apply_norm(cfg, params["out_norm"], s).to(x.dtype)
    logits = _mask_padded_vocab(cfg, logits_from_hidden(cfg, params, x))
    cache["pos"] = pos + 1
    return logits, cache
