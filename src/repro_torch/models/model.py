"""Model assembly for the attention architectures: dense, MoE,
vision-language (M-RoPE) and encoder-decoder.

The port of ``repro.models.model``'s serving path.  The reference groups
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
weight to the activation dtype, so a bfloat16 copy of the matrices (norm
scales kept in float32) computes the same numbers.

The recurrent kinds (``mlstm``, ``slstm``, ``rglru``) are not ported yet:
they raise ``NotImplementedError`` (ROADMAP queue 1, recurrent serving).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (
    ParamDef, ParamTree, apply_norm, init_params, norm_schema, pad_vocab,
    tree_paths)

Sig = tuple  # (mixer_kind, ffn_kind)

RECURRENT_KINDS = ("mlstm", "slstm", "rglru")
#: the norm subtrees, whose parameters the forward applies in float32
NORMS = ("norm1", "norm2", "norm_cross", "out_norm")


def _not_ported(kind: str):
    return NotImplementedError(
        f"the {kind!r} block is not ported yet (ROADMAP queue 1: recurrent "
        f"serving, models/recurrent.py)")


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
    if kind in RECURRENT_KINDS:
        raise _not_ported(kind)
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
                generator: torch.Generator | None = None) -> LanguageModel:
    """A :class:`LanguageModel` on ``device`` (the card unless given
    another), filled by the reference's recipes from ``generator`` (a
    ``torch.Generator`` on that device seeded with ``seed`` when not
    given)."""
    device = resolve_device(device)
    model = LanguageModel(cfg, num_layers, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    init_params(model, generator)
    return model


def compute_copy(model: LanguageModel, device=None) -> LanguageModel:
    """A copy of ``model`` on ``device`` (``model``'s when not given)
    whose matrices, embedding and biases are in bfloat16 and whose norm
    parameters stay float32: the forward casts each weight to the
    activation dtype at use, so this copy computes the same numbers
    without a cast per step."""
    device = model.embed.device if device is None else torch.device(device)
    out = LanguageModel(model.cfg, len(model.layers), device="meta")
    for path, tree in out.named_modules():
        if not isinstance(tree, ParamTree):
            continue
        src = model.get_submodule(path)
        keep = path.rsplit(".", 1)[-1] in NORMS
        for name in tree.inits:
            w = src[name].detach()
            tree._parameters[name] = nn.Parameter(
                w.to(device) if keep else w.to(device, torch.bfloat16),
                requires_grad=False)
    return out


# ---------------------------------------------------------- block forward

def _residual(x, y):
    """x + y in x's dtype, and the float32 sum before its rounding."""
    s = x.float() + y.float()
    return s.to(x.dtype), s


def apply_block(cfg, sig: Sig, p, x, ctx):
    """One block, full-sequence mode. Returns (x, aux)."""
    kind, ffn_kind = sig
    metrics = {}
    cache = {}
    h = apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "local_attn"):
        window = cfg.window if kind == "local_attn" else 0
        y, k, v = attn_mod.attention_kv(
            cfg, p["mixer"], h, positions=ctx["positions"],
            layer_window=window, causal=ctx["causal"],
            q_chunk=ctx["q_chunk"])
        if ctx["want_cache"]:
            cache = {"k": k, "v": v}
    elif kind in RECURRENT_KINDS:
        raise _not_ported(kind)
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
            y2, moe_metrics = moe_mod.apply_moe(
                cfg, p["moe"], h2, groups=ctx.get("moe_groups", 1))
            metrics.update(moe_metrics)
        else:
            y2 = ffn_mod.apply_ffn(cfg, p["ffn"], h2)
        x = x + y2
    return x, {"metrics": metrics, "cache": cache}


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


def run_stack(cfg, layers, sigs, x, ctx):
    """Apply each layer in turn -> (x, summed metrics, per-layer caches)."""
    metrics = _zero_metrics(cfg, x.device)
    caches = []
    for sig, p in zip(sigs, layers):
        x, aux = apply_block(cfg, sig, p, x, ctx)
        metrics = _merge_metrics(metrics, aux["metrics"])
        caches.append(aux["cache"])
    return x, metrics, caches


def encode(cfg, params, src_embeds, *, q_chunk: int = 512):
    """The encoder stack over ``src_embeds`` (B, S_src, d) ->
    (encoder output in bfloat16, its positions)."""
    src = src_embeds.to(torch.bfloat16)
    bs, ss, _ = src.shape
    positions = torch.arange(ss, dtype=torch.int32,
                             device=src.device).expand(bs, ss)
    ctx = dict(positions=positions, causal=False, q_chunk=q_chunk,
               want_cache=False, enc_out=None)
    enc = params["encoder"]
    sigs = [layer_sigs(cfg, 1)[0]] * cfg.encoder_layers
    x, _, _ = run_stack(cfg, enc.layers, sigs, src, ctx)
    return apply_norm(cfg, enc["out_norm"], x), positions


def forward(cfg: ArchConfig, params, batch, *, q_chunk: int = 512,
            want_cache: bool = False, moe_groups: int = 1, enc_out=None):
    """Full-sequence forward -> (final hidden states, metrics, per-layer
    caches).  An encoder-decoder encodes ``batch["src_embeds"]`` unless
    given its ``enc_out`` (from :func:`encode`)."""
    x = embed_tokens(cfg, params, batch)
    b, s, _ = x.shape
    ctx = dict(positions=_positions_for(cfg, batch, b, s, x.device),
               causal=True, q_chunk=q_chunk, want_cache=want_cache,
               enc_out=None, moe_groups=moe_groups)
    if cfg.is_encdec:
        if enc_out is None:
            enc_out = encode(cfg, params, batch["src_embeds"],
                             q_chunk=q_chunk)
        ctx["enc_out"], ctx["enc_positions"] = enc_out
    x, metrics, caches = run_stack(cfg, params.layers,
                                   layer_sigs(cfg, len(params.layers)), x,
                                   ctx)
    x = apply_norm(cfg, params["out_norm"], x)
    return x, metrics, caches


def logits_from_hidden(cfg, params, x):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return x @ head.to(x.dtype)


def _mask_padded_vocab(cfg, logits):
    vp = logits.shape[-1]
    neg = torch.arange(vp, device=logits.device) >= cfg.vocab_size
    return torch.where(neg, attn_mod.NEG_INF, logits)


def serve_prefill(cfg: ArchConfig, params, batch, *, q_chunk: int = 512,
                  moe_groups: int = 1, enc_out=None):
    """Prefill: full forward -> (last-position logits (B, 1, V_pad), the
    padded vocab masked to ``NEG_INF``; per-layer caches)."""
    x, _, caches = forward(cfg, params, batch, q_chunk=q_chunk,
                           want_cache=True, moe_groups=moe_groups,
                           enc_out=enc_out)
    logits = logits_from_hidden(cfg, params, x[:, -1:])
    return _mask_padded_vocab(cfg, logits), caches


# ---------------------------------------------------------- decode path

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               src_len: int = 0, dtype=torch.bfloat16,
               kv_quant: bool = False, device=None) -> dict:
    """Zeroed decode cache: ``{"pos": 0, "layers": [one dict per
    layer]}``."""
    layers = []
    for kind, _ in layer_sigs(cfg):
        if kind in RECURRENT_KINDS:
            raise _not_ported(kind)
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
    cache is updated in place and its ``pos`` advanced."""
    pos = cache["pos"]
    x = params["embed"][token.long()].to(torch.bfloat16)
    s = x                           # what the next norm reads
    sigs = layer_sigs(cfg, len(params.layers))
    for (kind, ffn_kind), p, entry in zip(sigs, params.layers,
                                          cache["layers"]):
        if kind in RECURRENT_KINDS:
            raise _not_ported(kind)
        h = apply_norm(cfg, p["norm1"], s).to(x.dtype)
        window = cfg.window if kind == "local_attn" else 0
        y, _ = attn_mod.decode_attention(cfg, p["mixer"], h, entry, pos,
                                         layer_window=window)
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
