"""GQA attention: RoPE/M-RoPE, QKV bias, local windows, chunked compute,
KV-cache decode.

The port of ``repro.models.attention``, with the same einsum / softmax
structure: scores computed in the activation dtype, scaled and masked
(with the finite ``NEG_INF``) in float32, softmax in float32 and the
probabilities cast back.  No fused attention
operator is used, since one would round elsewhere than the reference.
The scale is a numpy scalar in the reference, which promotes the scores
to float32 before the mask; the port scales in float32 too.
Prefill attention runs in query chunks of ``q_chunk``; a local layer's
chunk sees only its static key slice ``[hi - q_chunk - window + 1, hi)``.

A decode step writes its new key and value into the cache *in place*
(the reference returns an updated copy); the returned cache is the same
dict.  A write past a full cache's capacity raises ``IndexError`` where
the reference's ``dynamic_update_slice`` would clamp to the last slot.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ParamDef, apply_mrope, apply_rope

NEG_INF = -2.0e38


def attn_schema(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    s = {
        "wq": ParamDef((d, hq, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((hq, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((hq, hd), ("heads", "head_dim"), "zeros")
        s["bk"] = ParamDef((hkv, hd), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamDef((hkv, hd), ("kv_heads", "head_dim"), "zeros")
    return s


def _proj(x, w, b=None):
    """einsum("bsd,dhk->bshk") as one matmul over d, plus the bias."""
    d, h, k = w.shape
    y = (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))
    return y if b is None else y + b.to(y.dtype)


def _project_qkv(cfg, p, xq, xkv):
    q = _proj(xq, p["wq"], p["bq"] if cfg.qkv_bias else None)
    k = _proj(xkv, p["wk"], p["bk"] if cfg.qkv_bias else None)
    v = _proj(xkv, p["wv"], p["bv"] if cfg.qkv_bias else None)
    return q, k, v


def _out_proj(o, wo):
    """einsum("bshk,hkd->bsd") as one matmul over h·k."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * k, d)


def _rope(cfg, x, positions):
    if cfg.rope_variant == "none" or positions is None:
        return x
    if cfg.rope_variant == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def _iota_mask(lo: int, hi: int, k_lo: int, k_hi: int, causal: bool,
               window: int = 0, device=None):
    """(hi - lo, k_hi - k_lo) bool mask of query rows lo..hi against key
    columns k_lo..k_hi."""
    qpos = torch.arange(lo, hi, device=device)[:, None]
    kpos = torch.arange(k_lo, k_hi, device=device)[None, :]
    if not causal:
        return torch.ones((hi - lo, k_hi - k_lo), dtype=torch.bool,
                          device=device)
    m = kpos <= qpos
    if window:
        m = m & (kpos > qpos - window)
    return m


def _softmax_attend(qc, k, v, m, scale):
    """One query chunk: qc (B, q, Hkv, G, D) against k, v (B, s, Hkv, D)
    under mask m (q, s) -> (B, q, Hkv, G, D)."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", qc, k).float() * scale
    scores = torch.where(m, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


def _chunked_scores_softmax(q, k, v, causal: bool, q_chunk: int):
    """Unrolled-chunk softmax attention.

    q: (B, Sq, Hkv, G, D); k, v: (B, Skv, Hkv, D).
    """
    sq, skv, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    outs = []
    for lo in range(0, sq, q_chunk):
        hi = min(lo + q_chunk, sq)
        m = _iota_mask(lo, hi, 0, skv, causal, device=q.device)
        outs.append(_softmax_attend(q[:, lo:hi], k, v, m, scale))
    return torch.cat(outs, dim=1)


def _local_chunked(q, k, v, window: int, q_chunk: int):
    """Banded local attention: each q chunk sees a static key slice of
    length (window + chunk); compute is O(S·window), not O(S²)."""
    sq, d = q.shape[1], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    outs = []
    for lo in range(0, sq, q_chunk):
        hi = min(lo + q_chunk, sq)
        k_lo = max(0, hi - q_chunk - window + 1)
        m = _iota_mask(lo, hi, k_lo, hi, True, window, device=q.device)
        outs.append(_softmax_attend(q[:, lo:hi], k[:, k_lo:hi],
                                    v[:, k_lo:hi], m, scale))
    return torch.cat(outs, dim=1)


def attention_kv(cfg, p, x, *, positions=None, layer_window: int = 0,
                 causal: bool = True, xkv=None, q_chunk: int = 512,
                 kv_positions=None):
    """:func:`attention`, also returning the (roped) keys and values it
    attended to: the prefill's cache entry, which the reference computes
    a second time from the same inputs."""
    b, s, _ = x.shape
    self_attn = xkv is None
    xkv = x if self_attn else xkv
    q, k, v = _project_qkv(cfg, p, x, xkv)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, kv_positions if kv_positions is not None else
              (positions if self_attn else None))
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    qg = q.reshape(b, s, hkv, g, cfg.head_dim)

    if layer_window and causal:
        o = _local_chunked(qg, k, v, layer_window, min(q_chunk, s))
    else:
        o = _chunked_scores_softmax(qg, k, v, causal, min(q_chunk, s))
    o = o.reshape(b, s, cfg.num_heads, cfg.head_dim)
    return _out_proj(o, p["wo"]), k, v


def attention(cfg, p, x, *, positions=None, layer_window: int = 0,
              causal: bool = True, xkv=None, q_chunk: int = 512,
              kv_positions=None):
    """Full-sequence (train / prefill / encoder) attention."""
    return attention_kv(cfg, p, x, positions=positions,
                        layer_window=layer_window, causal=causal, xkv=xkv,
                        q_chunk=q_chunk, kv_positions=kv_positions)[0]


def init_kv_cache(cfg, batch: int, seq_len: int, layer_window: int,
                  dtype=torch.bfloat16, kv_quant: bool = False,
                  device=None) -> dict:
    """Zeroed KV cache for one attention layer.

    Local-attention layers keep only a ring buffer of ``window`` keys.
    ``kv_quant`` stores K/V as int8 with per-(position, head) float32
    scales.
    """
    s = min(seq_len, layer_window) if layer_window else seq_len
    shp = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    if kv_quant:
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shp[:3], device=device),
                "v_scale": torch.zeros(shp[:3], device=device)}
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _quantize_kv(x):
    """(B, 1, H, D) -> int8 values + (B, 1, H) scale."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _decode_rope(cfg, x, pos: int):
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.rope_variant == "mrope":
        posv = posv.expand(3, b, 1)
    return _rope(cfg, x, posv)


def decode_attention(cfg, p, x, cache, pos: int, *, layer_window: int = 0,
                     cross_kv=None):
    """Single-token decode. x: (B, 1, d). cache: {"k","v"} (B, S, Hkv, D)
    (int8 with ``k_scale``/``v_scale`` when quantized), written in place
    at slot ``pos`` (``pos % S`` for a local layer's ring).

    Returns (out, cache).  With ``cross_kv`` the query attends to the
    encoder's keys and values (no rope on either, as in the reference)
    and the cache is returned untouched.
    """
    b = x.shape[0]
    if cross_kv is not None:
        k, v = cross_kv["k"], cross_kv["v"]
        q = _proj(x, p["wq"], p["bq"] if cfg.qkv_bias else None)
        valid = torch.ones(k.shape[1], dtype=torch.bool, device=x.device)
    else:
        q, k_new, v_new = _project_qkv(cfg, p, x, x)
        q = _decode_rope(cfg, q, pos)
        k_new = _decode_rope(cfg, k_new, pos)
        s_cache = cache["k"].shape[1]
        slot = pos % s_cache if layer_window else pos
        if cache["k"].dtype == torch.int8:
            kq, ks = _quantize_kv(k_new)
            vq, vs = _quantize_kv(v_new)
            cache["k"][:, slot] = kq[:, 0]
            cache["v"][:, slot] = vq[:, 0]
            cache["k_scale"][:, slot] = ks[:, 0]
            cache["v_scale"][:, slot] = vs[:, 0]
            k = (cache["k"].float()
                 * cache["k_scale"][..., None]).to(x.dtype)
            v = (cache["v"].float()
                 * cache["v_scale"][..., None]).to(x.dtype)
        else:
            cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
        idx = torch.arange(s_cache, device=x.device)
        if layer_window and pos >= s_cache:              # ring buffer full
            valid = torch.ones(s_cache, dtype=torch.bool, device=x.device)
        else:
            valid = idx <= slot
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    q = q.reshape(b, 1, hkv, g, cfg.head_dim)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q,
                          k.to(q.dtype)).float() * scale
    scores = torch.where(valid, scores, NEG_INF)
    pr = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr, v.to(x.dtype))
    o = o.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    return _out_proj(o, p["wo"]), cache
