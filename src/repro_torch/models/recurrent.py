"""Recurrent sequence mixers: mLSTM, sLSTM (xLSTM) and RG-LRU (Griffin /
RecurrentGemma).

The port of ``repro.models.recurrent``, function for function.

* mLSTM: matrix-memory LSTM with exponential gating, prefilled with the
  chunkwise-parallel form (quadratic within a chunk, a (C, n, m) state
  carried across chunks) and decoded with the O(1) recurrent step.  A
  sequence that is not a multiple of the chunk is padded with zeros, as
  the reference pads it: the padded ``log_i = 0`` enters the carried
  stabiliser ``m``, so the padding is kept, not sliced away.
* sLSTM: scalar-memory LSTM with recurrent weights, strictly sequential
  (one step per position, as the reference's ``lax.scan``).
* RG-LRU: elementwise gated linear recurrence, computed with
  :func:`associative_scan`, JAX's odd/even recursion written with torch
  slicing, so that every product and sum rounds in the reference's order
  (about 2·log2(S) levels of batched ops, no loop over time).

Activations are bfloat16 when served; every block computes its gates,
states and norms in float32 as the reference does, reading the leaves
in :data:`F32_LEAVES` in float32 whatever the activation dtype.
RG-LRU's decode also runs its gate products in float32, where its
prefill runs them in the activation dtype (:data:`TWO_DTYPE_LEAVES`).
Where the reference's ``a*b + c`` shares one XLA fusion, which XLA's CPU
code contracts into a fused multiply-add, the port writes
``torch.addcmul`` (one rounding as well).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef
from repro_torch.models.ffn import gelu, silu

F32 = torch.float32

#: leaves every block reads in float32, whatever the activation dtype
F32_LEAVES = frozenset({"b_if", "ln_scale", "b_gates", "r_gates", "conv_w",
                        "conv_b", "lam"})
#: leaves RG-LRU's prefill reads in the activation dtype and its decode
#: in float32 (a served compute copy holds both, the bfloat16 one under
#: the name with ``_bf16`` appended)
TWO_DTYPE_LEAVES = frozenset({"w_rec_gate", "w_in_gate"})


def _weight(p, name: str, dtype):
    """Leaf ``name`` of ``p`` in ``dtype``: a compute copy's bfloat16 twin
    where it holds one, else a cast (a no-op in the leaf's own dtype)."""
    twin = f"{name}_bf16"
    if dtype == torch.bfloat16 and twin in p:
        return p[twin]
    return p[name].to(dtype)


def _group_rms(y, heads: int, scale):
    """Per-head RMS norm over the head dim in float32, times ``scale``
    (float32): the group norm of the mLSTM and sLSTM blocks."""
    b, s, d = y.shape
    yh = y.reshape(b, s, heads, d // heads).float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-6)
    return yh.reshape(b, s, d) * scale.float()


# ================================================================= mLSTM

#: xLSTM qkv_proj_blocksize: q/k/v are block-diagonal with 4x4 blocks
#: (near-diagonal), which is what puts the 48L/2048d config at ~1.3B.
QKV_BLOCK = 4


def mlstm_schema(cfg) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    di = 2 * d                      # xLSTM mLSTM projection factor 2
    nb = di // QKV_BLOCK
    return {
        "w_in": ParamDef((d, di), ("embed", "ffn")),
        "w_gate": ParamDef((d, di), ("embed", "ffn")),
        "wq": ParamDef((nb, QKV_BLOCK, QKV_BLOCK), ("ffn", None, None)),
        "wk": ParamDef((nb, QKV_BLOCK, QKV_BLOCK), ("ffn", None, None)),
        "wv": ParamDef((nb, QKV_BLOCK, QKV_BLOCK), ("ffn", None, None)),
        "w_if": ParamDef((di, 2 * h), ("ffn", None)),   # i, f gate heads
        "b_if": ParamDef((2 * h,), (None,), "zeros"),
        "ln_scale": ParamDef((di,), ("ffn",), "ones"),
        "w_out": ParamDef((di, d), ("ffn", "embed")),
    }


def _headwise_proj(x, w):
    """Block-diagonal projection: x (..., di), w (nb, bs, bs)."""
    nb, bs, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nk,nkj->...nj", xs, w.to(x.dtype))
    return y.reshape(x.shape)


def _mlstm_gates(p, xi, h: int):
    """(log input gate, log forget gate), each (B, S, H) float32."""
    gf = (xi @ p["w_if"].to(xi.dtype)).float() + p["b_if"].float()
    return gf[..., :h], F.logsigmoid(gf[..., h:])


def _mlstm_zero_state(batch: int, h: int, k: int, device):
    return (torch.zeros((batch, h, k, k), dtype=F32, device=device),
            torch.zeros((batch, h, k), dtype=F32, device=device),
            torch.full((batch, h), -1e30, dtype=F32, device=device))


def mlstm_init_state(cfg, batch: int, device=None):
    """(C (B, H, K, K), n (B, H, K), m (B, H)), float32, ``m`` at -1e30."""
    h = cfg.num_heads
    return _mlstm_zero_state(batch, h, 2 * cfg.d_model // h, device)


def _mlstm_chunk(state, q, k, v, li, lf):
    """One chunk: q, k, v (B, W, H, K) float32, li, lf (B, W, H) ->
    (the next state, y (B, W, H, K))."""
    c0, n0, m0 = state
    w = q.shape[1]
    cf = torch.cumsum(lf, dim=1)                              # F_t (B,W,H)
    # intra-chunk decay matrix: D[t, s] = F_t - F_s + log_i_s, s <= t
    dmat = cf[:, :, None, :] - cf[:, None, :, :] + li[:, None, :, :]
    causal = torch.ones((w, w), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal[None, :, :, None], dmat, -torch.inf)
    a_inter = cf + m0[:, None, :]                   # decay of the carry
    m_t = torch.maximum(dmat.amax(dim=2), a_inter)
    m_t = torch.clamp_min(m_t, -1e30)
    dexp = torch.exp(dmat - m_t[:, :, None, :])              # (B,W,W,H)
    inter_w = torch.exp(a_inter - m_t)                       # (B,W,H)

    scores = torch.einsum("bthk,bshk->btsh", q, k) * dexp
    num_intra = torch.einsum("btsh,bshv->bthv", scores, v)
    num_inter = torch.einsum("bthk,bhkv->bthv", q, c0)
    num = torch.addcmul(num_intra, num_inter, inter_w[..., None])
    den_intra = scores.sum(dim=2)                            # (B,W,H)
    den_inter = torch.einsum("bthk,bhk->bth", q, n0)
    den = torch.addcmul(den_intra, den_inter, inter_w)
    denom = torch.maximum(den.abs(), torch.exp(-m_t))
    y = num / denom[..., None]

    # carry to the next chunk
    ftot = cf[:, -1]                                         # (B,H)
    gain = ftot[:, None] - cf + li                           # (B,W,H)
    m_next = torch.maximum(ftot + m0, gain.amax(dim=1))
    wts = torch.exp(gain - m_next[:, None])
    decay = torch.exp(ftot + m0 - m_next)
    wk = wts[..., None] * k
    c_next = torch.addcmul(torch.einsum("bwhk,bwhv->bhkv", wk, v),
                           decay[..., None, None], c0)
    n_next = torch.addcmul(wk.sum(dim=1), decay[..., None], n0)
    return (c_next, n_next, m_next), y


def mlstm_chunkwise(p, x, h: int, chunk: int = 256, state=None):
    """x: (B, S, d_in). Returns (y, final_state).

    state = (C (B,H,K,K), n (B,H,K), m (B,H)) with K = d_in // H.
    """
    b, s, di = x.shape
    k_dim = di // h
    log_i, log_f = _mlstm_gates(p, x, h)                     # (B,S,H)
    split = lambda z: z.reshape(b, s, h, k_dim)
    q = split(_headwise_proj(x, p["wq"]))
    k = split(_headwise_proj(x, p["wk"])).float()
    v = split(_headwise_proj(x, p["wv"])).float()
    # a numpy scalar in the reference, which promotes q to float32
    q = q.float() * np.float32(1.0 / np.sqrt(k_dim))
    if state is None:
        state = _mlstm_zero_state(b, h, k_dim, x.device)

    nchunks = -(-s // chunk)
    pad = nchunks * chunk - s
    if pad:
        q, k, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (q, k, v))
        log_i, log_f = (F.pad(z, (0, 0, 0, pad)) for z in (log_i, log_f))
    ys = []
    for lo in range(0, nchunks * chunk, chunk):
        cut = slice(lo, lo + chunk)
        state, y = _mlstm_chunk(state, q[:, cut], k[:, cut], v[:, cut],
                                log_i[:, cut], log_f[:, cut])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.reshape(b, s, di).to(x.dtype), state


def mlstm_decode_step(p, x, state, h: int):
    """x: (B, 1, d_in); the O(1) recurrent update (the sequential form).

    The new ``C`` is written over the outer product ``k v^T`` it adds,
    with no other copy of the state made.
    """
    b, _, di = x.shape
    k_dim = di // h
    log_i, log_f = _mlstm_gates(p, x, h)                     # (B,1,H)
    log_i, log_f = log_i[:, 0], log_f[:, 0]
    q = _headwise_proj(x, p["wq"])[:, 0]
    k = _headwise_proj(x, p["wk"])[:, 0]
    v = _headwise_proj(x, p["wv"])[:, 0]
    q = q.reshape(b, h, k_dim).float() * np.float32(1.0 / np.sqrt(k_dim))
    k = k.reshape(b, h, k_dim).float()
    v = v.reshape(b, h, k_dim).float()
    c0, n0, m0 = state
    carried = log_f + m0
    m1 = torch.maximum(carried, log_i)
    fw = torch.exp(carried - m1)
    iw = torch.exp(log_i - m1)
    c = k[..., :, None] * v[..., None, :]
    c.mul_(iw[..., None, None]).addcmul_(fw[..., None, None], c0)
    n = torch.addcmul(iw[..., None] * k, fw[..., None], n0)
    num = torch.einsum("bhk,bhkv->bhv", q, c)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m1))
    y = (num / den[..., None]).reshape(b, 1, di)
    return y.to(x.dtype), (c, n, m1)


def mlstm_block(cfg, p, x, *, chunk: int = 256, state=None,
                decode: bool = False):
    """Full mLSTM block: up-proj, mixer, gate, down-proj."""
    xi = x @ p["w_in"].to(x.dtype)
    gate = x @ p["w_gate"].to(x.dtype)
    if decode:
        y, state = mlstm_decode_step(p, xi, state, cfg.num_heads)
    else:
        y, state = mlstm_chunkwise(p, xi, cfg.num_heads, chunk, state)
    y = _group_rms(y, cfg.num_heads, p["ln_scale"])
    y = y.to(x.dtype) * silu(gate)
    return y @ p["w_out"].to(y.dtype), state


# ================================================================= sLSTM

def slstm_schema(cfg) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    return {
        "w_gates": ParamDef((d, 4 * d), ("embed", "ffn")),   # z, i, f, o
        "r_gates": ParamDef((h, hd, 4 * hd), ("heads", None, None)),
        "b_gates": ParamDef((4 * d,), ("ffn",), "zeros"),
        "ln_scale": ParamDef((d,), ("embed",), "ones"),
        "w_up": ParamDef((d, 4 * d // 3), ("embed", "ffn")),
        "w_up_gate": ParamDef((d, 4 * d // 3), ("embed", "ffn")),
        "w_down": ParamDef((4 * d // 3, d), ("ffn", "embed")),
    }


def slstm_init_state(cfg, batch: int, device=None):
    """(c, n, h, m), each (B, H, hd) float32: ``n`` at 1e-6, ``m`` at
    -1e30, ``c`` and ``h`` zero (separate tensors)."""
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    return (torch.zeros(shape, dtype=F32, device=device),
            torch.full(shape, 1e-6, dtype=F32, device=device),
            torch.zeros(shape, dtype=F32, device=device),
            torch.full(shape, -1e30, dtype=F32, device=device))


def slstm_scan(cfg, p, x, state=None):
    """Strictly sequential sLSTM over time. x: (B, S, d)."""
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    wx = (x @ p["w_gates"].to(x.dtype)).float() + p["b_gates"].float()
    wx = wx.reshape(b, s, h, 4 * hd)
    if state is None:
        state = slstm_init_state(cfg, b, device=x.device)
    r = p["r_gates"].float()                                 # (H,hd,4hd)
    c, n, hprev, m = state
    ys = []
    for t in range(s):
        rec = torch.bmm(hprev.transpose(0, 1), r).transpose(0, 1)
        g = wx[:, t] + rec                                   # (B,H,4hd)
        z = torch.tanh(g[..., :hd])
        log_i = g[..., hd:2 * hd]
        log_f = F.logsigmoid(g[..., 2 * hd:3 * hd])
        o = torch.sigmoid(g[..., 3 * hd:])
        carried = log_f + m
        m1 = torch.maximum(carried, log_i)
        fw, iw = torch.exp(carried - m1), torch.exp(log_i - m1)
        c = torch.addcmul(iw * z, fw, c)
        n = torch.maximum(torch.addcmul(iw, fw, n), torch.exp(-m1))
        hprev = o * c / n
        m = m1
        ys.append(hprev)
    y = torch.stack(ys, dim=1).reshape(b, s, d).to(x.dtype)
    return y, (c, n, hprev, m)


def slstm_block(cfg, p, x, *, state=None):
    """sLSTM mixer, group norm, then its gated up/down projection (the
    decode step is this block over one position)."""
    y, state = slstm_scan(cfg, p, x, state)
    y = _group_rms(y, cfg.num_heads, p["ln_scale"]).to(x.dtype)
    up = y @ p["w_up"].to(y.dtype)
    gate = y @ p["w_up_gate"].to(y.dtype)
    return (gelu(gate) * up) @ p["w_down"].to(up.dtype), state


# ================================================================= RG-LRU

def rglru_schema(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width
    cw = cfg.conv1d_width
    return {
        "w_x": ParamDef((d, w), ("embed", "lru")),
        "w_gate_branch": ParamDef((d, w), ("embed", "lru")),
        "conv_w": ParamDef((cw, w), (None, "lru"), "normal"),
        "conv_b": ParamDef((w,), ("lru",), "zeros"),
        "w_rec_gate": ParamDef((w, w), ("lru", "lru")),
        "w_in_gate": ParamDef((w, w), ("lru", "lru")),
        "lam": ParamDef((w,), ("lru",), "normal"),
        "w_out": ParamDef((w, d), ("lru", "embed")),
    }


_C_RGLRU = 8.0


def rglru_init_state(cfg, batch: int, device=None):
    """(conv buffer (B, conv1d_width - 1, W), h (B, W)), float32 zeros."""
    return (torch.zeros((batch, cfg.conv1d_width - 1, cfg.lru_width),
                        dtype=F32, device=device),
            torch.zeros((batch, cfg.lru_width), dtype=F32, device=device))


def _combine(x, y):
    """The linear recurrence's operator: (a1, b1) then (a2, b2).  XLA's
    CPU backend fuses ``a2 * b1 + b2`` into one fused multiply-add, which
    ``torch.addcmul`` is on the CPU too (it rounds once)."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, torch.addcmul(b2, a2, b1)


def _interleave(even, odd):
    """even[0], odd[0], even[1], … along dim 1 (``len(even)`` is
    ``len(odd)`` or one more)."""
    ne, no = even.shape[1], odd.shape[1]
    out = even.new_empty((even.shape[0], ne + no) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(elems):
    """Inclusive scan of the pair ``elems`` = (a, b), each (B, S, …), along
    dim 1 under :func:`_combine`: ``jax.lax.associative_scan``'s odd/even
    recursion (combine adjacent pairs, scan those, combine the results
    with elements ``2::2``, prepend the first element and interleave),
    so that every product and sum rounds as the reference's do."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = associative_scan(_combine([e[:, 0:-1:2] for e in elems],
                                    [e[:, 1::2] for e in elems]))
    later = [e[:, 2::2] for e in elems]
    even = _combine([e[:, :-1] for e in odd] if n % 2 == 0 else odd, later)
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _log_a(p, r):
    """log a_t = c · r_t · log sigmoid(lam), float32."""
    return _C_RGLRU * r * F.logsigmoid(p["lam"].float())


def _rglru_core(p, u, h0=None):
    """u: (B, S, W) post-conv activations; gated linear recurrence ->
    (h in u's dtype, the last h in float32)."""
    r = torch.sigmoid((u @ _weight(p, "w_rec_gate", u.dtype)).float())
    i = torch.sigmoid((u @ _weight(p, "w_in_gate", u.dtype)).float())
    log_a = _log_a(p, r)                                     # (B,S,W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12))
    b_t = gated * i * u.float()
    if h0 is not None:
        # fold the carried state into the first step
        b_t[:, 0] += a[:, 0] * h0
    _, h = associative_scan((a, b_t))
    return h.to(u.dtype), h[:, -1].float()


def rglru_block(cfg, p, x, *, state=None, decode: bool = False):
    """Griffin recurrent block: proj -> causal conv -> RG-LRU -> gate."""
    u = x @ p["w_x"].to(x.dtype)
    gate = gelu(x @ p["w_gate_branch"].to(x.dtype))
    cw = cfg.conv1d_width
    if decode:
        conv_buf, h0 = state                       # (B, cw-1, W), (B, W)
        seq = torch.cat([conv_buf, u.to(conv_buf.dtype)], dim=1)
        conv_in = seq[:, -cw:]                     # (B, cw, W)
        u_c = torch.einsum("bcw,cw->bw", conv_in,
                           p["conv_w"].to(conv_in.dtype))
        u_c = u_c + p["conv_b"].to(u_c.dtype)      # (B, W), float32
        r = torch.sigmoid(u_c @ _weight(p, "w_rec_gate", u_c.dtype))
        i = torch.sigmoid(u_c @ _weight(p, "w_in_gate", u_c.dtype))
        log_a = _log_a(p, r)
        a = torch.exp(log_a)
        gmul = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12))
        h1 = torch.addcmul(gmul * i * u_c, a, h0)
        y = h1[:, None].to(x.dtype)
        new_state = (seq[:, -(cw - 1):], h1)
    else:
        # causal depthwise conv via static shifts (width is tiny)
        s = u.shape[1]
        acc = torch.zeros(u.shape, dtype=F32, device=u.device)
        for j in range(cw):
            shifted = F.pad(u, (0, 0, cw - 1 - j, 0))[:, :s]
            acc = torch.addcmul(acc, shifted.float(), p["conv_w"][j].float())
        u_c = (acc + p["conv_b"].float()).to(x.dtype)
        h0 = state[1] if state is not None else None
        y, h_last = _rglru_core(p, u_c, h0)
        buf_src = F.pad(u, (0, 0, cw - 1, 0))
        new_state = (buf_src[:, -(cw - 1):].float(), h_last)
    out = (y * gate.to(y.dtype)) @ p["w_out"].to(y.dtype)
    return out, new_state
