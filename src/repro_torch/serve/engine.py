"""Batched serving engine: prefill + decode with KV-cache management.

The port of ``repro.serve.engine``: a prefill, a conversion of its caches
to the decode layout (local-attention layers into ring buffers, an
encoder-decoder's cross K/V projected once from the encoder output, a
recurrent block's state carried over), and greedy / temperature
sampling, all in eager torch on one device.

Differences by design from the reference:

* ``generate`` raises ``ValueError`` before the first decode step when
  ``P + max_new_tokens`` exceeds ``max_seq_len``; the reference's
  ``dynamic_update_slice`` would clamp and overwrite the last cache slot.
* Sampling at a temperature draws from a ``torch.Generator`` seeded per
  call (``torch.multinomial``), which cannot give ``jax.random``'s draws;
  greedy decoding (``argmax``) is the part held to the reference.
* The engine computes with a copy of the weights made once, each leaf
  in the dtype the forward reads it in (bfloat16 matrices; norms and the
  recurrent blocks' float32 leaves in float32; ``compute_copy``), the
  numbers the reference gets by casting each weight at use.
* On the card the engine turns off cuBLAS's reduced-precision bfloat16
  reduction (``allow_bf16_reduced_precision_reduction``, process-wide), so
  products accumulate in float32 as XLA's do.
* An encoder-decoder's encoder runs once per request, its output feeding
  both the prefill and the cross K/V (the reference runs it twice).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models.attention import _proj
from repro_torch.models.model import (
    STATE_KEYS, compute_copy, decode_step, encode, layer_sigs,
    serve_prefill)


def _ring_place(k, capacity: int):
    """Map prefill K/V (B, P, ...) into a ring buffer of ``capacity``."""
    b, p = k.shape[0], k.shape[1]
    if p <= capacity:
        return torch.cat([k, k.new_zeros((b, capacity - p) + k.shape[2:])],
                         dim=1)
    # slot j holds position P - capacity + ((j - P) mod capacity)
    j = np.arange(capacity)
    pos = p - capacity + ((j - p) % capacity)
    return k[:, torch.as_tensor(pos, device=k.device)]


def prefill_to_decode_cache(cfg: ArchConfig, caches, prefill_len: int,
                            capacity: int, enc_out=None, params=None):
    """Convert ``serve_prefill``'s per-layer caches into the
    ``decode_step`` layout: ``{"pos": prefill_len, "layers": [...]}``,
    each attention buffer a fresh bfloat16 tensor the decode may write in
    place (a local-attention layer's placed in a ring of ``min(capacity,
    window)`` slots), each recurrent state carried over under its names
    (``model.STATE_KEYS``; the decode replaces them with the next
    states, writing none in place).  An encoder-decoder's entries also get
    ``cross_k``/``cross_v``, projected from ``enc_out`` with ``params``'
    cross-attention weights.
    """
    layers = []
    for i, ((kind, _), entry) in enumerate(
            zip(layer_sigs(cfg, len(caches)), caches)):
        if kind in STATE_KEYS:
            layers.append(dict(zip(STATE_KEYS[kind], entry["state"])))
            continue
        window = cfg.window if kind == "local_attn" else 0
        cap = min(capacity, window) if window else capacity
        new = {"k": _ring_place(entry["k"].to(torch.bfloat16), cap),
               "v": _ring_place(entry["v"].to(torch.bfloat16), cap)}
        if cfg.is_encdec:
            p = params.layers[i]["cross_attn"]
            new["cross_k"] = _proj(enc_out, p["wk"], p["bk"] if cfg.qkv_bias
                                   else None).to(torch.bfloat16)
            new["cross_v"] = _proj(enc_out, p["wv"], p["bv"] if cfg.qkv_bias
                                   else None).to(torch.bfloat16)
        layers.append(new)
    return {"pos": prefill_len, "layers": layers}


def teacher_forced_logits(cfg: ArchConfig, weights, batch: dict, tokens,
                          *, capacity: int, q_chunk: int = 64) -> list:
    """Prefill ``batch`` and decode ``tokens`` (B, T) one step at a time,
    whatever the model would have picked: the prefill's next-token logits
    and each step's, each (B, V_pad).  An encoder-decoder's batch holds
    ``src_embeds``."""
    with torch.inference_mode():
        enc = (encode(cfg, weights, batch["src_embeds"], q_chunk=q_chunk)
               if cfg.is_encdec else None)
        logits, caches = serve_prefill(cfg, weights, batch, q_chunk=q_chunk,
                                       enc_out=enc)
        cache = prefill_to_decode_cache(
            cfg, caches, batch["tokens"].shape[1], capacity,
            enc_out=None if enc is None else enc[0], params=weights)
        out = [logits[:, -1]]
        for t in range(tokens.shape[1]):
            logits, cache = decode_step(cfg, weights, tokens[:, t:t + 1],
                                        cache)
            out.append(logits[:, -1])
    return out


class _Clock:
    """Marks on the device's timeline (CUDA events) or the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, start, end) -> float:
        if self.cuda:
            end.synchronize()
            return start.elapsed_time(end)
        return (end - start) * 1e3


class ServeEngine:
    """Serve one model on one device.

    ``device=None`` is the card and raises without one; tests pass
    ``device="cpu"``.  ``params`` (a ``LanguageModel``, on any device)
    is copied once to the device in bfloat16.  After each ``generate``,
    ``timing`` holds the prefill's and the decode loop's milliseconds
    (device time between CUDA events on the card) and the decode steps.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_seq_len: int = 256,
                 q_chunk: int = 64, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # bfloat16 products accumulate in float32 with no reduced-
            # precision step, as XLA's do (a process-wide cuBLAS setting)
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.cfg = cfg
        self.weights = compute_copy(params, device=self.device)
        self.max_seq_len = max_seq_len
        self.q_chunk = q_chunk
        self.timing: dict = {}

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 src_embeds: np.ndarray | None = None,
                 vision_embeds: np.ndarray | None = None,
                 vision_mask: np.ndarray | None = None,
                 positions3: np.ndarray | None = None) -> np.ndarray:
        """tokens: (B, P) prompt ids -> (B, P + max_new_tokens) int32.

        An encoder-decoder needs ``src_embeds`` (B, S_src, d).  A
        vision-language model merges ``vision_embeds`` where
        ``vision_mask`` is set and takes M-RoPE ``positions3`` (3, B, P);
        without them no position is vision and the positions count up,
        as the reference's engine always has it.
        """
        cfg, w = self.cfg, self.weights
        b, p = tokens.shape
        if p + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {p} + {max_new_tokens} new tokens exceed the "
                f"cache's max_seq_len {self.max_seq_len}")
        clock = _Clock(self.device)
        with torch.inference_mode():
            toks = self._tensor(tokens, torch.int64)
            batch = {"tokens": toks}
            if cfg.modality == "vlm":
                batch["vision_mask"] = (
                    torch.zeros((b, p), dtype=torch.bool, device=self.device)
                    if vision_mask is None
                    else self._tensor(vision_mask, torch.bool))
                batch["vision_embeds"] = (
                    torch.zeros((b, p, cfg.d_model), dtype=torch.bfloat16,
                                device=self.device) if vision_embeds is None
                    else self._tensor(vision_embeds, torch.bfloat16))
                batch["positions3"] = (
                    torch.arange(p, device=self.device).expand(3, b, p)
                    if positions3 is None
                    else self._tensor(positions3, torch.int32))
            t0 = clock.mark()
            with torch.profiler.record_function("serve.prefill"):
                enc = None
                if cfg.is_encdec:
                    if src_embeds is None:
                        raise ValueError(f"{cfg.name} needs src_embeds")
                    enc = encode(cfg, w, self._tensor(src_embeds,
                                                      torch.bfloat16),
                                 q_chunk=self.q_chunk)
                logits, caches = serve_prefill(cfg, w, batch,
                                               q_chunk=self.q_chunk,
                                               enc_out=enc)
                cache = prefill_to_decode_cache(
                    cfg, caches, p, self.max_seq_len,
                    enc_out=None if enc is None else enc[0], params=w)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            out = [toks]
            tok = self._sample(logits[:, -1], temperature, gen)
            t1 = clock.mark()
            for _ in range(max_new_tokens):
                out.append(tok)
                with torch.profiler.record_function("serve.decode"):
                    logits, cache = decode_step(cfg, w, tok, cache)
                tok = self._sample(logits[:, -1], temperature, gen)
            t2 = clock.mark()
            result = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        self.timing = dict(prefill_ms=clock.ms(t0, t1),
                           decode_ms=clock.ms(t1, t2),
                           decode_steps=max_new_tokens)
        return result

    @staticmethod
    def _sample(logits, temperature: float, generator) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
