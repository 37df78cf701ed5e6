"""Dense FFN variants: SwiGLU / GeGLU / GELU / squared-ReLU.

The port of ``repro.models.ffn``.  The activations are ``jax.nn``'s,
written out op by op: ``jax.nn.gelu`` is the tanh approximation, and in
bfloat16 XLA rounds after every op of it and of ``silu``'s expanded
logistic (constants rounded to bfloat16 too), where
``F.gelu(approximate="tanh")`` and ``F.silu`` compute in float32 and
round once.  An eager torch op on
bfloat16 tensors rounds its result as XLA does, so the same ops in the
same order give the reference's numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ParamDef

GATED = {"swiglu", "geglu"}


def _const(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a weakly typed JAX scalar is."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x):
    """``jax.nn.gelu(x)`` (approximate: the tanh form), op by op."""
    k = _const(np.sqrt(2 / np.pi), x.dtype)
    c = _const(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(k * (x + c * (x * x * x))))
    return x * cdf


def silu(x):
    """``jax.nn.silu(x)``: x times its logistic, which XLA expands to
    1 / (1 + exp(-x)), each op rounding."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def ffn_schema(cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    s = {
        "w_up": ParamDef((d, f), ("embed", "ffn")),
        "w_down": ParamDef((f, d), ("ffn", "embed")),
    }
    if cfg.ffn_activation in GATED:
        s["w_gate"] = ParamDef((d, f), ("embed", "ffn"))
    return s


def activate(act: str, up, gate=None):
    """The hidden activation of one FFN: ``act`` of ``gate`` times ``up``
    for the gated kinds, of ``up`` alone for the others."""
    if act == "swiglu":
        return silu(gate) * up
    if act == "geglu":
        return gelu(gate) * up
    if act == "gelu":
        return gelu(up)
    if act == "sq_relu":
        r = torch.relu(up)
        return r * r
    raise ValueError(f"unknown activation {act}")


def apply_ffn(cfg, p, x):
    up = x @ p["w_up"].to(x.dtype)
    gate = (x @ p["w_gate"].to(x.dtype)
            if cfg.ffn_activation in GATED else None)
    h = activate(cfg.ffn_activation, up, gate)
    return h @ p["w_down"].to(h.dtype)
