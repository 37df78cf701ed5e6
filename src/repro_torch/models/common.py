"""Shared model machinery: parameter schema, norms, rotary embeddings.

The port of ``repro.models.common``.  Parameters are described by the
same *schema tree* of :class:`ParamDef` leaves; :class:`ParamTree` turns
a schema into an ``nn.Module`` whose parameters keep the schema's leaf
names, and :func:`init_params` fills one from a ``torch.Generator`` with
the reference's recipes (zeros, ones, ``embed`` std 1, ``normal`` std
0.02, fan-in).  The values differ from the JAX package's by design: its
per-leaf keys fold an md5 of the path into a ``jax.random`` key, which
torch cannot reproduce.  Tests carry the JAX package's values across
with ``repro_torch.convert.lm_params_from_reference`` instead.

Norms run in float32 and cast back, as the reference's do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class ParamDef:
    """One parameter: shape + logical axes + init recipe."""
    shape: tuple
    axes: tuple                  # logical axis name (or None) per dim
    init: str = "fan_in"         # fan_in | zeros | ones | normal | embed
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_paths(tree, prefix=()):
    """Yield (path, leaf) for a nested dict tree of ParamDefs."""
    if is_def(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_paths(tree[k], prefix + (k,))


def abstract_params(schema):
    """The schema as a tree of tensors on the ``meta`` device (shape and
    dtype, no storage): the dry-run's parameter view."""
    def walk(node):
        if is_def(node):
            return torch.empty(node.shape, dtype=node.dtype, device="meta")
        return {k: walk(v) for k, v in node.items()}
    return walk(schema)


def schema_axes(schema):
    """Tree of logical-axis tuples mirroring the schema."""
    def walk(node):
        if is_def(node):
            return node.axes
        return {k: walk(v) for k, v in node.items()}
    return walk(schema)


def count_schema_params(schema) -> int:
    return sum(int(np.prod(d.shape)) for _, d in tree_paths(schema))


class ParamTree(nn.Module):
    """A schema subtree as a module: each ``ParamDef`` leaf an
    ``nn.Parameter``, frozen until ``requires_grad_()`` makes it a
    trainable master weight, each inner dict a child ``ParamTree``, all
    under the schema's names.  ``p["wq"]`` reads a leaf as the reference's
    functions read their parameter dicts."""

    def __init__(self, schema: dict, device=None):
        super().__init__()
        #: each leaf's init recipe, by name
        self.inits = {}
        for name, node in schema.items():
            if is_def(node):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(node.shape, dtype=node.dtype,
                                device=device), requires_grad=False))
                self.inits[name] = node.init
            else:
                self.add_module(name, ParamTree(node, device))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name, default=None):
        return self[name] if name in self else default


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every leaf of every :class:`ParamTree` under ``module`` by its
    recipe, in module order, drawing from ``generator``."""
    for tree in module.modules():
        if isinstance(tree, ParamTree):
            for name, init in tree.inits.items():
                init_leaf(tree[name], init, generator)


def init_leaf(t: torch.Tensor, init: str, generator: torch.Generator):
    """Fill one parameter by its recipe (``_materialize`` of the
    reference), drawing from ``generator``."""
    with torch.no_grad():
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        else:
            shape = tuple(t.shape)
            fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
            std = {"embed": 1.0, "normal": 0.02}.get(
                init, float(np.sqrt(1.0 / fan_in)))
            t.copy_(torch.randn(shape, generator=generator,
                                device=t.device) * std)


# ---------------------------------------------------------------- norms

def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias=None, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def norm_schema(cfg) -> dict:
    d = {"scale": ParamDef((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((cfg.d_model,), ("embed",), "zeros")
    return d


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p.get("bias"))
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def _rotate(x, ang):
    """Rotate-half by angles ``ang`` (B, S, D/2), in float32."""
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Rotate-half RoPE. x: (B, S, H, D); positions: (B, S) int."""
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, theta: float,
                sections: tuple | None = None):
    """Multimodal RoPE (Qwen2-VL): 3 position streams (t, h, w) drive
    disjoint frequency sections of the half-dim. positions3: (3, B, S)."""
    d = x.shape[-1]
    half = d // 2
    if sections is None:
        s_h = half // 4
        sections = (half - 2 * s_h, s_h, s_h)
    assert sum(sections) == half, (sections, half)
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                     # (half,)
    # the position stream of each frequency slot -> (half, B, S)
    sec_id = torch.as_tensor(np.repeat(np.arange(3), sections),
                             device=x.device)
    pos = positions3.float()[sec_id]
    return _rotate(x, torch.movedim(pos, 0, -1) * freqs)


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Internal vocab padding (logical vocab unchanged; masked in loss)."""
    return -(-v // multiple) * multiple
