"""Optimizers as plain functions on tensors (no ``torch.optim``): AdamW
and Lion, global-norm clipping, cosine schedule with warmup.

The port of ``repro.train.optimizer``, in the reference's arithmetic
order (``torch.optim.AdamW`` orders its weight decay and bias
correction differently).  Moments are float32 and ``step`` is an int32
scalar tensor; the schedule is computed in float32.  Where the
reference's compiled CPU program contracts ``a*b + c`` into one fused
multiply-add, the port writes ``torch.addcmul`` (one rounding too).

A *tree* is a dict of tensors, nested or not, or an ``nn.Module`` (its
named parameters).  Leaves are visited in the reference's order: a
dict's keys sorted, as JAX flattens them (:func:`tree_leaves`).  The
moments of a module are flat dicts keyed by its parameter names.  Every
leaf is updated in place under ``torch.no_grad()``; the returned trees
are the ones given.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    kind: str = "adamw"            # adamw | lion


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs of ``tree`` in the reference's leaf order:
    a dict's keys sorted, nested keys joined by ``.``; a module's named
    parameters sorted by name."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], f"{prefix}{k}."))
        return out
    return [(prefix[:-1], tree)]


def tree_zeros(tree) -> dict:
    """Float32 zeros shaped as each leaf: a nested dict as ``tree``, or
    for a module a flat dict keyed by parameter names."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: tree_zeros(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0][1].device


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int), float32:
    linear warmup, then a cosine decay to ``min_lr_ratio · lr``.

    Written as the reference's compiled program computes it: XLA divides
    by a constant as a multiply by its float32 reciprocal, folds
    ``(1 - floor) · 0.5`` into one constant and contracts the last sum
    into a fused multiply-add.  Its ``cos`` rounds apart from torch's by
    up to an ulp, which ``1 + cos`` near the end of the decay enlarges.
    """
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = torch.clamp(step * (1 / _f32(max(cfg.warmup_steps, 1), dev)),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) * (1 / _f32(
        max(cfg.total_steps - cfg.warmup_steps, 1), dev)), 0.0, 1.0)
    cos = torch.cos(torch.pi * t)
    floor = cfg.min_lr_ratio
    inner = torch.addcmul(_f32(floor, dev), cos + 1,
                          _f32(0.5, dev) * _f32(1 - floor, dev))
    return cfg.lr * warm * inner


def init_state(params) -> dict:
    """``{"mu", "nu"}`` float32 zeros shaped as ``params`` and ``step``,
    an int32 zero, on ``params``' device."""
    return {"mu": tree_zeros(params), "nu": tree_zeros(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in :func:`tree_leaves` order) of each
    leaf's float32 sum of squares."""
    total = None
    for _, g in tree_leaves(tree):
        sq = torch.sum(g.float() ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_update(cfg: OptConfig, params, grads, state):
    """One optimizer step -> (params, state, metrics), ``params`` and the
    moments updated in place, ``state["step"]`` advanced.  ``grads``
    holds a leaf for each of ``params``' under its path; metrics are the
    pre-clip ``grad_norm`` and the step's ``lr``."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    g_of = dict(tree_leaves(grads))
    mu_of = dict(tree_leaves(state["mu"]))
    nu_of = dict(tree_leaves(state["nu"]))
    b1, b2, wd = (_f32(x, step.device) for x in (cfg.b1, cfg.b2,
                                                  cfg.weight_decay))

    if cfg.kind == "lion":
        for name, p in tree_leaves(params):
            g = g_of[name].float() * scale
            mu = mu_of[name]
            d = torch.sign(torch.addcmul((1 - cfg.b1) * g, mu, b1))
            _decay_step(p, d, wd, lr)
            mu.copy_(torch.addcmul((1 - cfg.b2) * g, mu, b2))
        return params, dict(state, step=step), {"grad_norm": gnorm,
                                                "lr": lr}

    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, stepf), 1 - torch.pow(b2, stepf)
    for name, p in tree_leaves(params):
        g = g_of[name].float() * scale
        mu, nu = mu_of[name], nu_of[name]
        mu.copy_(torch.addcmul((1 - cfg.b1) * g, mu, b1))
        nu.copy_(torch.addcmul((1 - cfg.b2) * g * g, nu, b2))
        # (mu / bc1) / (sqrt(nu / bc2) + eps), as XLA rewrites it
        _decay_step(p, mu / (bc1 * (torch.sqrt(nu / bc2) + cfg.eps)), wd,
                    lr)
    return params, dict(state, step=step), {"grad_norm": gnorm, "lr": lr}


def _decay_step(p, upd, wd, lr) -> None:
    """p <- p - lr · (upd + wd · p), in float32, both sums fused
    multiply-adds as in the reference's compiled program."""
    p32 = p.float()
    p.copy_(torch.addcmul(p32, torch.addcmul(upd, p32, wd), lr, value=-1))


def _f32(x: float, device=None) -> torch.Tensor:
    """``x`` as a float32 scalar tensor: an operand of ``addcmul``, which
    rounds the product and the sum once."""
    return torch.tensor(x, dtype=torch.float32, device=device)
