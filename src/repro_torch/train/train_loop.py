"""Train-step construction: loss + grad + optimizer, sharding-aware.

The port of ``repro.train.train_loop.build_train_step``: it returns the
step function with the placements of the parameters and the optimizer
state on ``mesh`` and the abstract state (``meta`` tensors), as the
reference returns its sharding trees and ``ShapeDtypeStruct``s.  The
placements and abstract state are in the reference's grouped tree
layout (``g{i}.b{j}``, stacked over each group's repeats), which is what
the rules are written for and what a dry run reads.

The step itself runs in one process: gradients come from
``torch.autograd.grad`` over the float32 master leaves of a trainable
``LanguageModel`` (``make_params(..., trainable=True)``) on one device,
and the optimizer updates those leaves in place.  The activation and
MoE sharders are constraints that check and return their tensors; with
``moe_impl="shard_map"`` the MoE layers run over the logical devices of
``mesh`` (``models.moe_shard.make_sharded_moe``), which must then be
concrete.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import Mesh
from repro_torch.models.model import (
    loss_fn, make_abstract_params, params_axes)
from repro_torch.parallel.sharding import (
    Placement, batch_axes, make_activation_sharder, moe_dispatch_plan,
    spec_for_axes, tree_shardings)
from repro_torch.train.optimizer import (
    OptConfig, apply_update, init_state, tree_leaves)

#: the loss function's metrics a step reports beside ``loss``
STEP_METRICS = ("nll", "moe_aux_loss", "dropped_tokens")


def build_train_step(cfg: ArchConfig, mesh: Mesh | None, shape: ShapeSpec,
                     opt_cfg: OptConfig | None = None, *,
                     q_chunk: int = 512, rec_chunk: int = 256,
                     remat: bool = True, grad_accum: int = 1,
                     seq_shard: bool = True, num_layers: int | None = None,
                     rules=None, scan_layers: bool = True,
                     rec_unroll: bool = False, moe_impl: str = "gspmd",
                     moe_capacity_factor: float = 1.25):
    """Returns ``(train_step, shardings, abstract_state)``.

    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``params`` a trainable ``LanguageModel`` of
    ``num_layers`` layers (the config's when ``None``) updated in place.
    ``mesh=None`` is a (1, 1) mesh over (data, model) with no devices.
    ``shape`` is the batch's ``ShapeSpec``, which the sharders read.
    With ``grad_accum > 1`` the batch splits along its first axis into
    that many micro-batches, which must divide it; their float32
    gradients are summed and divided, the loss is their mean, and the
    metrics hold no ``nll``, as the reference's.  Metrics are ``loss``,
    ``grad_norm``, ``lr`` and those of :data:`STEP_METRICS` the loss
    reports, each a detached tensor.

    ``shardings`` is ``{"params": placements, "opt": {"mu", "nu",
    "step"}}`` (the moments share the parameters' placements; ``step`` is
    replicated); ``abstract_state`` is ``{"params", "opt"}`` as ``meta``
    tensors.  ``moe_impl`` is ``"gspmd"`` (``apply_moe`` with
    ``moe_dispatch_plan``'s groups and sharders, at its default capacity)
    or ``"shard_map"`` (``make_sharded_moe`` at
    ``moe_capacity_factor``).  ``scan_layers`` and ``rec_unroll`` are the
    reference's compile choices and change no value.
    """
    opt_cfg = opt_cfg or OptConfig()
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if moe_impl not in ("gspmd", "shard_map"):
        raise ValueError(f"moe_impl must be 'gspmd' or 'shard_map', got "
                         f"{moe_impl!r}")
    if mesh is None:
        mesh = Mesh((1, 1), ("data", "model"))
    sharder = make_activation_sharder(
        mesh, shape.global_batch, shape.seq_len, seq_shard=seq_shard)
    b_ax = batch_axes(mesh, shape.global_batch)
    logits_spec = (b_ax, None, "model")

    def logits_sharder(t):
        if t.dim() != len(logits_spec):
            raise ValueError(f"logits of shape {tuple(t.shape)} do not fit "
                             f"the spec {logits_spec}")
        return t
    moe_groups, moe_gsh, ep_sharder = moe_dispatch_plan(
        cfg, mesh, shape.global_batch, shape.seq_len, seq_shard)
    moe_fn = None
    if cfg.is_moe and moe_impl == "shard_map":
        from repro_torch.models.moe import moe_schema
        from repro_torch.models.moe_shard import make_sharded_moe
        specs = {k: spec_for_axes(d.axes, d.shape, mesh)
                 for k, d in moe_schema(cfg).items()}
        moe_fn = make_sharded_moe(cfg, mesh, b_ax, specs,
                                  capacity_factor=moe_capacity_factor)

    def compute_loss(params, batch):
        if num_layers is not None and len(params.layers) != num_layers:
            raise ValueError(f"the model has {len(params.layers)} layers, "
                             f"the step was built for {num_layers}")
        return loss_fn(cfg, params, batch, q_chunk=q_chunk,
                       rec_chunk=rec_chunk, sharder=sharder,
                       logits_sharder=logits_sharder, remat=remat,
                       scan_layers=scan_layers, rec_unroll=rec_unroll,
                       moe_groups=moe_groups, ep_sharder=ep_sharder,
                       moe_group_sharder=moe_gsh, moe_fn=moe_fn)

    def grads_of(loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch):
        names, leaves = zip(*tree_leaves(params))
        if grad_accum > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows < grad_accum:
                raise ValueError(f"grad_accum {grad_accum} exceeds the "
                                 f"batch of {rows} rows")
            if rows % grad_accum:
                raise ValueError(f"grad_accum {grad_accum} does not divide "
                                 f"the batch of {rows} rows")
            rows //= grad_accum
            gsum, lsum = None, 0.0
            for i in range(grad_accum):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                loss, _ = compute_loss(params, mb)
                grads = grads_of(loss, leaves)
                gsum = ([g.float() for g in grads] if gsum is None else
                        [a + g.float() for a, g in zip(gsum, grads)])
                lsum = lsum + loss.detach()
            grads = [g / grad_accum for g in gsum]
            loss = lsum / grad_accum
            metrics = {}
        else:
            loss, metrics = compute_loss(params, batch)
            grads = grads_of(loss, leaves)
        params, opt_state, opt_metrics = apply_update(
            opt_cfg, params, dict(zip(names, grads)), opt_state)
        out = {"loss": loss.detach(), **opt_metrics}
        for k in STEP_METRICS:
            if k in metrics:
                out[k] = metrics[k].detach()
        return params, opt_state, out

    abs_params = make_abstract_params(cfg, num_layers)
    p_shard = tree_shardings(params_axes(cfg, num_layers), abs_params, mesh,
                             rules)
    # moments share the param placements (f32); step is replicated
    o_shard = {"mu": p_shard, "nu": p_shard, "step": Placement(mesh, ())}
    shardings = {"params": p_shard, "opt": o_shard}
    return train_step, shardings, {"params": abs_params,
                                   "opt": init_state(abs_params)}
