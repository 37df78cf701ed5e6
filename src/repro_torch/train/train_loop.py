"""Train-step construction: loss + grad + optimizer.

The port of ``repro.train.train_loop.build_train_step`` without the mesh:
the step runs on the device the parameters are on, and the shardings
and abstract state the reference returns beside it wait for the
parallel slice.  Gradients come from ``torch.autograd.grad`` over the
float32 master leaves of a trainable ``LanguageModel``
(``make_params(..., trainable=True)``); the optimizer then updates those
leaves in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.model import loss_fn
from repro_torch.train.optimizer import (
    OptConfig, apply_update, tree_leaves)

#: the loss function's metrics a step reports beside ``loss``
STEP_METRICS = ("nll", "moe_aux_loss", "dropped_tokens")


def build_train_step(cfg: ArchConfig, shape: ShapeSpec | None = None,
                     opt_cfg: OptConfig | None = None, *,
                     q_chunk: int = 512, rec_chunk: int = 256,
                     remat: bool = True, grad_accum: int = 1,
                     num_layers: int | None = None, moe_groups: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, ``params`` a trainable ``LanguageModel`` of
    ``num_layers`` layers (the config's when ``None``) updated in place.

    ``shape`` is the batch's ``ShapeSpec``, which the reference's
    sharding rules read (none here yet).  With ``grad_accum > 1`` the
    batch splits along its first axis into that many micro-batches;
    their float32 gradients are summed and divided, the loss is their
    mean, and the metrics hold no ``nll``, as the reference's.  Metrics
    are ``loss``, ``grad_norm``, ``lr`` and those of
    :data:`STEP_METRICS` the loss reports, each a detached tensor.
    """
    del shape
    opt_cfg = opt_cfg or OptConfig()

    def compute_loss(params, batch):
        if num_layers is not None and len(params.layers) != num_layers:
            raise ValueError(f"the model has {len(params.layers)} layers, "
                             f"the step was built for {num_layers}")
        return loss_fn(cfg, params, batch, q_chunk=q_chunk,
                       rec_chunk=rec_chunk, remat=remat,
                       moe_groups=moe_groups)

    def grads_of(loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, batch):
        names, leaves = zip(*tree_leaves(params))
        if grad_accum > 1:
            gsum, lsum = None, 0.0
            rows = next(iter(batch.values())).shape[0] // grad_accum
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

    return train_step
