"""The port's training loss and gradients against the JAX package's, for
the recurrent architectures: reduced xlstm-1.3b (one sLSTM and seven
mLSTM layers) and recurrentgemma-2b (RG-LRU and local attention), and
xlstm's blocks one at a time (``xlstm-mlstm``, ``xlstm-slstm``: one
layer each, unstacked).  As ``test_torch_lm_train.py`` holds the other
architectures, with the bounds and measurements described there.

xlstm-1.3b's sLSTM is chaotic, so its gradients are held at their
measured conditioning (``test_xlstm_gradient_is_ill_conditioned``);
``test_stacked_mlstm_gradient_overflows`` pins a defect of the reference
the port keeps (NaN gradients of two stacked mLSTM layers).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import model
from torch_lm_train_cases import (
    GRAD, Q_CHUNK, REC_CHUNK, as_leaves, hold_leaves, jax_batch,
    one_step_sensitivity, port_loss_and_grads, reference, torch_batch,
    train_batch)

ARCHS = ["xlstm-1.3b", "recurrentgemma-2b", "xlstm-mlstm", "xlstm-slstm"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(arch, remat):
    corr, rel, dloss = GRAD[arch]
    want_loss, want_metrics, want_grads = reference(arch)
    loss, metrics, grads = port_loss_and_grads(arch, remat)
    assert abs(loss.item() - want_loss) <= dloss
    assert abs(float(metrics["nll"]) - float(want_metrics["nll"])) <= dloss
    hold_leaves(grads, want_grads, corr, rel, what=arch)


def test_xlstm_gradient_is_ill_conditioned():
    """The measurement behind xlstm-1.3b's wide bound: one bfloat16 step
    in one embedding element moves the reference's own gradients further
    than the bound lets the port's move."""
    corr, rel = one_step_sensitivity("xlstm-1.3b")
    print(f"xlstm-1.3b, one bfloat16 step in an embedding element: "
          f"gradient corr {corr:.6f}, max diff / max {rel:.4f}")
    bound_corr, bound_rel, _ = GRAD["xlstm-1.3b"]
    assert corr < bound_corr and rel > bound_rel


def test_stacked_mlstm_gradient_overflows():
    """The reference's defect, kept by the port: two stacked mLSTM
    layers (fan-in read from the repeats axis) overflow ``exp(-m_t)``
    and give NaN gradients, in the same leaves in both packages; the
    loss itself is finite and agrees."""
    changes = dict(block_pattern=("mlstm",), num_layers=2)
    ref_cfg = dataclasses.replace(ref_get_config("xlstm-1.3b").reduced(),
                                  **changes)
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), **changes)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda: ref_model.make_params(ref_cfg, 0))())
    batch = train_batch(ref_cfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(ref_cfg, p, b, q_chunk=Q_CHUNK,
                                       rec_chunk=REC_CHUNK),
        has_aux=True))(tree, jax_batch(batch))
    want = as_leaves(cfg, grads)
    m = model.LanguageModel(cfg, device="cpu").requires_grad_()
    m.load_state_dict(lm_params_from_reference(cfg, tree))
    got_loss, _ = model.loss_fn(cfg, m, torch_batch(batch), q_chunk=Q_CHUNK,
                                rec_chunk=REC_CHUNK)
    names, leaves = zip(*m.named_parameters())
    got = dict(zip(names, torch.autograd.grad(got_loss, leaves)))
    bad_ref = sorted(k for k, v in want.items() if not np.isfinite(v).all())
    bad_port = sorted(k for k, v in got.items()
                      if not torch.isfinite(v).all())
    assert np.isfinite(float(loss))
    assert abs(float(got_loss) - float(loss)) <= 1e-4
    assert len(bad_ref) == 15 and bad_port == bad_ref
