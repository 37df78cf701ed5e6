"""The port's training loss and gradients against the JAX package's.

For the reduced config of each attention architecture (the recurrent
ones are in ``test_torch_lm_train_recurrent.py``), the JAX package's
parameters are carried across with
``lm_params_from_reference``; both packages take the loss of the same
seeded batch (labels < 0 masked in one row) with ``q_chunk`` and the
mLSTM's chunk at 8, so chunks are exercised.  ``repro``'s
``jax.value_and_grad(loss_fn)`` is held against the port's ``loss_fn``
and ``torch.autograd.grad`` over the float32 master leaves, with
``remat`` off and on (each layer under ``torch.utils.checkpoint``):
the loss, ``nll``, the MoE metrics, and every leaf's gradient (mapped
across with ``lm_params_from_reference``) at correlation ≥ ``corr`` and
max |port - JAX| ≤ ``rel`` · max |JAX| per leaf.

The bounds (``GRAD``) are each architecture's measured worst leaf,
widened to the next round figure.  The backward's bfloat16 products
and XLA's fusions round apart from torch's; how far that can move a
gradient is measured on the reference itself: one bfloat16 step of one
element of the first token's embedding moves ``repro``'s own gradients
(worst leaf, first token of each row) to

============================  ====================  ===================
arch                          port vs JAX (worst)   JAX vs itself
============================  ====================  ===================
qwen2-0.5b                    0.99989 / 0.020       0.978 / 0.56
qwen2.5-32b                   0.99953 / 0.037       0.990 / 0.29
nemotron-4-15b                0.99996 / 0.013       0.982 / 0.25
stablelm-12b                  0.99995 / 0.012       0.947 / 0.31
granite-moe-3b-a800m          0.99994 / 0.024       0.989 / 0.40
deepseek-moe-16b              0.99993 / 0.020       0.99991 / 0.024
qwen2-vl-2b                   0.99991 / 0.023       0.985 / 0.31
seamless-m4t-medium           0.99977 / 0.030       0.806 / 1.30
xlstm-1.3b                    0.695 / 2.66          0.293 / 3.45
recurrentgemma-2b             0.99994 / 0.017       0.99996 / 0.014
============================  ====================  ===================

(correlation / max difference over max), so every bound but
recurrentgemma's lies inside the reference's own sensitivity; the
port's recurrentgemma gradients deviate about as far as that one
bfloat16 step moves the reference's (over 32 single-element steps the
reference moves up to 0.99995 / 0.018).  xlstm-1.3b's are ill-conditioned:
its sLSTM layer is chaotic (ROADMAP §3), so a gradient through it is held
at its measured conditioning (``test_xlstm_gradient_is_ill_conditioned``
measures and prints it), and its blocks are held one at a time, each as
a one-layer model (``xlstm-mlstm``, ``xlstm-slstm``), tightly.

The recurrent architectures (xlstm-1.3b, recurrentgemma-2b and the
one-layer xLSTM cuts) are held in ``test_torch_lm_train_recurrent.py``,
which also holds ``test_stacked_mlstm_gradient_overflows``: it pins a defect of the reference
that the port keeps: its fan-in rule reads a scanned group's leading
(repeats) axis, so two stacked mLSTM layers draw their weights at std
1/√2; the mLSTM's ``exp(-m_t)`` then overflows in the forward (harmless
there: it is a ``maximum``'s losing side) and its backward multiplies
that infinity by zero, so both packages' gradients are NaN in the same
15 leaves.
"""


import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import model
from torch_lm_train_cases import (
    B, GRAD, Q_CHUNK, S, configs, hold_leaves, port_loss_and_grads, reference,
    torch_batch, train_batch)

ARCHS = ["qwen2-0.5b", "qwen2.5-32b", "nemotron-4-15b", "stablelm-12b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "qwen2-vl-2b",
         "seamless-m4t-medium"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(arch, remat):
    corr, rel, dloss = GRAD[arch]
    want_loss, want_metrics, want_grads = reference(arch)
    loss, metrics, grads = port_loss_and_grads(arch, remat)
    assert abs(loss.item() - want_loss) <= dloss
    assert abs(float(metrics["nll"]) - float(want_metrics["nll"])) <= dloss
    hold_leaves(grads, want_grads, corr, rel, what=arch)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
def test_moe_training_metrics(arch):
    _, want_metrics, _ = reference(arch)
    _, metrics, _ = port_loss_and_grads(arch, remat=False)
    for key in ("expert_load", "dropped_tokens"):
        np.testing.assert_array_equal(metrics[key].numpy(),
                                      want_metrics[key])
    for key in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(want_metrics[key]), rtol=1e-3)


def test_remat_changes_nothing_on_the_cpu():
    """Recomputing a layer in the backward computes the same numbers:
    loss and every gradient bit for bit."""
    a = port_loss_and_grads("qwen2.5-32b", remat=False)
    b = port_loss_and_grads("qwen2.5-32b", remat=True)
    assert float(a[0]) == float(b[0])
    for name in a[2]:
        np.testing.assert_array_equal(a[2][name], b[2][name])


def test_labels_masked_and_padded_vocab_excluded():
    """The loss is the mean negative log-likelihood over the labels >= 0
    alone (the count clamped to 1, so an all-masked batch gives 0), and
    the padded vocabulary's logits, at NEG_INF, get no probability."""
    _, cfg = configs("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, vocab_size=500)       # padded to 512
    m = model.make_params(cfg, 0, device="cpu")
    batch = torch_batch(train_batch(cfg))                # 3 labels masked
    loss, metrics = model.loss_fn(cfg, m, batch, q_chunk=Q_CHUNK)
    x, _, _ = model.forward(cfg, m, batch, q_chunk=Q_CHUNK)
    logits = model._mask_padded_vocab(
        cfg, model.logits_from_hidden(cfg, m, x)).float()
    logp = torch.log_softmax(logits, -1)
    assert float(logp[..., cfg.vocab_size:].exp().max()) == 0.0
    keep = batch["labels"] >= 0
    nll = -logp.gather(-1, batch["labels"].clamp(min=0)[..., None])[..., 0]
    want = float(nll[keep].double().mean())
    assert int(keep.sum()) == B * S - 3
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    assert float(metrics["nll"]) == float(loss)
    masked = dict(batch, labels=torch.full_like(batch["labels"], -1))
    zero, metrics = model.loss_fn(cfg, m, masked, q_chunk=Q_CHUNK)
    assert float(zero) == 0.0 and float(metrics["nll"]) == 0.0


def test_biased_query_and_key_reach_the_rope_unrounded():
    """The reference's compiled program adds each attention bias to its
    projection in float32 and rounds the query and key once, after the
    rope; with non-zero biases (as after a training step) the port's
    prefill keys and values equal ``repro``'s bit for bit.  (Biases
    start at zero, so the serving tests cannot see the rounding.)"""
    import jax

    from repro.models import model as ref_model
    from repro_torch.convert import lm_cache_from_reference
    from torch_lm_train_cases import jax_batch, ref_params, trainable
    ref_cfg, cfg = configs("qwen2-0.5b")
    tree = jax.tree.map(np.copy, ref_params("qwen2-0.5b"))
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):        # both layers: one scanned group
        leaf = tree["g0"]["b0"]["mixer"][name]
        leaf[...] = rng.normal(size=leaf.shape) * 1e-2
    batch = train_batch(ref_cfg, seed=1)
    _, caches = jax.jit(lambda p, b: ref_model.serve_prefill(
        ref_cfg, p, b, q_chunk=Q_CHUNK))(tree, jax_batch(batch))
    want = lm_cache_from_reference(cfg, jax.tree.map(np.asarray, caches))
    with torch.no_grad():
        _, got = model.serve_prefill(cfg, trainable("qwen2-0.5b", tree),
                                     torch_batch(batch), q_chunk=Q_CHUNK)
    assert len(got) == len(want) == cfg.num_layers
    for layer, (g, w) in enumerate(zip(got, want)):
        for key in ("k", "v"):
            assert torch.equal(g[key], w[key]), (layer, key)
