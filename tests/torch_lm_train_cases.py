"""Shared cases of the port's training tests against the JAX package's
(``test_torch_lm_train*.py``): the reduced configs, seeded batches,
``repro``'s cached parameters, gradients and train steps, the port's side
of each, and the holds with their measured bounds.  How each bound was
measured is said in ``test_torch_lm_train.py`` (gradients) and
``test_torch_lm_train_step.py`` (train steps).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_train_loop
from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models import model
from repro_torch.train import optimizer, train_loop

B, S, SRC, Q_CHUNK, REC_CHUNK = 2, 16, 8, 8, 8
#: per leaf: correlation >= corr, max |port - JAX| <= rel * max |JAX|;
#: and |loss_port - loss_JAX| <= the third entry
GRAD = {"qwen2-0.5b": (0.9998, 0.025, 1e-4),
        "qwen2.5-32b": (0.9993, 0.045, 1e-4),
        "nemotron-4-15b": (0.9999, 0.02, 1e-4),
        "stablelm-12b": (0.9999, 0.015, 1e-4),
        "granite-moe-3b-a800m": (0.9999, 0.03, 1e-2),
        "deepseek-moe-16b": (0.9999, 0.025, 1e-4),
        "qwen2-vl-2b": (0.9998, 0.03, 1e-4),
        "seamless-m4t-medium": (0.9995, 0.04, 1e-4),
        "xlstm-1.3b": (0.65, 3.0, 0.012),
        "recurrentgemma-2b": (0.9999, 0.02, 1e-4),
        "xlstm-mlstm": (0.9999, 0.01, 1e-4),
        "xlstm-slstm": (0.9999, 0.01, 2e-4)}
#: the one-layer xLSTM cuts: each block kind alone, unstacked
CUTS = {"xlstm-mlstm": dict(block_pattern=("mlstm",), num_layers=1),
        "xlstm-slstm": dict(block_pattern=("slstm",), num_layers=1)}


def configs(arch: str):
    if arch in CUTS:
        return (dataclasses.replace(
                    ref_get_config("xlstm-1.3b").reduced(), **CUTS[arch]),
                dataclasses.replace(
                    get_config("xlstm-1.3b").reduced(), **CUTS[arch]))
    return ref_get_config(arch).reduced(), get_config(arch).reduced()


def train_batch(cfg, seed: int = 0, batch: int = B) -> dict:
    """Seeded next-token batch; the first 3 labels of row 0 masked."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][0, :3] = -1
    if cfg.is_encdec:
        out["src_embeds"] = rng.normal(
            size=(batch, SRC, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(batch: dict) -> dict:
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "src_embeds" in out:
        out["src_embeds"] = out["src_embeds"].astype(jnp.bfloat16)
    return out


def torch_batch(batch: dict) -> dict:
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    if "src_embeds" in out:
        out["src_embeds"] = out["src_embeds"].to(torch.bfloat16)
    return out


def as_leaves(cfg, tree) -> dict:
    """A JAX tree (params, grads or a moment) as the port's leaves."""
    return {k: v.numpy() for k, v in lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, tree)).items()}


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    ref_cfg, _ = configs(arch)
    return jax.tree.map(np.asarray, jax.jit(
        lambda: ref_model.make_params(ref_cfg, 0))())


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(arch: str):
    ref_cfg, _ = configs(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss_fn(ref_cfg, p, b, q_chunk=Q_CHUNK,
                                       rec_chunk=REC_CHUNK), has_aux=True))


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """JAX's loss, metrics and gradients (as the port's leaves)."""
    ref_cfg, cfg = configs(arch)
    (loss, metrics), grads = ref_value_and_grad(arch)(
        ref_params(arch), jax_batch(train_batch(ref_cfg)))
    return (float(loss), jax.tree.map(np.asarray, metrics),
            as_leaves(cfg, grads))


def trainable(arch: str, tree=None) -> model.LanguageModel:
    _, cfg = configs(arch)
    m = model.LanguageModel(cfg, device="cpu").requires_grad_()
    m.load_state_dict(lm_params_from_reference(
        cfg, ref_params(arch) if tree is None else tree))
    return m


def port_loss_and_grads(arch: str, remat: bool):
    ref_cfg, cfg = configs(arch)
    m = trainable(arch)
    loss, metrics = model.loss_fn(cfg, m, torch_batch(train_batch(ref_cfg)),
                                  q_chunk=Q_CHUNK, rec_chunk=REC_CHUNK,
                                  remat=remat)
    names, leaves = zip(*m.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, {n: g.numpy() for n, g in zip(names, grads)}


def leaf_stats(got, want) -> tuple[float, float]:
    """(correlation, max |got - want| / max |want|) of one leaf."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    scale = np.abs(want).max()
    if scale == 0:
        return (1.0 if not got.any() else 0.0), float(np.abs(got).max())
    corr = np.corrcoef(got, want)[0, 1] if got.size > 1 else 1.0
    return float(corr), float(np.abs(got - want).max() / scale)


def hold_leaves(got: dict, want: dict, corr: float, rel: float, what=""):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert np.isfinite(got[name]).all(), f"{what} {name}: not finite"
        c, r = leaf_stats(got[name], want[name])
        assert c >= corr and r <= rel, (
            f"{what} {name}: corr {c:.7f} (>= {corr}), max diff / max "
            f"{r:.5f} (<= {rel})")



def one_step_sensitivity(arch: str) -> tuple[float, float]:
    """The reference's own worst leaf (correlation, max diff / max) when
    one element of the first token's embedding (each row's first token)
    moves by one bfloat16 step."""
    ref_cfg, cfg = configs(arch)
    _, _, want = reference(arch)
    batch = train_batch(ref_cfg)
    corr, rel = 1.0, 0.0
    for row in range(B):
        tree = jax.tree.map(np.copy, ref_params(arch))
        tok = batch["tokens"][row, 0]
        bits = np.array([tree["embed"][tok, 0]], np.float32).astype(
            ml_dtypes.bfloat16).view(np.uint16) + 1
        tree["embed"][tok, 0] = bits.view(ml_dtypes.bfloat16).astype(
            np.float32)[0]
        _, grads = ref_value_and_grad(arch)(tree, jax_batch(batch))
        grads = as_leaves(cfg, grads)
        for name in want:
            c, r = leaf_stats(grads[name], want[name])
            corr, rel = min(corr, c), max(rel, r)
    return corr, rel


LR, WD, EPS = 1e-3, 0.1, 1e-8
#: (variant, grad_accum, the port's remat) of the first step; repro's
#: step runs without remat (the port's remat computes the same numbers,
#: ``test_remat_changes_nothing_on_the_cpu``)
STEPS = [("accum1", 1, False), ("accum2", 2, True)]
#: the train step's bounds, measured per (arch, variant): the worst leaf
#: of ``mu`` (corr, rel) and of ``nu`` (corr, rel), |loss_port -
#: loss_JAX| and |grad_norm_port / grad_norm_JAX - 1|, each the measured
#: value widened by half its distance from exact
STEP = {
    ('qwen2-0.5b', 'accum1'): (0.99983, 0.0304, 0.99964, 0.0377, 1.7e-05, 0.0015),
    ('qwen2-0.5b', 'accum2'): (0.99983, 0.0308, 0.99966, 0.0369, 1e-05, 0.00063),
    ('qwen2-0.5b', 'resumed'): (0.99996, 0.0152, 0.99995, 0.0221, 1e-05, 0.00038),
    ('qwen2.5-32b', 'accum1'): (0.99927, 0.0527, 0.998, 0.0872, 1e-05, 0.0033),
    ('qwen2.5-32b', 'accum2'): (0.998, 0.0752, 0.993, 0.139, 1e-05, 0.0024),
    ('qwen2.5-32b', 'resumed'): (0.998, 0.116, 0.998, 0.109, 0.00059, 0.0071),
    ('nemotron-4-15b', 'accum1'): (0.99994, 0.0226, 0.99986, 0.0373, 1e-05, 0.0035),
    ('nemotron-4-15b', 'accum2'): (0.99993, 0.0152, 0.99986, 0.0284, 1e-05, 0.0027),
    ('nemotron-4-15b', 'resumed'): (0.99998, 0.0142, 0.99995, 0.0258, 1e-05, 0.0056),
    ('stablelm-12b', 'accum1'): (0.99993, 0.0184, 0.99976, 0.0364, 4.5e-05, 0.0001),
    ('stablelm-12b', 'accum2'): (0.99991, 0.0317, 0.99978, 0.0614, 3.9e-05, 0.011),
    ('stablelm-12b', 'resumed'): (0.983, 0.469, 0.947, 1.07, 0.0014, 0.35),
    ('granite-moe-3b-a800m', 'accum1'): (0.9999, 0.0326, 0.99973, 0.0635, 0.011, 0.0034),
    ('granite-moe-3b-a800m', 'accum2'): (0.99992, 0.0304, 0.99967, 0.0596, 0.012, 0.022),
    ('granite-moe-3b-a800m', 'resumed'): (0.99989, 0.0308, 0.99973, 0.0605, 1e-05, 0.0095),
    ('deepseek-moe-16b', 'accum1'): (0.99989, 0.0307, 0.99977, 0.0604, 1e-05, 0.00033),
    ('deepseek-moe-16b', 'accum2'): (0.9999, 0.0251, 0.99978, 0.0422, 1e-05, 0.0002),
    ('deepseek-moe-16b', 'resumed'): (0.99992, 0.0258, 0.99967, 0.051, 0.00033, 0.0019),
    ('qwen2-vl-2b', 'accum1'): (0.99986, 0.0382, 0.9995, 0.0749, 1e-05, 0.0055),
    ('qwen2-vl-2b', 'accum2'): (0.99984, 0.0296, 0.99961, 0.0502, 1e-05, 0.0054),
    ('qwen2-vl-2b', 'resumed'): (0.99993, 0.0221, 0.99983, 0.0437, 0.0029, 0.004),
    ('seamless-m4t-medium', 'accum1'): (0.99965, 0.0433, 0.99923, 0.074, 7.5e-05, 0.027),
    ('seamless-m4t-medium', 'accum2'): (0.99971, 0.0518, 0.99908, 0.0843, 8.5e-05, 0.017),
    ('seamless-m4t-medium', 'resumed'): (0.985, 0.354, 0.961, 0.507, 0.0061, 0.00054),
    ('xlstm-1.3b', 'accum1'): (0.543, 2.79, -0.02, 9.45, 0.014, 0.46),
    ('xlstm-1.3b', 'accum2'): (0.503, 2.64, -0.154, 9.08, 0.015, 0.61),
    ('xlstm-1.3b', 'resumed'): (0.971, 0.504, 0.915, 0.805, 0.00082, 0.12),
    ('recurrentgemma-2b', 'accum1'): (0.99991, 0.0271, 0.99964, 0.053, 1e-05, 0.00042),
    ('recurrentgemma-2b', 'accum2'): (0.99991, 0.0203, 0.99984, 0.0344, 1e-05, 0.0004),
    ('recurrentgemma-2b', 'resumed'): (0.99994, 0.0175, 0.99989, 0.0275, 2e-05, 0.00015),
}


def opt_cfgs():
    kw = dict(lr=LR, weight_decay=WD, eps=EPS, warmup_steps=0,
              total_steps=10)
    return ref_opt.OptConfig(**kw), optimizer.OptConfig(**kw)


@functools.lru_cache(maxsize=None)
def ref_step(arch: str, grad_accum: int):
    ref_cfg, _ = configs(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step, _, _ = ref_train_loop.build_train_step(
        ref_cfg, mesh, RefShapeSpec("t", "train", S, B), opt_cfgs()[0],
        q_chunk=Q_CHUNK, rec_chunk=REC_CHUNK, remat=False,
        grad_accum=grad_accum)
    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def ref_steps(arch: str, grad_accum: int):
    """repro's first step from its initial state, and its second step
    (on the seed-1 batch) from the first's state, all as numpy."""
    ref_cfg, _ = configs(arch)
    step = ref_step(arch, grad_accum)
    params = jax.tree.map(jnp.asarray, ref_params(arch))
    p1, o1, m1 = step(params, ref_opt.init_state(params),
                      jax_batch(train_batch(ref_cfg)))
    p2, o2, m2 = step(p1, o1, jax_batch(train_batch(ref_cfg, seed=1)))
    host = functools.partial(jax.tree.map, np.asarray)
    return [(host(p1), host(o1), host(m1)), (host(p2), host(o2), host(m2))]


def port_step(arch, grad_accum, remat, model, opt_state, seed):
    ref_cfg, cfg = configs(arch)
    step, _, _ = train_loop.build_train_step(
        cfg, None, ShapeSpec("t", "train", S, B), opt_cfgs()[1],
        q_chunk=Q_CHUNK, rec_chunk=REC_CHUNK, remat=remat,
        grad_accum=grad_accum)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, opt_state, metrics = step(model, opt_state,
                                     torch_batch(train_batch(ref_cfg, seed)))
    return before, model, opt_state, metrics


def hold_step(arch, variant, before, model, opt_state, metrics, want):
    """Hold one port step against ``want`` = repro's (params, opt state,
    metrics) at ``STEP[arch, variant]``; the decided parameters only on
    a first step, whose update is ±``lr`` plus the decay."""
    mu_corr, mu_rel, nu_corr, nu_rel, dloss, dgn = STEP[arch, variant]
    _, cfg = configs(arch)
    want_p, want_o, want_m = want
    assert sorted(metrics) == sorted(want_m)
    assert abs(float(metrics["loss"]) - float(want_m["loss"])) <= dloss
    if "nll" in want_m:
        assert abs(float(metrics["nll"]) - float(want_m["nll"])) <= dloss
    gn, want_gn = float(metrics["grad_norm"]), float(want_m["grad_norm"])
    assert abs(gn - want_gn) <= dgn * want_gn
    assert float(metrics["lr"]) == float(want_m["lr"])
    if "moe_aux_loss" in want_m:
        np.testing.assert_allclose(float(metrics["moe_aux_loss"]),
                                   float(want_m["moe_aux_loss"]), rtol=1e-3)
        assert int(metrics["dropped_tokens"]) == int(
            want_m["dropped_tokens"])
    assert int(opt_state["step"]) == int(want_o["step"])
    assert opt_state["step"].dtype == torch.int32
    want_mu = as_leaves(cfg, want_o["mu"])
    hold_leaves({n: t.numpy() for n, t in opt_state["mu"].items()}, want_mu,
                mu_corr, mu_rel, what=f"{arch} {variant} mu")
    hold_leaves({n: t.numpy() for n, t in opt_state["nu"].items()},
                as_leaves(cfg, want_o["nu"]), nu_corr, nu_rel,
                what=f"{arch} {variant} nu")
    want_p = as_leaves(cfg, want_p)
    for name, p in model.named_parameters():
        got, exp, p0 = p.detach().numpy(), want_p[name], before[name].numpy()
        step_bound = 2 * LR * (1 + WD * np.abs(p0)) + np.spacing(
            np.abs(exp))
        assert (np.abs(got - exp) <= step_bound).all(), name
        if variant != "resumed":
            g = np.abs(want_mu[name]) / (1 - 0.9)
            decided = (g > 4 * mu_rel * g.max()) & (g > 1e3 * EPS)
            err = np.abs(got - exp)[decided]
            assert (err <= 1e-3 * LR).all(), (name, err.max())


def first_step_case(arch: str, variant: str, grad_accum: int, remat: bool):
    """The port's first step against repro's."""
    want = ref_steps(arch, grad_accum)[0]
    m = trainable(arch)
    before, m, opt_state, metrics = port_step(
        arch, grad_accum, remat, m, optimizer.init_state(m), 0)
    hold_step(arch, variant, before, m, opt_state, metrics, want)


def resumed_step_case(arch: str):
    """The port's step from repro's state after its first step (params
    and ``opt_state_from_reference``) against repro's second step."""
    _, cfg = configs(arch)
    (p1, o1, _), want = ref_steps(arch, 1)
    m = trainable(arch, p1)
    opt_state = opt_state_from_reference(cfg, o1)
    assert int(opt_state["step"]) == 1
    for name, p in m.named_parameters():
        assert opt_state["mu"][name].shape == p.shape
    before, m, opt_state, metrics = port_step(arch, 1, False, m, opt_state, 1)
    hold_step(arch, "resumed", before, m, opt_state, metrics, want)
