"""The port's serving path against the JAX package's, end to end in
bfloat16.

For the reduced config of each attention architecture (dense, MoE,
vision-language, encoder-decoder) and for reduced qwen2 with
``block_pattern=("attn", "local_attn")`` and ``window=8`` (its prompts
run past the window, so ``_ring_place`` and the ring buffer are
exercised), the JAX package's parameters are carried across with
``lm_params_from_reference``.  Both packages prefill the same prompts;
then JAX's greedy tokens are teacher-forced through both decode paths
for 6 steps, the port's starting once from its own
``prefill_to_decode_cache`` and once from JAX's cache
(``lm_cache_from_reference``).

Bound, for the prefill logits, every cache (flattened per layer) and the
logits of every decode step: correlation ≥ 0.9999 and
max |port - JAX| ≤ 0.02 · max |JAX|; wherever JAX's top-1 minus top-2
logit margin exceeds that bound, the port's argmax equals JAX's token.
The two packages round bfloat16 at the same places (the port's
activations are written op by op as XLA rounds them, and its norms read a
residual sum in float32 where the reference's compiled program does), so
most of these match bit for bit; what is left is the order of float32
sums inside matrix products.

One exception, measured: reduced seamless-m4t-medium is ill-conditioned.
Its layer norms subtract a mean of order 400 from a residual of order
400, so one bfloat16 step of one input element (of 2,048) moves JAX's
*own* decode logits to a correlation of 0.902 and a max difference of
0.66 · max (``test_seamless_reference_is_ill_conditioned`` measures and
prints it).  What the port computes from its own encoder output — the
prefill caches and the decode from the port's own prefill cache — is
held a little inside that measured sensitivity instead: correlation ≥
0.94, max difference ≤ 0.5 · max.  Its prefill logits and its decode from JAX's cache are held
to the bound above.

``generate`` is held to shapes, the echoed prompt, ids below
``vocab_size``, determinism of greedy decoding, reproducible sampling per
seed and the cache-capacity check; the padded vocabulary is masked below
-1e30.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.models import model
from repro_torch.serve import engine

ARCHS = ["qwen2-0.5b", "qwen2.5-32b", "nemotron-4-15b", "stablelm-12b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "qwen2-vl-2b",
         "seamless-m4t-medium", "qwen2-ring"]
STEPS = 6
B, P, SRC, CAPACITY, Q_CHUNK = 2, 12, 8, 24, 8
CORR, REL = 0.9999, 0.02
#: seamless' prefill caches and own-cache decode: inside the reference's
#: own sensitivity to one bfloat16 step of one input element
ILL_CONDITIONED = {"seamless-m4t-medium": (0.94, 0.5)}


def configs(arch: str):
    if arch == "qwen2-ring":
        changes = dict(block_pattern=("attn", "local_attn"), window=8)
        return (dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(),
                                    **changes),
                dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                    **changes))
    return ref_get_config(arch).reduced(), get_config(arch).reduced()


def inputs(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = rng.normal(size=(B, SRC, cfg.d_model)).astype(
            np.float32)
    if cfg.modality == "vlm":
        batch["vision_embeds"] = rng.normal(size=(B, P, cfg.d_model)).astype(
            np.float32)
        batch["vision_mask"] = rng.random((B, P)) < 0.25
        batch["positions3"] = np.broadcast_to(
            np.arange(P, dtype=np.int32), (3, B, P)).copy()
    return batch


def _ref_prefill(cfg, params, batch):
    """JAX's prefill, its decode cache (as its engine builds it) and the
    forward's MoE metrics, in one program."""
    logits, caches = ref_model.serve_prefill(cfg, params, batch,
                                             q_chunk=Q_CHUNK)
    _, metrics, _ = ref_model.forward(cfg, params, batch, q_chunk=Q_CHUNK)
    enc = None
    if cfg.is_encdec:
        src = batch["src_embeds"]
        ctx = dict(positions=jnp.broadcast_to(
            jnp.arange(src.shape[1], dtype=jnp.int32), src.shape[:2]),
            causal=False, q_chunk=Q_CHUNK, rec_chunk=256, want_cache=False,
            enc_out=None, sharder=None, remat=False, scan_layers=True,
            rec_unroll=False)
        x, _, _ = ref_model.run_stack(
            cfg, params["encoder"], src, ctx,
            [([ref_model.layer_sigs(cfg, 1)[0]], cfg.encoder_layers)],
            prefix="")
        enc = ref_model.apply_norm(cfg, params["encoder"]["out_norm"], x)
    cache = ref_engine.prefill_to_decode_cache(cfg, caches, P, CAPACITY,
                                               enc_out=enc, params=params)
    return logits, caches, cache, metrics


def jax_batch(batch: dict) -> dict:
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    for k in ("src_embeds", "vision_embeds"):
        if k in out:
            out[k] = out[k].astype(jnp.bfloat16)
    return out


def torch_batch(batch: dict) -> dict:
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    for k in ("src_embeds", "vision_embeds"):
        if k in out:
            out[k] = out[k].to(torch.bfloat16)
    return out


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """JAX's parameters, prefill, caches and 6 greedy decode steps."""
    ref_cfg, _ = configs(arch)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda: ref_model.make_params(ref_cfg, 0))())
    batch = inputs(ref_cfg)
    logits, caches, cache, metrics = jax.jit(
        functools.partial(_ref_prefill, ref_cfg))(tree, jax_batch(batch))
    first_cache = jax.tree.map(np.asarray, cache)
    decode = jax.jit(functools.partial(ref_model.decode_step, ref_cfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    tokens, step_logits = [], []
    for _ in range(STEPS):
        tokens.append(np.asarray(tok))
        out, cache = decode(tree, tok, cache)
        step_logits.append(f32(out)[:, 0, :ref_cfg.vocab_size])
        tok = jnp.argmax(out[:, -1], -1).astype(jnp.int32)[:, None]
    return dict(tree=tree, batch=batch,
                logits=f32(logits)[:, 0, :ref_cfg.vocab_size],
                caches=jax.tree.map(np.asarray, caches), cache=first_cache,
                metrics=jax.tree.map(np.asarray, metrics), tokens=tokens,
                step_logits=step_logits)


@functools.lru_cache(maxsize=None)
def port_weights(arch: str):
    _, cfg = configs(arch)
    m = model.LanguageModel(cfg, device="cpu")
    m.load_state_dict(lm_params_from_reference(cfg, reference(arch)["tree"]))
    return m, model.compute_copy(m)


def hold(got, want, corr=CORR, rel=REL, what=""):
    got, want = f32(got).ravel(), f32(want).ravel()
    scale = np.abs(want).max()
    c = np.corrcoef(got, want)[0, 1] if scale > 0 else 1.0
    d = np.abs(got - want).max()
    assert c >= corr and d <= rel * scale, (
        f"{what}: corr {c:.7f} (>= {corr}), max diff {d} "
        f"(<= {rel} * {scale})")


def hold_argmax(got, want, rel=REL, what=""):
    got, want = f32(got), f32(want)
    top2 = np.sort(want, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > rel * np.abs(want).max()
    agree = got.argmax(-1) == want.argmax(-1)
    assert (agree | ~decided).all(), f"{what}: argmax differs"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches(arch):
    _, cfg = configs(arch)
    ref = reference(arch)
    _, w = port_weights(arch)
    batch = torch_batch(ref["batch"])
    logits, caches = model.serve_prefill(cfg, w, batch, q_chunk=Q_CHUNK)
    vocab = logits.shape[-1]
    assert vocab == model.pad_vocab(cfg.vocab_size)
    if vocab > cfg.vocab_size:
        assert float(logits[..., cfg.vocab_size:].max()) < -1e30
    hold(logits[:, 0, :cfg.vocab_size], ref["logits"], what="prefill")
    hold_argmax(logits[:, 0, :cfg.vocab_size], ref["logits"])
    want = lm_cache_from_reference(cfg, ref["caches"])
    assert len(caches) == len(want) == cfg.num_layers
    corr, rel = ILL_CONDITIONED.get(arch, (CORR, REL))
    for i, (got, exp) in enumerate(zip(caches, want)):
        assert sorted(got) == sorted(exp) == ["k", "v"]
        for key in got:
            assert got[key].shape == exp[key].shape
            hold(got[key], exp[key], corr, rel, what=f"layer {i} {key}")


@pytest.mark.parametrize("arch", [a for a in ARCHS if "moe" in a])
def test_moe_metrics(arch):
    _, cfg = configs(arch)
    ref = reference(arch)
    _, w = port_weights(arch)
    _, metrics, _ = model.forward(cfg, w, torch_batch(ref["batch"]),
                                  q_chunk=Q_CHUNK)
    for key in ("expert_load", "dropped_tokens"):
        np.testing.assert_array_equal(metrics[key].numpy(),
                                      ref["metrics"][key])
    for key in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(ref["metrics"][key]), rtol=1e-3)


@pytest.mark.parametrize("start", ["own_cache", "reference_cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode(arch, start):
    _, cfg = configs(arch)
    ref = reference(arch)
    _, w = port_weights(arch)
    if start == "own_cache":
        batch = torch_batch(ref["batch"])
        enc = (model.encode(cfg, w, batch["src_embeds"], q_chunk=Q_CHUNK)
               if cfg.is_encdec else None)
        _, caches = model.serve_prefill(cfg, w, batch, q_chunk=Q_CHUNK,
                                        enc_out=enc)
        cache = engine.prefill_to_decode_cache(
            cfg, caches, P, CAPACITY, params=w,
            enc_out=None if enc is None else enc[0])
    else:
        cache = lm_cache_from_reference(cfg, ref["cache"])
    corr, rel = CORR, REL
    if start == "own_cache":
        corr, rel = ILL_CONDITIONED.get(arch, (CORR, REL))
    for step, (tok, want) in enumerate(zip(ref["tokens"],
                                           ref["step_logits"])):
        logits, cache = model.decode_step(cfg, w, torch.tensor(tok),
                                          cache)
        got = logits[:, 0, :cfg.vocab_size]
        hold(got, want, corr, rel, what=f"step {step}")
        hold_argmax(got, want, rel, what=f"step {step}")
        if logits.shape[-1] > cfg.vocab_size:
            assert float(logits[..., cfg.vocab_size:].max()) < -1e30
    assert cache["pos"] == P + STEPS


def test_seamless_reference_is_ill_conditioned():
    """The measurement behind seamless' looser bound: one bfloat16 step
    in one element of ``src_embeds`` moves JAX's own decode logits to a
    correlation below 0.999 and a max difference above 0.1 · max."""
    ref_cfg, _ = configs("seamless-m4t-medium")
    ref = reference("seamless-m4t-medium")
    batch = jax_batch(ref["batch"])
    src = batch["src_embeds"]
    batch["src_embeds"] = src.at[0, 0, 0].set(
        jnp.nextafter(src[0, 0, 0], jnp.bfloat16(100)))
    _, _, cache, _ = jax.jit(functools.partial(_ref_prefill, ref_cfg))(
        ref["tree"], batch)
    decode = jax.jit(functools.partial(ref_model.decode_step, ref_cfg))
    corr, rel = 1.0, 0.0
    for tok, want in zip(ref["tokens"], ref["step_logits"]):
        out, cache = decode(ref["tree"], jnp.asarray(tok), cache)
        got = f32(out)[:, 0, :ref_cfg.vocab_size]
        corr = min(corr, np.corrcoef(got.ravel(), want.ravel())[0, 1])
        rel = max(rel, np.abs(got - want).max() / np.abs(want).max())
    print(f"seamless, one bfloat16 step in src_embeds: decode corr "
          f"{corr:.6f}, max diff / max {rel:.4f}")
    assert corr < 0.999 and rel > 0.1


@pytest.mark.parametrize("rope", ["rope", "none"])
def test_encdec_cross_rope_hazard(rope):
    """The port keeps the reference's two encoder-decoder paths: prefill
    ropes the cross keys and query, the decode step ropes neither, so
    prefill(P) and prefill(P - 1) + one decode step disagree (JAX's
    weights; corr < 0.99); with ``rope_variant="none"`` they agree
    (corr > 0.9999)."""
    _, cfg = configs("seamless-m4t-medium")
    cfg = dataclasses.replace(cfg, rope_variant=rope)
    _, w = port_weights("seamless-m4t-medium")
    batch = torch_batch(inputs(cfg))
    full = engine.teacher_forced_logits(cfg, w, batch, batch["tokens"][:, :0],
                                        capacity=CAPACITY, q_chunk=Q_CHUNK)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    step = engine.teacher_forced_logits(cfg, w, short,
                                        batch["tokens"][:, -1:],
                                        capacity=CAPACITY, q_chunk=Q_CHUNK)
    a = f32(full[0][:, :cfg.vocab_size]).ravel()
    b = f32(step[-1][:, :cfg.vocab_size]).ravel()
    corr = np.corrcoef(a, b)[0, 1]
    print(f"seamless rope_variant={rope}: prefill vs decode corr {corr:.6f}")
    assert corr > 0.9999 if rope == "none" else corr < 0.99


# ---------------------------------------------------------------- engine

def engine_for(arch: str, max_seq_len: int = 64):
    _, cfg = configs(arch)
    m, _ = port_weights(arch)
    return cfg, engine.ServeEngine(cfg, m, max_seq_len=max_seq_len,
                                   q_chunk=Q_CHUNK, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_shapes_and_determinism(arch):
    cfg, eng = engine_for(arch)
    batch = inputs(cfg, seed=1)
    kw = dict(max_new_tokens=6, src_embeds=batch.get("src_embeds"),
              vision_embeds=batch.get("vision_embeds"),
              vision_mask=batch.get("vision_mask"),
              positions3=batch.get("positions3"))
    out1 = eng.generate(batch["tokens"], **kw)
    out2 = eng.generate(batch["tokens"], **kw)
    assert out1.shape == (B, P + 6) and out1.dtype == np.int32
    np.testing.assert_array_equal(out1, out2)
    np.testing.assert_array_equal(out1[:, :P], batch["tokens"])
    assert ((out1 >= 0) & (out1 < cfg.vocab_size)).all()
    assert eng.timing["decode_steps"] == 6


def test_greedy_generate_is_the_teacher_forced_path():
    """``generate``'s greedy tokens are the argmax of the prefill and of
    each decode step run by hand."""
    arch = "granite-moe-3b-a800m"
    cfg, eng = engine_for(arch, max_seq_len=CAPACITY)
    ref = reference(arch)
    _, w = port_weights(arch)
    out = eng.generate(ref["batch"]["tokens"], max_new_tokens=4)
    logits, caches = model.serve_prefill(cfg, w, torch_batch(ref["batch"]),
                                         q_chunk=Q_CHUNK)
    cache = engine.prefill_to_decode_cache(cfg, caches, P, CAPACITY)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(4):
        np.testing.assert_array_equal(out[:, P + i], tok[:, 0].numpy())
        logits, cache = model.decode_step(cfg, w, tok, cache)
        tok = logits[:, -1].argmax(-1)[:, None]


def test_sampling_is_reproducible_per_seed():
    cfg, eng = engine_for("qwen2-0.5b")
    toks = np.zeros((2, 4), np.int32)
    a = eng.generate(toks, max_new_tokens=8, temperature=1.0, seed=0)
    b = eng.generate(toks, max_new_tokens=8, temperature=1.0, seed=0)
    c = eng.generate(toks, max_new_tokens=8, temperature=1.0, seed=1)
    assert a.shape == c.shape == (2, 12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_cache_capacity_is_checked_before_decoding():
    """The reference's ``dynamic_update_slice`` would clamp a write past
    the cache to its last slot; the port refuses the request."""
    _, eng = engine_for("qwen2-0.5b", max_seq_len=16)
    toks = np.zeros((1, 10), np.int32)
    assert eng.generate(toks, max_new_tokens=6).shape == (1, 16)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(toks, max_new_tokens=7)


def test_ring_buffer_placement():
    """``_ring_place`` puts prefill position j at slot j mod capacity, as
    the reference's does."""
    k = np.arange(2 * 11, dtype=np.float32).reshape(2, 11, 1, 1)
    for cap in (4, 8, 11, 16):
        want = np.asarray(ref_engine._ring_place(jnp.asarray(k), cap))
        got = engine._ring_place(torch.as_tensor(k), cap).numpy()
        np.testing.assert_array_equal(got, want)


def test_engine_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.make_params(cfg)
    m, _ = port_weights("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(cfg, m)
