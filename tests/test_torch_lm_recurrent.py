"""The port's recurrent blocks and recurrent serving against the JAX
package's.

Functions (``repro_torch.models.recurrent`` against
``repro.models.recurrent``): weights and inputs are float32 numpy arrays
from a seeded generator, handed to both packages (JAX's functions
through ``jax.jit``, their runs cached), and every output and state is
held at ``rtol = atol = 1e-5`` in float32 -- an mLSTM's matrix memory
``C`` relative to its largest entry, since it sums outer products whose
scale the stabiliser ``m`` sets.  Bit-identical: the initial states,
the RG-LRU's conv buffer and the associative scan on given inputs.  The
rest differs in the last float32 bits (≤ 6e-7 of the largest magnitude),
XLA's ``tanh``, ``exp``, ``log1p`` and logistic rounding apart from
torch's (ROADMAP §3).

Served models (xlstm-1.3b and recurrentgemma-2b, reduced): the JAX
package's parameters are carried across with ``lm_params_from_reference``
and both packages serve in bfloat16, held as the attention configs are
in ``test_torch_lm_serve.py``: prefill logits, every flattened cache and
state, and 6 teacher-forced decode steps from the port's own cache and
from JAX's, at correlation >= 0.9999 and max |port - JAX| <= 0.02 · max
|JAX|.  Reduced recurrentgemma's prefill logits come out bit-identical
to JAX's.  xlstm is held inside JAX's own measured sensitivity instead
(``test_xlstm_reference_is_ill_conditioned``): its sLSTM is chaotic
(``test_slstm_recurrence_is_chaotic_at_full_width``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.models import recurrent as ref_rec
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.models import common, model, recurrent
from repro_torch.serve import engine

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2


def configs(arch: str, **changes):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


XLSTM = configs("xlstm-1.3b")
GRIFFIN = configs("recurrentgemma-2b")


def weights(schema, seed: int) -> dict:
    """Random float32 numpy weights for a schema, each matrix scaled by
    its contraction width (a 4x4 block's 4, a recurrent head's width), so
    that outputs stay of order 1; biases, scales and decays random."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, d in common.tree_paths(schema):
        shape = d.shape
        if len(shape) == 1:
            w = (1.0 if d.init == "ones" else 0.0) + 0.3 * rng.normal(
                size=shape)
        else:
            w = rng.normal(size=shape) / np.sqrt(shape[-2])
        out[path[-1]] = w.astype(np.float32)
    return out


def normal(seed: int, *shape, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(as_torch(v) for v in tree)
    return torch.as_tensor(np.array(tree))


def close(got, want, what="", relative=False):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    if relative:
        scale = np.abs(want).max()
        got, want = got / scale, want / scale
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def close_state(got, want, names):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == np.shape(w), name
        assert g.dtype == torch.float32, name
        close(g, w, name, relative=name == "C")


# ---------------------------------------------------------------- mLSTM

MLSTM_STATE = ("C", "n", "m")


def mlstm_inputs(s: int, seed: int, with_state: bool):
    _, cfg = XLSTM
    di, h = 2 * cfg.d_model, cfg.num_heads
    k = di // h
    p = weights(recurrent.mlstm_schema(cfg), seed)
    x = normal(seed + 1, B, s, di, scale=0.5)
    state = None
    if with_state:
        state = (normal(seed + 2, B, h, k, k), normal(seed + 3, B, h, k),
                 normal(seed + 4, B, h, scale=2.0))
    return p, x, state


MLSTM_CASES = {
    # name: (S, chunk, incoming state)
    "c4_s11": (11, 4, False),
    "c4_s11_state": (11, 4, True),
    "c256_s11": (11, 256, False),
    "c256_s11_state": (11, 256, True),
    "c4_s12": (12, 4, False),
}


@functools.lru_cache(maxsize=None)
def ref_mlstm_chunkwise(case: str):
    s, chunk, with_state = MLSTM_CASES[case]
    p, x, state = mlstm_inputs(s, 10, with_state)
    h = XLSTM[0].num_heads
    y, st = jax.jit(lambda p, x, st: ref_rec.mlstm_chunkwise(
        p, x, h, chunk, st))(p, x, state)
    return np.asarray(y), tuple(np.asarray(a) for a in st)


@pytest.mark.parametrize("case", sorted(MLSTM_CASES))
def test_mlstm_chunkwise(case):
    s, chunk, with_state = MLSTM_CASES[case]
    p, x, state = mlstm_inputs(s, 10, with_state)
    want_y, want_st = ref_mlstm_chunkwise(case)
    y, st = recurrent.mlstm_chunkwise(
        as_torch(p), as_torch(x), XLSTM[1].num_heads, chunk,
        None if state is None else as_torch(state))
    close(y, want_y, "y")
    close_state(st, want_st, MLSTM_STATE)


def test_mlstm_padding_enters_the_stabiliser():
    """S = 11 in chunks of 4 pads one position with ``log_i = 0``, which
    the carried ``m`` takes as its max where the real gates are below 0:
    the port's ``m`` is JAX's, not what the unpadded 11 positions give."""
    _, want_st = ref_mlstm_chunkwise("c4_s11")
    p, x, _ = mlstm_inputs(11, 10, False)
    h = XLSTM[1].num_heads
    _, st = recurrent.mlstm_chunkwise(as_torch(p), as_torch(x), h, 4)
    _, unpadded = recurrent.mlstm_chunkwise(as_torch(p), as_torch(x[:, :8]),
                                            h, 4)
    close(st[2], want_st[2], "m")
    assert not np.allclose(st[2].numpy(), unpadded[2].numpy())


@functools.lru_cache(maxsize=None)
def ref_mlstm_decode():
    p, _, state = mlstm_inputs(1, 20, True)
    x = normal(21, B, 1, 2 * XLSTM[0].d_model, scale=0.5)
    h = XLSTM[0].num_heads
    y, st = jax.jit(lambda p, x, st: ref_rec.mlstm_decode_step(
        p, x, st, h))(p, x, state)
    return x, np.asarray(y), tuple(np.asarray(a) for a in st)


def test_mlstm_decode_step():
    p, _, state = mlstm_inputs(1, 20, True)
    x, want_y, want_st = ref_mlstm_decode()
    state = as_torch(state)
    c, n = state[0], state[1]
    y, st = recurrent.mlstm_decode_step(as_torch(p), as_torch(x), state,
                                        XLSTM[1].num_heads)
    close(y, want_y, "y")
    close_state(st, want_st, MLSTM_STATE)
    assert st[0] is not c                     # a new C; the old stays


@functools.lru_cache(maxsize=None)
def ref_mlstm_block(decode: bool):
    ref_cfg, cfg = XLSTM
    p, _, state = mlstm_inputs(1, 30, decode)
    s = 1 if decode else 9
    x = normal(31, B, s, cfg.d_model)
    y, st = jax.jit(lambda p, x, st: ref_rec.mlstm_block(
        ref_cfg, p, x, chunk=4, state=st, decode=decode))(p, x, state)
    return p, x, state, np.asarray(y), tuple(np.asarray(a) for a in st)


@pytest.mark.parametrize("decode", [False, True])
def test_mlstm_block(decode):
    p, x, state, want_y, want_st = ref_mlstm_block(decode)
    y, st = recurrent.mlstm_block(
        XLSTM[1], as_torch(p), as_torch(x), chunk=4, decode=decode,
        state=None if state is None else as_torch(state))
    close(y, want_y, "y")
    close_state(st, want_st, MLSTM_STATE)


# ---------------------------------------------------------------- sLSTM

SLSTM_STATE = ("c", "n", "h", "m")


def slstm_inputs(s: int, seed: int, with_state: bool):
    _, cfg = XLSTM
    h, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
    p = weights(recurrent.slstm_schema(cfg), seed)
    x = normal(seed + 1, B, s, cfg.d_model)
    state = None
    if with_state:
        state = (normal(seed + 2, B, h, hd),
                 np.abs(normal(seed + 3, B, h, hd)) + 0.5,
                 normal(seed + 4, B, h, hd, scale=0.5),
                 normal(seed + 5, B, h, hd))
    return p, x, state


SLSTM_CASES = {
    # name: (function, S, incoming state)
    "scan": ("slstm_scan", 9, False),
    "scan_state": ("slstm_scan", 9, True),
    "block": ("slstm_block", 9, False),
    "block_decode": ("slstm_block", 1, True),
}


@functools.lru_cache(maxsize=None)
def ref_slstm(case: str):
    fn, s, with_state = SLSTM_CASES[case]
    p, x, state = slstm_inputs(s, 40, with_state)
    ref_cfg = XLSTM[0]
    if fn == "slstm_scan":
        run = lambda p, x, st: ref_rec.slstm_scan(ref_cfg, p, x, st)
    else:
        run = lambda p, x, st: ref_rec.slstm_block(ref_cfg, p, x, state=st)
    y, st = jax.jit(run)(p, x, state)
    return np.asarray(y), tuple(np.asarray(a) for a in st)


@pytest.mark.parametrize("case", sorted(SLSTM_CASES))
def test_slstm(case):
    fn, s, with_state = SLSTM_CASES[case]
    p, x, state = slstm_inputs(s, 40, with_state)
    want_y, want_st = ref_slstm(case)
    state = None if state is None else as_torch(state)
    if fn == "slstm_scan":
        y, st = recurrent.slstm_scan(XLSTM[1], as_torch(p), as_torch(x),
                                     state)
    else:
        y, st = recurrent.slstm_block(XLSTM[1], as_torch(p), as_torch(x),
                                      state=state)
    close(y, want_y, "y")
    close_state(st, want_st, SLSTM_STATE)


# ---------------------------------------------------------------- RG-LRU

RGLRU_STATE = ("conv", "h")

RGLRU_CORE_CASES = {
    # name: (S, h0)
    "s1": (1, False),
    "s8": (8, False),
    "s13": (13, False),
    "s13_h0": (13, True),
    "s16_h0": (16, True),
}


def rglru_core_inputs(s: int, with_h0: bool):
    _, cfg = GRIFFIN
    p = weights(recurrent.rglru_schema(cfg), 50)
    u = normal(51, B, s, cfg.lru_width)
    h0 = normal(52, B, cfg.lru_width) if with_h0 else None
    return p, u, h0


@functools.lru_cache(maxsize=None)
def ref_rglru_core(case: str):
    p, u, h0 = rglru_core_inputs(*RGLRU_CORE_CASES[case])
    h, last = jax.jit(ref_rec._rglru_core)(p, u, h0)
    return np.asarray(h), np.asarray(last)


@pytest.mark.parametrize("case", sorted(RGLRU_CORE_CASES))
def test_rglru_core(case):
    p, u, h0 = rglru_core_inputs(*RGLRU_CORE_CASES[case])
    want_h, want_last = ref_rglru_core(case)
    h, last = recurrent._rglru_core(as_torch(p), as_torch(u),
                                    None if h0 is None else as_torch(h0))
    close(h, want_h, "h")
    close(last, want_last, "h[-1]")


RGLRU_BLOCK_CASES = {
    # name: (S, decode, incoming state)
    "prefill": (10, False, False),
    "prefill_state": (7, False, True),
    "decode": (1, True, True),
}


def rglru_block_inputs(s: int, with_state: bool):
    _, cfg = GRIFFIN
    p = weights(recurrent.rglru_schema(cfg), 60)
    x = normal(61, B, s, cfg.d_model)
    state = None
    if with_state:
        state = (normal(62, B, cfg.conv1d_width - 1, cfg.lru_width),
                 normal(63, B, cfg.lru_width))
    return p, x, state


@functools.lru_cache(maxsize=None)
def ref_rglru_block(case: str):
    s, decode, with_state = RGLRU_BLOCK_CASES[case]
    p, x, state = rglru_block_inputs(s, with_state)
    y, st = jax.jit(lambda p, x, st: ref_rec.rglru_block(
        GRIFFIN[0], p, x, state=st, decode=decode))(p, x, state)
    return np.asarray(y), tuple(np.asarray(a) for a in st)


@pytest.mark.parametrize("case", sorted(RGLRU_BLOCK_CASES))
def test_rglru_block(case):
    s, decode, with_state = RGLRU_BLOCK_CASES[case]
    p, x, state = rglru_block_inputs(s, with_state)
    want_y, want_st = ref_rglru_block(case)
    y, st = recurrent.rglru_block(
        GRIFFIN[1], as_torch(p), as_torch(x), decode=decode,
        state=None if state is None else as_torch(state))
    close(y, want_y, "y")
    close_state(st, want_st, RGLRU_STATE)
    np.testing.assert_array_equal(st[0].numpy(), want_st[0])   # conv


@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 16, 33])
def test_associative_scan_is_the_reference_recursion(n):
    """The odd/even recursion in float32 equals JAX's bit for bit."""
    a = np.random.default_rng(n).random((2, n, 5)).astype(np.float32)
    b = normal(n + 100, 2, n, 5)
    def combine(x, y):                    # the reference's operator
        return x[0] * y[0], y[0] * x[1] + y[1]

    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    got = recurrent.associative_scan((torch.as_tensor(a),
                                      torch.as_tensor(b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- states

def test_init_reads_the_leading_axis_as_fan_in():
    """``make_params`` draws as the reference's ``_materialize`` does,
    taking ``shape[0]`` as the fan-in: the (nb, 4, 4) q/k/v blocks at
    std sqrt(1 / nb) (1/32 at full width), the sLSTM's (H, hd, 4·hd)
    recurrent weights at sqrt(1 / H) = 0.5, the RG-LRU's conv taps and
    decay at 0.02."""
    for arch in ("xlstm-1.3b", "recurrentgemma-2b"):
        sd = model.make_params(get_config(arch).reduced(), seed=3,
                               device="cpu").state_dict()
        for name, t in sd.items():
            leaf = name.split(".")[-1]
            want = {"wq": t.shape[0] ** -0.5, "wk": t.shape[0] ** -0.5,
                    "wv": t.shape[0] ** -0.5, "r_gates": 0.5,
                    "conv_w": 0.02, "lam": 0.02}.get(leaf)
            if want is not None:
                assert abs(float(t.std()) / want - 1) < 0.1, (name, t.std())


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_init_states(kind):
    ref_cfg, cfg = GRIFFIN if kind == "rglru" else XLSTM
    want = jax.jit(lambda: getattr(ref_rec, f"{kind}_init_state")(
        ref_cfg, 3))()
    got = getattr(recurrent, f"{kind}_init_state")(cfg, 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # no two entries share storage: the decode may update one in place
    ptrs = [g.untyped_storage().data_ptr() for g in got]
    assert len(set(ptrs)) == len(ptrs)


# ---------------------------------------------------------------- properties

def test_causality():
    """Changing tokens after position t changes no hidden state at or
    before t, in the port's forward of either recurrent model (mLSTM in
    chunks of 4, so the carried state crosses chunk boundaries)."""
    for _, cfg in (XLSTM, GRIFFIN):
        params = model.make_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        s, t = 24, 11
        toks = rng.integers(0, cfg.vocab_size, (1, s))
        toks2 = toks.copy()
        toks2[:, t + 1:] = rng.integers(0, cfg.vocab_size, (1, s - t - 1))
        outs = [model.forward(cfg, params, {"tokens": torch.as_tensor(tk)},
                              q_chunk=8, rec_chunk=4)[0][:, :t + 1]
                for tk in (toks, toks2)]
        assert torch.equal(outs[0], outs[1]), cfg.name


def test_mlstm_chunkwise_equals_sequential():
    """The chunkwise form over 13 positions in chunks of 4 against 13
    decode steps from the initial state (the reference's bound)."""
    _, cfg = XLSTM
    p = as_torch(weights(recurrent.mlstm_schema(cfg), 70))
    x = torch.as_tensor(normal(71, B, 13, 2 * cfg.d_model, scale=0.3))
    y_par, _ = recurrent.mlstm_chunkwise(p, x, cfg.num_heads, chunk=4)
    state = recurrent.mlstm_init_state(cfg, B)
    ys = []
    for t in range(13):
        yt, state = recurrent.mlstm_decode_step(p, x[:, t:t + 1], state,
                                                cfg.num_heads)
        ys.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-5)


def test_rglru_scan_equals_sequential():
    """The RG-LRU block's associative scan over 9 positions against 9
    decode steps (the reference's bound)."""
    _, cfg = GRIFFIN
    p = as_torch(weights(recurrent.rglru_schema(cfg), 72))
    x = torch.as_tensor(normal(73, B, 9, cfg.d_model, scale=0.5))
    y_par, _ = recurrent.rglru_block(cfg, p, x)
    state = recurrent.rglru_init_state(cfg, B)
    ys = []
    for t in range(9):
        yt, state = recurrent.rglru_block(cfg, p, x[:, t:t + 1],
                                          state=state, decode=True)
        ys.append(yt)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------- serving

ARCHS = ["xlstm-1.3b", "recurrentgemma-2b", "recurrentgemma-ring"]
STEPS = 6
P, CAPACITY, Q_CHUNK = 12, 24, 8
CORR, REL = 0.9999, 0.02
#: xlstm's prefill logits and states, and its decode from the port's own
#: prefill: inside the reference's own sensitivity to one bfloat16 step
#: of one input element (``test_xlstm_reference_is_ill_conditioned``)
XLSTM_PREFILL, XLSTM_OWN_DECODE = (0.9997, 0.035), (0.997, 0.1)


def served_configs(arch: str):
    if arch == "recurrentgemma-ring":
        # the local-attention layer's window of 8 under a 12-token prompt
        return configs("recurrentgemma-2b", window=8)
    return configs(arch)


def f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def deviation(got, want) -> tuple:
    """(correlation, max |got - want| / max |want|)."""
    got, want = f32(got).ravel(), f32(want).ravel()
    c = np.corrcoef(got, want)[0, 1] if np.ptp(want) > 0 else 1.0
    return c, np.abs(got - want).max() / np.abs(want).max()


def hold(got, want, bound=(CORR, REL), what=""):
    c, d = deviation(got, want)
    assert c >= bound[0] and d <= bound[1], (
        f"{what}: corr {c:.7f} (>= {bound[0]}), max diff / max {d:.5f} "
        f"(<= {bound[1]})")


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """JAX's parameters, prefill (its caches and its engine's decode
    cache) and 6 greedy decode steps, bfloat16 activations."""
    ref_cfg, _ = served_configs(arch)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda: ref_model.make_params(ref_cfg, 0))())
    tokens = np.random.default_rng(0).integers(
        0, ref_cfg.vocab_size, (B, P)).astype(np.int32)

    def prefill(params, toks):
        logits, caches = ref_model.serve_prefill(
            ref_cfg, params, {"tokens": toks}, q_chunk=Q_CHUNK)
        return logits, caches, ref_engine.prefill_to_decode_cache(
            ref_cfg, caches, P, CAPACITY, params=params)

    logits, caches, cache = jax.jit(prefill)(tree, tokens)
    first_cache = jax.tree.map(np.asarray, cache)
    decode = jax.jit(functools.partial(ref_model.decode_step, ref_cfg))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks, step_logits = [], []
    for _ in range(STEPS):
        toks.append(np.asarray(tok))
        out, cache = decode(tree, tok, cache)
        step_logits.append(f32(out)[:, 0, :ref_cfg.vocab_size])
        tok = jnp.argmax(out[:, -1], -1).astype(jnp.int32)[:, None]
    return dict(tree=tree, tokens=tokens,
                logits=f32(logits)[:, 0, :ref_cfg.vocab_size],
                caches=jax.tree.map(np.asarray, caches), cache=first_cache,
                step_tokens=toks, step_logits=step_logits)


@functools.lru_cache(maxsize=None)
def port_weights(arch: str):
    _, cfg = served_configs(arch)
    m = model.LanguageModel(cfg, device="cpu")
    m.load_state_dict(lm_params_from_reference(cfg, reference(arch)["tree"]))
    return m, model.compute_copy(m)


def _flat(entry) -> dict:
    """A prefill cache entry's arrays by name (a state tuple by index)."""
    if "state" in entry:
        return {f"state{i}": a for i, a in enumerate(entry["state"])}
    return entry


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_states(arch):
    _, cfg = served_configs(arch)
    ref = reference(arch)
    _, w = port_weights(arch)
    logits, caches = model.serve_prefill(
        cfg, w, {"tokens": torch.as_tensor(ref["tokens"])}, q_chunk=Q_CHUNK)
    bound = XLSTM_PREFILL if arch == "xlstm-1.3b" else (CORR, REL)
    hold(logits[:, 0, :cfg.vocab_size], ref["logits"], bound, "prefill")
    want = lm_cache_from_reference(cfg, ref["caches"])
    assert len(caches) == len(want) == cfg.num_layers
    for i, (got, exp) in enumerate(zip(caches, want)):
        got, exp = _flat(got), _flat(exp)
        assert sorted(got) == sorted(exp)
        for key in got:
            assert got[key].shape == exp[key].shape
            assert got[key].dtype == exp[key].dtype, (i, key)
            hold(got[key], exp[key], bound, f"layer {i} {key}")


@pytest.mark.parametrize("start", ["own_cache", "reference_cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode(arch, start):
    _, cfg = served_configs(arch)
    ref = reference(arch)
    _, w = port_weights(arch)
    if start == "own_cache":
        _, caches = model.serve_prefill(
            cfg, w, {"tokens": torch.as_tensor(ref["tokens"])},
            q_chunk=Q_CHUNK)
        cache = engine.prefill_to_decode_cache(cfg, caches, P, CAPACITY)
    else:
        cache = lm_cache_from_reference(cfg, ref["cache"])
    want_cache = lm_cache_from_reference(cfg, ref["cache"])
    for got, exp in zip(cache["layers"], want_cache["layers"]):
        assert sorted(got) == sorted(exp)
        for key in got:
            assert got[key].shape == exp[key].shape
            assert got[key].dtype == exp[key].dtype
    bound = (XLSTM_OWN_DECODE if (arch, start) == ("xlstm-1.3b", "own_cache")
             else (CORR, REL))
    for step, (tok, want) in enumerate(zip(ref["step_tokens"],
                                           ref["step_logits"])):
        logits, cache = model.decode_step(cfg, w, torch.tensor(tok), cache)
        hold(logits[:, 0, :cfg.vocab_size], want, bound, f"step {step}")
    assert cache["pos"] == P + STEPS


def test_xlstm_reference_is_ill_conditioned():
    """The measurement behind xlstm's bounds: one bfloat16 step in one
    element of the embedding row of a prompt token (row 38, column 34)
    moves JAX's *own* prefill logits, prefill states and teacher-forced
    decode logits past the bounds the port is held to.  The mLSTM's
    exponential input gate turns a relative change in its pre-activation
    into the same relative change of everything it writes to ``C``."""
    ref_cfg, cfg = served_configs("xlstm-1.3b")
    ref = reference("xlstm-1.3b")
    assert 38 in ref["tokens"]
    tree = dict(ref["tree"])
    emb = np.array(tree["embed"])
    step = jnp.nextafter(jnp.asarray(emb[38, 34], jnp.bfloat16),
                         jnp.bfloat16(100))
    emb[38, 34] = float(step.astype(jnp.float32))
    tree["embed"] = emb

    def prefill(params, toks):
        logits, caches = ref_model.serve_prefill(
            ref_cfg, params, {"tokens": toks}, q_chunk=Q_CHUNK)
        return logits, caches, ref_engine.prefill_to_decode_cache(
            ref_cfg, caches, P, CAPACITY, params=params)

    logits, caches, cache = jax.jit(prefill)(tree, ref["tokens"])
    pre = deviation(f32(logits)[:, 0, :ref_cfg.vocab_size], ref["logits"])
    states = [deviation(a, b) for a, b in zip(
        jax.tree.leaves(caches), jax.tree.leaves(ref["caches"]))]
    decode = jax.jit(functools.partial(ref_model.decode_step, ref_cfg))
    steps = []
    for tok, want in zip(ref["step_tokens"], ref["step_logits"]):
        out, cache = decode(tree, jnp.asarray(tok), cache)
        steps.append(deviation(f32(out)[:, 0, :ref_cfg.vocab_size], want))
    worst = lambda devs: (min(d[0] for d in devs), max(d[1] for d in devs))
    print("xlstm, one bfloat16 step in embed[38, 34]: " + "; ".join(
        f"{what} corr {c:.7f} max diff / max {d:.4f}" for what, (c, d) in (
            ("prefill", pre), ("states", worst(states)),
            ("decode", worst(steps)))))
    for (c, d), (corr, rel) in ((pre, XLSTM_PREFILL),
                                (worst(states), XLSTM_PREFILL),
                                (worst(steps), XLSTM_OWN_DECODE)):
        assert c < corr and d > rel


def test_slstm_recurrence_is_chaotic_at_full_width():
    """The reference's fan-in rule (``_materialize`` reads ``shape[0]``)
    draws the sLSTM's recurrent weights ``(H, hd, 4·hd)`` at std
    sqrt(1 / H) = 0.5, so the recurrence's gain is ~0.5·sqrt(hd), 11 at
    full width: one float32 step in one input element of JAX's own
    full-width sLSTM scan grows from ~1e-7 to past 1e-2 of the output's
    largest magnitude within 32 positions, and the port's scan does the
    same.  No two paths that round apart can be held to each other over
    a long prompt of this model (``chip_smoke.py`` holds xlstm's card
    path stepwise)."""
    ref_cfg = ref_get_config("xlstm-1.3b")
    schema = ref_rec.slstm_schema(ref_cfg)
    p = jax.tree.map(np.asarray, jax.jit(lambda: ref_common.init_params(
        schema, jax.random.PRNGKey(0)))())
    assert abs(p["r_gates"].std() - 0.5) < 0.01
    x = normal(80, 1, 32, ref_cfg.d_model)
    x2 = x.copy()
    x2[0, 0, 5] = np.nextafter(x2[0, 0, 5], np.float32(100))
    scan = jax.jit(lambda p, x: ref_rec.slstm_scan(ref_cfg, p, x)[0])
    ports = [recurrent.slstm_scan(get_config("xlstm-1.3b"), as_torch(p),
                                  torch.as_tensor(v))[0].numpy()
             for v in (x, x2)]
    for a, b in ((np.asarray(scan(p, x)), np.asarray(scan(p, x2))), ports):
        grow = np.abs(a - b).max(axis=(0, 2)) / np.abs(a).max()
        assert grow[0] < 1e-6 and grow[-1] > 1e-2, grow


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_is_repeatable(arch):
    _, cfg = served_configs(arch)
    m, _ = port_weights(arch)
    eng = engine.ServeEngine(cfg, m, max_seq_len=P + 8, q_chunk=Q_CHUNK,
                             device="cpu")
    toks = reference(arch)["tokens"]
    out = eng.generate(toks, max_new_tokens=6)
    np.testing.assert_array_equal(out, eng.generate(toks, max_new_tokens=6))
    assert out.shape == (B, P + 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, :P], toks)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    # greedy: the first new token is the prefill's argmax, as JAX's
    np.testing.assert_array_equal(out[:, P], reference(arch)["step_tokens"][
        0][:, 0])


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-2b"])
def test_prefill_vs_decode(arch):
    """prefill(P) against prefill(P - 1) plus one decode step, the port
    on JAX's weights: corr > 0.999, the reference's own bound
    (``tests/test_serve.py``); RG-LRU prefills in bfloat16 and decodes in
    float32, so the two are close, not equal."""
    _, cfg = served_configs(arch)
    _, w = port_weights(arch)
    toks = torch.as_tensor(reference(arch)["tokens"]).long()
    full = engine.teacher_forced_logits(cfg, w, {"tokens": toks},
                                        toks[:, :0], capacity=CAPACITY,
                                        q_chunk=Q_CHUNK)[0]
    step = engine.teacher_forced_logits(cfg, w, {"tokens": toks[:, :-1]},
                                        toks[:, -1:], capacity=CAPACITY,
                                        q_chunk=Q_CHUNK)[-1]
    a = f32(full[:, :cfg.vocab_size]).ravel()
    b = f32(step[:, :cfg.vocab_size]).ravel()
    corr = np.corrcoef(a, b)[0, 1]
    print(f"{arch}: prefill vs prefill + decode corr {corr:.6f}")
    assert corr > 0.999


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-2b"])
def test_compute_copy_dtypes(arch):
    """Every leaf in the dtype the forward reads it in: float32 for norms
    and ``F32_LEAVES``, float32 plus a bfloat16 twin for the RG-LRU gate
    matrices, bfloat16 for the rest."""
    _, cfg = served_configs(arch)
    m, c = port_weights(arch)
    twins = 0
    for name, p in c.named_parameters():
        parts = name.split(".")
        if parts[-1].endswith("_bf16"):
            twins += 1
            src = m.get_parameter(name[:-len("_bf16")])
            assert p.dtype == torch.bfloat16
            assert torch.equal(p, src.to(torch.bfloat16))
            continue
        f32_leaf = (any(part in model.NORMS for part in parts)
                    or parts[-1] in recurrent.F32_LEAVES
                    or parts[-1] in recurrent.TWO_DTYPE_LEAVES)
        assert p.dtype == (torch.float32 if f32_leaf else torch.bfloat16), \
            name
        assert torch.equal(p, m.get_parameter(name).to(p.dtype))
    rglru = sum(kind == "rglru" for kind, _ in model.layer_sigs(cfg))
    assert twins == 2 * rglru
