"""The port's LM modules against the JAX package's, module by module.

Inputs and weights are float32 numpy arrays from a seeded generator,
handed to both packages (JAX's functions through ``jax.jit``).  Every
output is held with ``rtol = atol = 1e-5`` in float32: the two packages
sum matrix products in different orders, which moves float32 results in
the last digits, never by 1e-5 at these widths.  The MoE's integer
metrics (``expert_load``, ``dropped_tokens``) and an int8 KV cache must be
exactly equal.  Layer signatures, groups and the full configs' parameter
counts must be equal for every registered architecture; the recurrent
ones must raise in the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import ffn as ref_ffn
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch.configs import all_configs, get_config
from repro_torch.models import attention, common, ffn, model, moe

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = sorted(ref_all_configs())
RECURRENT = ("recurrentgemma-2b", "xlstm-1.3b")


def configs(arch: str, **changes):
    """The reduced config of ``arch`` in both packages, with ``changes``."""
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def weights(schema, seed: int) -> dict:
    """Random float32 numpy weights for a port schema, scaled by each
    matrix's contraction width so that outputs stay of order 1; biases
    and norm scales random too, so that every term is exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, d in common.tree_paths(schema):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        name, shape = path[-1], d.shape
        if len(shape) == 1 or name.startswith("b"):     # scales, biases
            w = (1.0 if d.init == "ones" else 0.0) + 0.1 * rng.normal(
                size=shape)
        else:
            fan_in = {"wo": shape[0] * shape[1]}.get(
                name, shape[1] if len(shape) == 3 and "w_" in name
                else shape[0])
            w = rng.normal(size=shape) / np.sqrt(fan_in)
        node[name] = w.astype(np.float32)
    return out


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------- common

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    ref_cfg, cfg = configs("stablelm-12b", norm=norm)
    p = {"scale": scale, "bias": bias} if norm == "layernorm" else {
        "scale": scale}
    want = jax.jit(lambda p, x: ref_common.apply_norm(ref_cfg, p, x))(p, x)
    close(common.apply_norm(cfg, as_torch(p), torch.as_tensor(x)), want)


def test_rope_and_mrope():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    pos3 = rng.integers(0, 500, (3, 2, 7)).astype(np.int32)
    want = jax.jit(lambda x, p: ref_common.apply_rope(x, p, 1e4))(x, pos)
    close(common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4),
          want)
    want = jax.jit(lambda x, p: ref_common.apply_mrope(x, p, 1e6))(x, pos3)
    close(common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3),
                             1e6), want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "sq_relu"])
def test_ffn_activations(act):
    ref_cfg, cfg = configs("qwen2-0.5b", ffn_activation=act)
    p = weights(ffn.ffn_schema(cfg), 2)
    x = np.random.default_rng(3).normal(size=(2, 6, 128)).astype(np.float32)
    want = jax.jit(lambda p, x: ref_ffn.apply_ffn(ref_cfg, p, x))(p, x)
    close(ffn.apply_ffn(cfg, as_torch(p), torch.as_tensor(x)), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_is_jax_gelu(dtype):
    """The tanh approximation, in bfloat16 op by op as XLA rounds it."""
    x = torch.linspace(-6, 6, 1001).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x.float().numpy()).astype(jdt))
    tol = TOL if dtype == torch.float32 else dict(rtol=0, atol=0)
    close(ffn.gelu(x), want, **tol)
    assert abs(float(ffn.gelu(torch.tensor(1.0))) - 0.841192) < 1e-6


# ---------------------------------------------------------------- attention

ATTN_CASES = {
    # name: (arch, config changes, seq len, q_chunk, window, cross)
    "full": ("nemotron-4-15b", {}, 12, 4, 0, False),
    "local_w8_ragged": ("qwen2-0.5b", {"window": 8}, 21, 5, 8, False),
    "cross": ("seamless-m4t-medium", {}, 9, 4, 0, True),
    "gqa_bias": ("qwen2-0.5b", {}, 10, 16, 0, False),
    "mrope": ("qwen2-vl-2b", {}, 8, 3, 0, False),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case):
    arch, changes, s, q_chunk, window, cross = ATTN_CASES[case]
    ref_cfg, cfg = configs(arch, **changes)
    p = weights(attention.attn_schema(cfg), 4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    if cfg.rope_variant == "mrope":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, 2, s)).copy()
    else:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    kw = dict(layer_window=window, q_chunk=q_chunk)
    xkv = kv_pos = None
    if cross:
        xkv = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
        kv_pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
        kw["causal"] = False

    def ref(p, x, pos, xkv, kv_pos):
        return ref_attn.attention(ref_cfg, p, x, positions=pos, xkv=xkv,
                                  kv_positions=kv_pos, **kw)

    want = jax.jit(ref)(p, x, pos, xkv, kv_pos)
    t = (lambda a: None if a is None else torch.as_tensor(a))
    got = attention.attention(cfg, as_torch(p), t(x), positions=t(pos),
                              xkv=t(xkv), kv_positions=t(kv_pos), **kw)
    close(got, want)


DECODE_CASES = {
    # name: (arch, changes, cache length, pos, window, kv_quant, cross)
    "full": ("qwen2-0.5b", {}, 16, 9, 0, False, False),
    "ring_past_window": ("qwen2-0.5b", {"window": 8}, 16, 13, 8, False,
                         False),
    "kv_quant": ("nemotron-4-15b", {}, 16, 5, 0, True, False),
    "cross": ("seamless-m4t-medium", {}, 16, 4, 0, False, True),
    "mrope": ("qwen2-vl-2b", {}, 12, 11, 0, False, False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention(case):
    arch, changes, length, pos, window, quant, cross = DECODE_CASES[case]
    ref_cfg, cfg = configs(arch, **changes)
    p = weights(attention.attn_schema(cfg), 6)
    rng = np.random.default_rng(7)
    b = 2
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    cache = attention.init_kv_cache(cfg, b, length, window, torch.float32,
                                    kv_quant=quant)
    fill = min(pos, cache["k"].shape[1])
    for key in ("k", "v"):
        vals = rng.normal(size=cache[key][:, :fill].shape) * 2
        if quant:
            cache[key][:, :fill] = torch.as_tensor(
                np.clip(np.round(vals * 40), -127, 127)).to(torch.int8)
            cache[f"{key}_scale"][:, :fill] = torch.as_tensor(
                rng.random(cache[f"{key}_scale"][:, :fill].shape) * 0.05
                + 0.01, dtype=torch.float32)
        else:
            cache[key][:, :fill] = torch.as_tensor(vals, dtype=torch.float32)
    ref_cache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    cross_kv = None
    if cross:
        cross_kv = {k: rng.normal(size=(b, 7, cfg.num_kv_heads,
                                        cfg.head_dim)).astype(np.float32)
                    for k in ("k", "v")}

    def ref(p, x, c, ckv):
        return ref_attn.decode_attention(ref_cfg, p, x, c, pos,
                                         layer_window=window, cross_kv=ckv)

    want, want_cache = jax.jit(ref)(p, x, ref_cache, cross_kv)
    got, got_cache = attention.decode_attention(
        cfg, as_torch(p), torch.as_tensor(x), cache, pos,
        layer_window=window,
        cross_kv=None if cross_kv is None else as_torch(cross_kv))
    close(got, want)
    for key, val in want_cache.items():
        if quant and key in ("k", "v"):
            np.testing.assert_array_equal(got_cache[key].numpy(),
                                          np.asarray(val))
        else:
            close(got_cache[key], val)


# ---------------------------------------------------------------- moe

MOE_CASES = {
    # name: (arch, groups, capacity factor, tokens (b, s))
    "g1": ("granite-moe-3b-a800m", 1, 1.25, (2, 12)),
    "g2": ("granite-moe-3b-a800m", 2, 1.25, (2, 12)),
    "shared_g2": ("deepseek-moe-16b", 2, 1.25, (2, 10)),
    "drops": ("granite-moe-3b-a800m", 1, 0.5, (3, 16)),
    "drops_shared_g2": ("deepseek-moe-16b", 2, 0.3, (2, 16)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe(case):
    arch, groups, cf, (b, s) = MOE_CASES[case]
    ref_cfg, cfg = configs(arch)
    p = weights(moe.moe_schema(cfg), 8)
    p["router"] = p["router"] * 30          # decisive, varied routing
    x = np.random.default_rng(9).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    want, want_m = jax.jit(lambda p, x: ref_moe.apply_moe(
        ref_cfg, p, x, capacity_factor=cf, groups=groups))(p, x)
    got, got_m = moe.apply_moe(cfg, as_torch(p), torch.as_tensor(x),
                               capacity_factor=cf, groups=groups)
    close(got, want)
    for key in ("expert_load", "dropped_tokens"):
        np.testing.assert_array_equal(got_m[key].numpy(),
                                      np.asarray(want_m[key]))
    for key in ("moe_aux_loss", "moe_z_loss"):
        close(got_m[key], want_m[key])
    if cf < 1:
        assert int(got_m["dropped_tokens"]) > 0


def test_moe_ties_pick_the_lower_expert():
    """Equal router probabilities: both packages keep the lower expert
    index first, as ``jax.lax.top_k`` does."""
    ref_cfg, cfg = configs("granite-moe-3b-a800m")
    p = weights(moe.moe_schema(cfg), 10)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(11).normal(size=(1, 4, cfg.d_model)).astype(
        np.float32)
    _, want_m = jax.jit(lambda p, x: ref_moe.apply_moe(ref_cfg, p, x))(p, x)
    _, got_m = moe.apply_moe(cfg, as_torch(p), torch.as_tensor(x))
    np.testing.assert_array_equal(got_m["expert_load"].numpy(),
                                  np.asarray(want_m["expert_load"]))
    assert got_m["expert_load"].tolist() == [4, 4, 0, 0]


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("arch", ARCHS)
def test_layer_structure(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    for n in (None, 1, 5):
        assert model.layer_sigs(cfg, n) == ref_model.layer_sigs(ref_cfg, n)
        assert (model.layer_groups(cfg, n)
                == ref_model.layer_groups(ref_cfg, n))
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        ref_cfg.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts(arch):
    """Full configs, counted from the schema without allocation."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    if arch in RECURRENT:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cfg.param_count()
        return
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()


def test_registry_is_the_reference_registry():
    assert sorted(all_configs()) == ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config(arch))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_blocks_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.make_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_cache(cfg, 1, 8)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in RECURRENT])
def test_module_matches_the_schema(arch):
    """The port's per-layer module holds the reference schema's leaves,
    un-stacked: the same names and sizes, the same total."""
    cfg = get_config(arch).reduced()
    m = model.LanguageModel(cfg, device="meta")
    assert sum(p.numel() for p in m.parameters()) == model.count_params(cfg)
    leaves = {name.split(".")[-1] for name, _ in m.named_parameters()}
    want = {path[-1] for path, _ in common.tree_paths(
        model.param_schema(cfg))}
    assert leaves == want


@functools.lru_cache(maxsize=None)
def _seeded(arch: str, seed: int):
    return model.make_params(get_config(arch).reduced(), seed=seed,
                             device="cpu").state_dict()


def test_init_recipes_and_seeds():
    """The reference's recipes from a torch generator: ones, zeros, std 1
    for the embedding, 0.02 for the router, fan-in for the matrices;
    the same seed gives the same values, another seed others."""
    sd = _seeded("deepseek-moe-16b", 0)
    assert torch.equal(sd["layers.0.norm1.scale"],
                       torch.ones_like(sd["layers.0.norm1.scale"]))
    assert abs(float(sd["embed"].std()) - 1.0) < 0.01
    assert abs(float(sd["layers.1.moe.router"].std()) - 0.02) < 0.002
    w = sd["layers.0.mixer.wq"]
    assert abs(float(w.std()) - (1 / np.sqrt(w.shape[0]))) < 0.005
    again = _seeded("deepseek-moe-16b", 0)
    other = _seeded("deepseek-moe-16b", 1)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["embed"], other["embed"])


def test_compute_copy_keeps_norms_in_float32():
    cfg = get_config("seamless-m4t-medium").reduced()
    m = model.make_params(cfg, device="cpu")
    c = model.compute_copy(m)
    for name, p in c.named_parameters():
        norm = any(part in model.NORMS for part in name.split("."))
        assert p.dtype == (torch.float32 if norm else torch.bfloat16), name
        assert torch.equal(p.float(), m.get_parameter(name).to(
            p.dtype).float())
