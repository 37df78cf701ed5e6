"""The port's serving path on the card against its own CPU path.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  Run them on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_lm_cuda.py

The reduced config of each attention architecture (and reduced qwen2
with a local-attention ring), with seeded random weights, is served on
the card and on the CPU: the prefill's next-token logits and 6 decode
steps teacher-forced with the card's greedy tokens are held to the CPU's
at correlation ≥ 0.9999 and max |card - CPU| ≤ 0.02 · max |CPU| (cuBLAS
and the CPU sum bfloat16 products in float32 in different orders).
Reduced seamless-m4t-medium is ill-conditioned — one bfloat16 step of
one input element moves the JAX package's own decode logits to a
correlation of 0.90 (``test_seamless_reference_is_ill_conditioned`` in
``test_torch_lm_serve.py``) — and is held as there: correlation ≥ 0.94,
max difference ≤ 0.5 · max.  One MoE layer in
float32 (TF32 off) must route identically on both: equal
``expert_load`` and ``dropped_tokens``, outputs within 1e-4 of their
largest magnitude (the reference's fan-in recipe reads an expert stack's
leading axis, so outputs reach the hundreds and float32 sums in two
orders differ by more than 1e-4 absolute).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model, moe
from repro_torch.serve import engine

pytestmark = pytest.mark.cuda

ARCHS = ["qwen2-0.5b", "qwen2.5-32b", "nemotron-4-15b", "stablelm-12b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "qwen2-vl-2b",
         "seamless-m4t-medium", "qwen2-ring"]
B, P, STEPS, Q_CHUNK = 2, 12, 6, 8
ILL_CONDITIONED = {"seamless-m4t-medium": (0.94, 0.5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def config(arch: str):
    if arch == "qwen2-ring":
        return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                   block_pattern=("attn", "local_attn"),
                                   window=8)
    return get_config(arch).reduced()


def batch_on(cfg, device, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, P)))}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.as_tensor(
            rng.normal(size=(B, 8, cfg.d_model)), dtype=torch.bfloat16)
    if cfg.modality == "vlm":
        batch["vision_embeds"] = torch.as_tensor(
            rng.normal(size=(B, P, cfg.d_model)), dtype=torch.bfloat16)
        batch["vision_mask"] = torch.as_tensor(rng.random((B, P)) < 0.25)
        batch["positions3"] = torch.arange(P).expand(3, B, P)
    return {k: v.to(device) for k, v in batch.items()}


def hold(got, want, corr, rel, what):
    got = got.float().cpu().numpy().ravel()
    want = want.float().cpu().numpy().ravel()
    scale = np.abs(want).max()
    c = np.corrcoef(got, want)[0, 1]
    d = np.abs(got - want).max()
    assert c >= corr and d <= rel * scale, (what, c, d, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_the_card_matches_the_cpu(cuda, arch):
    cfg = config(arch)
    params = model.make_params(cfg, seed=0, device="cpu")
    cpu_w = model.compute_copy(params)
    card_w = model.compute_copy(params, device=cuda)
    eng = engine.ServeEngine(cfg, params, max_seq_len=P + STEPS + 4,
                             q_chunk=Q_CHUNK, device=cuda)
    batch = batch_on(cfg, "cpu")
    out = eng.generate(
        batch["tokens"].numpy(), max_new_tokens=STEPS,
        src_embeds=(batch["src_embeds"].float().numpy()
                    if cfg.is_encdec else None))
    np.testing.assert_array_equal(out, eng.generate(
        batch["tokens"].numpy(), max_new_tokens=STEPS,
        src_embeds=(batch["src_embeds"].float().numpy()
                    if cfg.is_encdec else None)))
    tokens = torch.as_tensor(out[:, P:])
    got = engine.teacher_forced_logits(
        cfg, card_w, {k: v.to(cuda) for k, v in batch.items()},
        tokens.to(cuda), capacity=P + STEPS, q_chunk=Q_CHUNK)
    want = engine.teacher_forced_logits(cfg, cpu_w, batch, tokens,
                                        capacity=P + STEPS, q_chunk=Q_CHUNK)
    corr, rel = ILL_CONDITIONED.get(arch, (0.9999, 0.02))
    for step, (g, w) in enumerate(zip(got, want)):
        hold(g[:, :cfg.vocab_size], w[:, :cfg.vocab_size], corr, rel,
             f"{arch} step {step}")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_layer_routes_alike_in_float32(cuda, arch, groups):
    cfg = config(arch)
    params = model.make_params(cfg, seed=1, device="cpu")
    layer = params.layers[-1]["moe"]
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(4, 16, cfg.d_model)), dtype=torch.float32)
    want, want_m = moe.apply_moe(cfg, layer, x, groups=groups,
                                 capacity_factor=0.5)
    card = {k: layer[k].to(cuda) for k in layer.inits}
    got, got_m = moe.apply_moe(cfg, card, x.to(cuda), groups=groups,
                               capacity_factor=0.5)
    for key in ("expert_load", "dropped_tokens"):
        assert torch.equal(got_m[key].cpu(), want_m[key])
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_sampling_on_the_card_is_reproducible(cuda):
    cfg = config("qwen2-0.5b")
    eng = engine.ServeEngine(cfg, model.make_params(cfg, device=cuda),
                             max_seq_len=32, q_chunk=Q_CHUNK)
    toks = np.zeros((2, 4), np.int32)
    a = eng.generate(toks, max_new_tokens=8, temperature=0.8, seed=3)
    b = eng.generate(toks, max_new_tokens=8, temperature=0.8, seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    assert eng.timing["prefill_ms"] > 0 and eng.timing["decode_ms"] > 0
