"""The port's serving and training paths on the card against its own
CPU path.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  Run them on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_lm_cuda.py

The reduced config of each architecture (and reduced qwen2 and
recurrentgemma with a local-attention ring of 8 slots under their
12-token prompts), with seeded random weights, is served on the card and
on the CPU: the prefill's next-token logits and 6 decode
steps teacher-forced with the card's greedy tokens are held to the CPU's
at correlation ≥ 0.9999 and max |card - CPU| ≤ 0.02 · max |CPU| (cuBLAS
and the CPU sum bfloat16 products in float32 in different orders).
Reduced seamless-m4t-medium is ill-conditioned — one bfloat16 step of
one input element moves the JAX package's own decode logits to a
correlation of 0.90 (``test_seamless_reference_is_ill_conditioned`` in
``test_torch_lm_serve.py``) — and is held as there: correlation ≥ 0.94,
max difference ≤ 0.5 · max.  xlstm-1.3b's sLSTM recurrence is chaotic
(ROADMAP §3: two paths that round apart part within tens of positions),
so its prefill logits are held at its measured conditioning (correlation
≥ 0.997, max difference ≤ 0.1 · max;
``test_xlstm_reference_is_ill_conditioned`` in
``test_torch_lm_recurrent.py``) and each decode step runs on the card
from the CPU's cache at that step, held at the strict bound.  The
recurrent blocks in float32 (TF32 off) agree within 1e-4 of each
output's largest magnitude.  One MoE layer in
float32 (TF32 off) must route identically on both: equal
``expert_load`` and ``dropped_tokens``, outputs within 1e-4 of their
largest magnitude (the reference's fan-in recipe reads an expert stack's
leading axis, so outputs reach the hundreds and float32 sums in two
orders differ by more than 1e-4 absolute).

Training: one AdamW step (``grad_accum`` 2, remat on the card) of the
reduced qwen2, granite-moe and recurrentgemma configs, card against CPU
(loss and grad norm to 1e-3 relative, the moments per leaf at
correlation ≥ 0.9998 and ≥ 0.999, as measured); remat equal to no remat and a checkpoint resumed
to the same third step, both bit for bit under
``torch.use_deterministic_algorithms``.

The parallel layer over 4 logical devices (streams on the card) against
the same over 4 CPU devices: the sharded MoE of reduced granite on
(2, 2) and (1, 4) at capacity 16 and 1.25 in float32 (equal
``expert_load`` and ``dropped_tokens``, outputs and gradients within
1e-4 of their largest magnitude), ``pipeline_apply`` over 4 stages and
its gradient (1e-5), and ``quantized_tree_psum`` at 8 and 16 bits bit
for bit.
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
         "seamless-m4t-medium", "qwen2-ring", "recurrentgemma-2b",
         "recurrentgemma-ring"]
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
    if arch == "recurrentgemma-ring":
        return dataclasses.replace(
            get_config("recurrentgemma-2b").reduced(), window=8)
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


def test_xlstm_steps_from_a_shared_state(cuda):
    cfg = config("xlstm-1.3b")
    params = model.make_params(cfg, seed=0, device="cpu")
    cpu_w = model.compute_copy(params)
    card_w = model.compute_copy(params, device=cuda)
    cap = P + STEPS + 4
    eng = engine.ServeEngine(cfg, params, max_seq_len=cap, q_chunk=Q_CHUNK,
                             device=cuda)
    batch = batch_on(cfg, "cpu")
    out = eng.generate(batch["tokens"].numpy(), max_new_tokens=STEPS)
    np.testing.assert_array_equal(out, eng.generate(
        batch["tokens"].numpy(), max_new_tokens=STEPS))
    tokens = torch.as_tensor(out[:, P:])
    v = cfg.vocab_size
    with torch.inference_mode():
        want, caches = model.serve_prefill(cfg, cpu_w, batch,
                                           q_chunk=Q_CHUNK)
        got, _ = model.serve_prefill(
            cfg, card_w, {k: t.to(cuda) for k, t in batch.items()},
            q_chunk=Q_CHUNK)
        hold(got[:, -1, :v], want[:, -1, :v], 0.997, 0.1, "prefill")
        cache = engine.prefill_to_decode_cache(cfg, caches, P, cap)
        for step in range(STEPS):
            card_cache = dict(cache, layers=[
                {k: t.to(cuda) for k, t in e.items()}
                for e in cache["layers"]])
            tok = tokens[:, step:step + 1]
            got, _ = model.decode_step(cfg, card_w, tok.to(cuda),
                                       card_cache)
            want, cache = model.decode_step(cfg, cpu_w, tok, cache)
            hold(got[:, -1, :v], want[:, -1, :v], 0.9999, 0.02,
                 f"step {step}")


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


#: (arch, block, sequence length, decode): each recurrent block in float32
RECURRENT_BLOCKS = [("xlstm-1.3b", "mlstm", 300, False),
                    ("xlstm-1.3b", "mlstm", 1, True),
                    ("xlstm-1.3b", "slstm", 9, False),
                    ("recurrentgemma-2b", "rglru", 33, False),
                    ("recurrentgemma-2b", "rglru", 1, True)]


@pytest.mark.parametrize("arch,kind,s,decode", RECURRENT_BLOCKS)
def test_recurrent_blocks_in_float32(cuda, arch, kind, s, decode):
    """One block with its state, on the card against the CPU (mLSTM in
    two chunks of 256, the second padded)."""
    from repro_torch.models import recurrent
    cfg = config(arch)
    params = model.make_params(cfg, seed=4, device="cpu")
    layer = next(p["mixer"] for (k, _), p in zip(model.layer_sigs(cfg),
                                                 params.layers) if k == kind)
    p = {name: layer[name] for name in layer.inits}
    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(B, s, cfg.d_model)), dtype=torch.float32)
    block = getattr(recurrent, f"{kind}_block")
    state = None
    if decode:
        state = tuple(t.normal_(generator=torch.Generator().manual_seed(6))
                      for t in getattr(recurrent, f"{kind}_init_state")(
                          cfg, B))
        if kind == "mlstm":
            state = state[:2] + (state[2].abs(),)
    kw = dict(decode=True) if decode else {}
    want, want_st = block(cfg, p, x, state=state, **kw)
    got, got_st = block(
        cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
        state=None if state is None else tuple(t.to(cuda) for t in state),
        **kw)
    for g, w in zip((got,) + tuple(got_st), (want,) + tuple(want_st)):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.cpu() - w).abs().max() / w.abs().max())
        assert err <= 1e-4, (arch, kind, err)


# ---------------------------------------------------------------- training

def train_batch_on(cfg, device, rows=B, seed=0) -> dict:
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    return device_batch(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, batch=rows, seq_len=P,
        seed=seed)).batch_at(0), device)


def one_step(cfg, params, batch, remat=False, grad_accum=1):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import build_train_step, init_state
    rows, seq = batch["tokens"].shape
    step, _, _ = build_train_step(cfg, None, ShapeSpec("t", "train", seq,
                                                       rows),
                                  q_chunk=Q_CHUNK, remat=remat,
                                  grad_accum=grad_accum)
    return step(params, init_state(params), batch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One AdamW step (grad_accum 2) of each family's reduced config on
    the card against the CPU from the same weights: loss and grad norm
    within 1e-3 relative, and per leaf the moments ``mu`` (the
    gradients) at corr >= 0.9998 and ``nu`` (their squares) at >= 0.999
    (measured on an H100: worst 0.99986, qwen2's ``bk``, a bias whose
    gradient is a bfloat16 sum; 0.99950, recurrentgemma's ``lam``)."""
    cfg = config(arch)
    cpu_m = model.make_params(cfg, seed=0, device="cpu", trainable=True)
    card_m = model.LanguageModel(cfg, device=cuda).requires_grad_()
    card_m.load_state_dict(cpu_m.state_dict())
    _, cpu_o, cpu_met = one_step(cfg, cpu_m, train_batch_on(cfg, "cpu"),
                                 grad_accum=2)
    _, card_o, card_met = one_step(cfg, card_m, train_batch_on(cfg, cuda),
                                   remat=True, grad_accum=2)
    for key in ("loss", "grad_norm"):
        assert abs(float(card_met[key]) - float(cpu_met[key])) <= 1e-3 * abs(
            float(cpu_met[key])), key
    assert float(card_met["lr"]) == float(cpu_met["lr"])
    for moment, corr in (("mu", 0.9998), ("nu", 0.999)):
        for name, want in cpu_o[moment].items():
            got = card_o[moment][name].float().cpu().numpy().ravel()
            c = np.corrcoef(got, want.numpy().ravel())[0, 1]
            assert c >= corr, (arch, moment, name, c)
    for p, q in zip(card_m.parameters(), cpu_m.parameters()):
        assert torch.isfinite(p).all()


def deterministic(fn):
    """``fn()`` under ``torch.use_deterministic_algorithms`` (the
    embedding's backward accumulates with atomics otherwise)."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(False)


def test_remat_equals_no_remat_on_the_card(cuda):
    """The loss and every gradient with each layer recomputed equal the
    stored-activation ones, bit for bit."""
    cfg = config("qwen2-0.5b")
    m = model.make_params(cfg, seed=0, device=cuda, trainable=True)
    batch = train_batch_on(cfg, cuda)

    def grads(remat):
        loss, _ = model.loss_fn(cfg, m, batch, q_chunk=Q_CHUNK, remat=remat)
        return loss, torch.autograd.grad(loss, list(m.parameters()))
    (la, ga), (lb, gb) = deterministic(lambda: (grads(False), grads(True)))
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_checkpoint_resumes_to_the_same_step(cuda, tmp_path):
    """Two steps, a checkpoint, a third step; then the checkpoint restored
    into the live model and state and the third step again: the same
    parameters, moments and metrics, bit for bit."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import (CheckpointManager, build_train_step,
                                   init_state)
    cfg = config("qwen2-0.5b")
    m = model.make_params(cfg, seed=0, device=cuda, trainable=True)
    batches = [train_batch_on(cfg, cuda, seed=s) for s in range(3)]
    rows, seq = batches[0]["tokens"].shape
    step, _, _ = build_train_step(
        cfg, None, ShapeSpec("t", "train", seq, rows), q_chunk=Q_CHUNK,
        remat=True)
    mgr = CheckpointManager(tmp_path)

    def run():
        opt = init_state(m)
        for b in batches[:2]:
            step(m, opt, b)
        mgr.save(2, {"params": m, "opt": opt})
        _, opt, met = step(m, opt, batches[2])
        first = ([p.detach().clone() for p in m.parameters()],
                 {k: v.clone() for k, v in opt["mu"].items()}, met)
        restored, _ = mgr.restore({"params": m, "opt": opt})
        _, opt2, met2 = step(restored["params"], restored["opt"], batches[2])
        return first, ([p.detach().clone() for p in m.parameters()],
                       opt2["mu"], met2)
    (pa, mua, meta), (pb, mub, metb) = deterministic(run)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all(torch.equal(mua[k], mub[k]) for k in mua)
    assert all(float(meta[k]) == float(metb[k]) for k in meta)


# ------------------------------------------------------- parallel layer

def logical_mesh(shape, axes, device):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(shape, axes, device=device)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_sharded_moe_on_the_card_matches_the_cpu(cuda, shape, cf):
    """``make_sharded_moe`` over 4 logical devices (streams on the card)
    against the same over 4 CPU devices, in float32: equal
    ``expert_load`` and ``dropped_tokens``; outputs and the gradients of
    Σy² within 1e-4 of their largest magnitude."""
    from repro_torch.models.moe_shard import make_sharded_moe
    from repro_torch.parallel.sharding import spec_for_axes
    cfg = get_config("granite-moe-3b-a800m").reduced()
    tree = model.make_params(cfg, seed=0, device="cpu").layers[0]["moe"]
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)), dtype=torch.float32)
    out = {}
    for where in ("cpu", cuda):
        mesh = logical_mesh(shape, ("data", "model"), where)
        fn = make_sharded_moe(cfg, mesh, "data", {
            k: spec_for_axes(d.axes, d.shape, mesh)
            for k, d in moe.moe_schema(cfg).items()}, capacity_factor=cf)
        p = {k: tree[k].detach().to(where).requires_grad_()
             for k in tree.inits}
        y, m = fn(p, x.to(where))
        grads = torch.autograd.grad(torch.sum(y ** 2), list(p.values()))
        out[str(where)] = (y.detach().cpu(), {k: v.detach().cpu()
                                              for k, v in m.items()},
                           [g.cpu() for g in grads])
    (y0, m0, g0), (y1, m1, g1) = out["cpu"], out[str(cuda)]
    for key in ("expert_load", "dropped_tokens"):
        assert torch.equal(m0[key], m1[key]), key
    assert cf != 16.0 or int(m0["dropped_tokens"]) == 0
    for got, want in zip([y1] + g1, [y0] + g0):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


def test_pipeline_on_the_card_matches_the_cpu(cuda):
    """``pipeline_apply`` over 4 stages on 4 logical devices of the card
    against the CPU, outputs and the gradient of Σy² through it within
    1e-5 of their largest magnitude (float32, TF32 off)."""
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    rng = np.random.default_rng(0)
    layers = [{"w": torch.as_tensor(rng.normal(size=(16, 16)) * 0.3,
                                    dtype=torch.float32)} for _ in range(8)]
    mbs = torch.as_tensor(rng.normal(size=(6, 3, 16)), dtype=torch.float32)

    def stage(p, x):
        for l in range(p["w"].shape[0]):
            x = torch.tanh(x @ p["w"][l])
        return x
    out = {}
    for where in ("cpu", cuda):
        w = split_stages(layers, 4)["w"].to(where).requires_grad_()
        y = pipeline_apply(stage, logical_mesh((4,), ("pod",), where))(
            {"w": w}, mbs.to(where))
        (g,) = torch.autograd.grad(torch.sum(y ** 2), [w])
        out[str(where)] = (y.detach().cpu(), g.cpu())
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_psum_on_the_card_equals_the_cpu(cuda, bits):
    """The quantized all-reduce over 4 logical devices: reduced values
    and residuals bit for bit (the same integer sums, scales and float32
    operations)."""
    from repro_torch.parallel.compression import quantized_tree_psum
    rng = np.random.default_rng(2)
    trees = [{"a": torch.as_tensor(rng.normal(size=(33, 7)),
                                   dtype=torch.float32)} for _ in range(4)]
    out = {}
    for where in ("cpu", cuda):
        red, res = quantized_tree_psum(
            [{k: v.to(where) for k, v in t.items()} for t in trees],
            logical_mesh((4,), ("data",), where), "data", bits=bits)
        out[str(where)] = ([r["a"].cpu() for r in red],
                           [r["a"].cpu() for r in res])
    for got, want in zip(out[str(cuda)], out["cpu"]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
