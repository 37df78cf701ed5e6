"""The port's training substrate against the JAX package's: the
optimizers, the schedule, the data pipeline, the checkpoint layout and
the fault coordinator (the counterparts of ``tests/test_train_substrate.py``).

Optimizer, on seeded trees of float32 leaves, over 5 steps, ``repro``'s
``apply_update`` under ``jax.jit``:

* AdamW and Lion without clipping (``clip_norm`` past the norm, so the
  scale is exactly 1), each step from the same state: ``mu``, ``nu``,
  ``lr`` and Lion's parameters bit for bit (XLA contracts the moment
  updates and the decayed step into fused multiply-adds and rewrites
  ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` as ``mu / (bc1 · (sqrt(nu /
  bc2) + eps))``; the port writes both so); AdamW's parameters to ≤ 1
  ulp (189 elements in a million round apart, measured: XLA's vectorised
  division or square root is not always correctly rounded);
  ``grad_norm`` to ≤ 1 ulp (each leaf's sum of squares is reduced in
  another order);
* with clipping, the pre-clip ``grad_norm`` to ≤ 1 ulp; the clipped
  update then differs by that ulp of the scale, and is held to 1e-6
  relative;
* ``schedule`` over warmup, decay and the floor to ≤ 6 ulps (5
  measured): torch's
  ``cos`` and XLA's round apart by up to 1 ulp, which ``1 + cos`` near
  the end of the decay enlarges (everything else as XLA computes it:
  reciprocal multiplies, folded constants, the fused multiply-add);
* the pure-PyTorch update drives a quadratic down, as the reference's
  tests do, and ``init_state``'s dtypes are float32 moments and an
  int32 step.

Pipeline: ``batch_at`` and ``host_shard`` array-equal to ``repro``'s;
the prefetch iterator resumes at any step.  Checkpoints: round trip
(tensors restored in place, a module's leaves included), retention,
``latest_step``, an async save that copies before it returns, bfloat16,
and a tree of numpy leaves written by either package restored by the
other.  Coordinator: recovery replays to the uninterrupted run's state,
too many failures raise, stragglers are detected, the watchdog fires,
and a CUDA-type error is not retried.
"""

import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.train import checkpoint as ref_checkpoint
from repro.train import optimizer as ref_opt
from repro_torch.data import DataConfig, TokenPipeline, device_batch, host_shard
from repro_torch.models import model
from repro_torch.configs import get_config
from repro_torch.train import (
    CheckpointManager, Coordinator, StragglerDetector, Watchdog, optimizer)

STEPS = 5


def seeded_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 33)).astype(np.float32),
            "b": {"x": rng.normal(size=(1000,)).astype(np.float32),
                  "a": rng.normal(size=(7, 3, 5)).astype(np.float32)}}


def to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def run_both(kind: str, clip_norm: float):
    """``STEPS`` updates of both packages; each port step starts from the
    reference's state before it, so that every step is held on equal
    inputs."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, kind=kind,
              clip_norm=clip_norm)
    upd = jax.jit(lambda p, g, s: ref_opt.apply_update(
        ref_opt.OptConfig(**kw), p, g, s))
    jp = jax.tree.map(jnp.asarray, seeded_tree(0))
    js = ref_opt.init_state(jp)
    out = []
    for i in range(STEPS):
        g = jax.tree.map(lambda a: 0.3 * a, seeded_tree(i + 1))
        ts = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), js)
        tp, ts, tm = optimizer.apply_update(
            optimizer.OptConfig(**kw), to_torch(jp), to_torch(g), ts)
        jp, js, jm = upd(jp, g, js)
        out.append((jax.tree.map(np.asarray, (jp, js, jm)),
                    jax.tree.map(lambda t: t.numpy().copy(), (tp, ts, tm))))
    return out


@pytest.mark.parametrize("kind", ["adamw", "lion"])
def test_update_bit_for_bit_without_clipping(kind):
    for (jp, js, jm), (tp, ts, tm) in run_both(kind, 1e30):
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            if kind == "lion":
                np.testing.assert_array_equal(a, b)
            else:
                assert ulps(a, b) <= 1
        for key in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(js[key]),
                            jax.tree.leaves(ts[key])):
                np.testing.assert_array_equal(a, b)
        assert int(js["step"]) == int(ts["step"])
        assert float(jm["lr"]) == float(tm["lr"])
        assert ulps(jm["grad_norm"], tm["grad_norm"]) <= 1


@pytest.mark.parametrize("kind", ["adamw", "lion"])
def test_clipped_update(kind):
    for (jp, js, jm), (tp, ts, tm) in run_both(kind, 1.0):
        assert float(jm["grad_norm"]) > 1.0          # clipping is active
        assert ulps(jm["grad_norm"], tm["grad_norm"]) <= 1
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_leaf_order_is_jax_flatten_order():
    tree = seeded_tree(0)
    names = [n for n, _ in optimizer.tree_leaves(to_torch(tree))]
    assert names == ["b.a", "b.x", "w"]
    leaves = [t.numpy() for _, t in optimizer.tree_leaves(to_torch(tree))]
    for a, b in zip(jax.tree.leaves(tree), leaves):
        np.testing.assert_array_equal(a, b)


def test_global_norm():
    tree = seeded_tree(3)
    want = jax.jit(ref_opt.global_norm)(tree)
    got = optimizer.global_norm(to_torch(tree))
    assert got.dtype == torch.float32
    assert ulps(want, got) <= 1


@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=1000),
    dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
    dict(lr=1e-3, warmup_steps=20, total_steps=200, min_lr_ratio=0.1),
    dict(lr=1e-2, warmup_steps=0, total_steps=10, min_lr_ratio=0.0)])
def test_schedule(cfg):
    steps = np.arange(0, cfg["total_steps"] + 50, 3, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: ref_opt.schedule(
        ref_opt.OptConfig(**cfg), s)))(steps))
    got = optimizer.schedule(optimizer.OptConfig(**cfg),
                             torch.tensor(steps)).numpy()
    assert got.dtype == np.float32
    assert ulps(want, got) <= 6
    # warmup, the peak and the floor
    ocfg = optimizer.OptConfig(**cfg)
    end = float(optimizer.schedule(ocfg, cfg["total_steps"]))
    assert end == pytest.approx(cfg["lr"] * ocfg.min_lr_ratio, rel=1e-6,
                                abs=1e-12)


def test_adamw_reduces_quadratic_and_lion_too():
    for kind, lr, total, steps, bound in (("adamw", 0.1, 100, 60, 1.0),
                                          ("lion", 0.05, 10_000, 80, 1.5)):
        params = {"w": torch.ones(8) * 5.0}
        cfg = optimizer.OptConfig(lr=lr, warmup_steps=0, total_steps=total,
                                  weight_decay=0.0, kind=kind)
        state = optimizer.init_state(params)
        for _ in range(steps):
            params, state, _ = optimizer.apply_update(
                cfg, params, {"w": 2 * params["w"]}, state)
        assert float(params["w"].abs().max()) < bound
        assert int(state["step"]) == steps


def test_init_state_of_a_model():
    cfg = get_config("qwen2-0.5b").reduced()
    m = model.make_params(cfg, 0, device="cpu", trainable=True)
    state = optimizer.init_state(m)
    names = sorted(n for n, _ in m.named_parameters())
    assert sorted(state["mu"]) == sorted(state["nu"]) == names
    assert all(t.dtype == torch.float32 and not t.any()
               for t in state["mu"].values())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in m.parameters())
    assert not any(p.requires_grad for p in model.make_params(
        cfg, 0, device="cpu").parameters())


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("source", ["synthetic", "file"])
def test_pipeline_matches_reference(source, tmp_path):
    path = ""
    if source == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(5).integers(0, 60_000, 5_000).astype(
            np.uint16).tofile(path)
    kw = dict(vocab_size=1000, batch=4, seq_len=16, seed=3, source=source,
              path=path)
    ref = ref_pipeline.TokenPipeline(ref_pipeline.DataConfig(**kw))
    port = TokenPipeline(DataConfig(**kw))
    for step in (0, 1, 5, 99, 2**20 + 7):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        for n in (1, 2, 4):
            for i in range(n):
                ra = ref_pipeline.host_shard(a, i, n)
                rb = host_shard(b, i, n)
                for k in a:
                    np.testing.assert_array_equal(ra[k], rb[k])


def test_prefetch_iterator_resumes_at_any_step():
    pipe = TokenPipeline(DataConfig(vocab_size=100, batch=2, seq_len=4))
    for start in (0, 10, 37):
        it = pipe.iterate(start_step=start, prefetch=3)
        for want in range(start, start + 4):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          pipe.batch_at(want)["tokens"])
        it.close()


def test_device_batch():
    batch = TokenPipeline(DataConfig(vocab_size=50, batch=2,
                                     seq_len=8)).batch_at(0)
    out = device_batch(batch, "cpu")
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["labels"].numpy(), batch["labels"])


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_in_place(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    cfg = get_config("qwen2-0.5b").reduced()
    m = model.make_params(cfg, 0, device="cpu", trainable=True)
    state = {"params": m, "opt": optimizer.init_state(m),
             "w": torch.arange(12.0).reshape(3, 4), "step": np.int64(7)}
    saved = {n: p.detach().clone() for n, p in m.named_parameters()}
    mgr.save(7, state)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
        state["w"].zero_()
    live_w = state["w"]
    restored, step = mgr.restore(state)
    assert step == 7 and int(restored["step"]) == 7
    assert restored["params"] is m and restored["w"] is live_w
    np.testing.assert_array_equal(live_w.numpy(),
                                  np.arange(12.0).reshape(3, 4))
    for n, p in m.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
    assert restored["opt"]["step"].dtype == torch.int32
    manifest = (tmp_path / "step_0000000007" / "manifest.json").read_text()
    assert '"params/layers.0.mixer.wq"' in manifest


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.tensor(s)})
    assert mgr.all_steps() == [2, 3]
    assert mgr.latest_step() == 3
    assert not list(tmp_path.glob(".tmp_*"))


def test_async_save_copies_before_it_returns(tmp_path):
    mgr = CheckpointManager(tmp_path)
    x = torch.ones(1000)
    fut = mgr.save_async(5, {"x": x})
    x.mul_(3.0)                    # the next step's in-place update
    fut.result(timeout=30)
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore({"x": np.zeros(1000, np.float32)})
    np.testing.assert_array_equal(restored["x"], np.ones(1000, np.float32))


def test_bfloat16_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path)
    x = torch.randn(5, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    mgr.save(1, {"x": x})
    target = torch.zeros(5, dtype=torch.bfloat16)
    mgr.restore({"x": target})
    assert torch.equal(target, x)
    raw, _ = mgr.restore({"x": None})
    assert raw["x"].dtype == np.uint16
    # the reference's bfloat16 leaves restore the same way
    ref = ref_checkpoint.CheckpointManager(tmp_path / "ref")
    ref.save(1, {"x": np.asarray(x.float().numpy()).astype(
        ml_dtypes.bfloat16)})
    target = torch.zeros(5, dtype=torch.bfloat16)
    CheckpointManager(tmp_path / "ref").restore({"x": target})
    assert torch.equal(target, x)


def numpy_state():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": {"x": rng.integers(0, 9, 5).astype(np.int32)}},
            "step": np.int64(11)}


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_restore_across_packages(writer, tmp_path):
    state = numpy_state()
    managers = {"repro": ref_checkpoint.CheckpointManager,
                "port": CheckpointManager}
    managers[writer](tmp_path, keep=2).save(11, state)
    reader = managers["port" if writer == "repro" else "repro"](tmp_path)
    skeleton = jax.tree.map(np.zeros_like, state)
    restored, step = reader.restore(skeleton)
    assert step == 11
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert np.asarray(b).dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(a, b)
    files = sorted(p.name for p in (tmp_path / "step_0000000011").iterdir())
    assert files == ["manifest.json", "params__b__x.npy", "params__w.npy",
                     "step.npy"]


# ---------------------------------------------------------------- fault

def make_step(fail_at=None, error=RuntimeError("injected node failure")):
    calls = {"n": 0}

    def step_fn(state, batch):
        if fail_at is not None and int(state["step"]) == fail_at \
                and calls["n"] == 0:
            calls["n"] += 1
            state["acc"].add_(1_000)         # half-applied, in place
            raise error
        state["acc"].add_(int(batch["tokens"].sum()))
        state["step"] += 1
        return state, {"loss": 1.0}
    return step_fn


def fresh_state():
    return {"acc": torch.zeros((), dtype=torch.int64), "step": 0}


def test_recovery_replays_exactly(tmp_path):
    pipe = TokenPipeline(DataConfig(vocab_size=97, batch=2, seq_len=8))
    coord = Coordinator(make_step(fail_at=7), pipe.batch_at,
                        CheckpointManager(tmp_path / "a", keep=3),
                        ckpt_every=5)
    final, last, hist = coord.run(fresh_state(), 0, 12)
    assert coord.failures == 1 and len(coord.restarts) == 1
    assert coord.restarts[0]["step"] == 7 and last == 12
    ref = Coordinator(make_step(), pipe.batch_at,
                      CheckpointManager(tmp_path / "b", keep=3),
                      ckpt_every=5)
    want, _, _ = ref.run(fresh_state(), 0, 12)
    assert int(final["acc"]) == int(want["acc"])
    assert [h["step"] for h in hist] == list(range(7)) + list(range(5, 12))


def test_too_many_failures_raises(tmp_path):
    pipe = TokenPipeline(DataConfig(vocab_size=7, batch=1, seq_len=4))

    def bad(state, batch):
        raise RuntimeError("permafail")
    coord = Coordinator(bad, pipe.batch_at, CheckpointManager(tmp_path),
                        max_failures=2)
    with pytest.raises(RuntimeError, match="permafail"):
        coord.run({"step": 0}, 0, 5)
    assert coord.failures == 3


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory")],
    ids=["cuda-error", "out-of-memory"])
def test_device_errors_are_not_retried(error, tmp_path):
    pipe = TokenPipeline(DataConfig(vocab_size=7, batch=1, seq_len=4))
    coord = Coordinator(make_step(fail_at=1, error=error), pipe.batch_at,
                        CheckpointManager(tmp_path), ckpt_every=1)
    with pytest.raises(type(error)):
        coord.run(fresh_state(), 0, 4)
    assert coord.failures == 0 and not coord.restarts


def test_straggler_detection():
    det = StragglerDetector(factor=2.0)
    for i in range(20):
        det.observe(i, 1.0)
    assert det.observe(20, 5.0) is True
    assert det.events and det.events[0]["step"] == 20


def test_watchdog():
    wd = Watchdog(timeout_s=0.2)
    wd.start()
    time.sleep(0.6)
    assert wd.fired
    wd.stop()
