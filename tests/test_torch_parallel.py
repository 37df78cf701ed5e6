"""The port's collective paths against the JAX package's ``shard_map``
ones, over logical CPU devices (``default_devices(k, "cpu")``) against
``tests/conftest.py``'s virtual devices.

* The collectives (``all_gather``, ``all_to_all``, ``psum``, ``pmean``,
  ``pmax``, ``ppermute``) over each axis of a (2, 2) mesh: equal to
  ``jax.lax``'s under ``shard_map``.
* ``make_sharded_moe`` against ``repro.models.moe_shard`` on (2, 2)
  (FSDP over ``data``, EP over ``model``) and (1, 4) (EP over 4), the
  cases of ``tests/test_moe.py``'s ``TestShardMapParity`` (shared expert
  or not; capacity 16, 1.25 and 0.5): in float32, outputs and every
  gradient of Σy² within 2e-6 of their largest magnitude (6.9e-7
  measured: float32 sums in another order), the aux-loss gradient too;
  ``expert_load`` and ``dropped_tokens`` exact.  In bfloat16, one layer
  bit for bit: the reference's compiled ``shard_map`` program keeps the
  router product in float32 and sums each token's items in float32, and
  the port does so too.  With ample capacity the sharded path equals
  the grouped ``apply_moe``.
* ``pipeline_apply`` over 4 stages = the sequential stack and
  ``repro``'s pipeline, gradients through it too (the cases of
  ``tests/test_parallel_features.py``).
* ``quantized_psum``/``quantized_tree_psum`` against ``repro``'s at 4, 8
  and 16 bits: the reduced values bit for bit (so are the int32 sums: the
  same scale times an integer), the error-feedback residuals to ≤ 1 ulp.
* ``build_train_step(moe_impl="shard_map")``: one step of reduced
  deepseek-moe-16b on (2, 2) and (1, 4) against ``repro``'s, at measured
  bounds (``SHARD_STEP``).  Not bit for bit: ``repro``'s whole step is
  one GSPMD program whose dense layers the partitioner splits over the
  mesh, which reorders their float sums, so its values move with the
  mesh (``test_reference_values_move_with_the_mesh``); the port's dense
  layers compute what ``repro``'s (1, 1) program does, and its MoE layer
  what the ``shard_map`` body does (the layer holds above).
* ``build_train_step`` refuses a ``grad_accum`` that does not divide the
  batch or exceeds it, as ``repro``'s reshape does; ``scan_layers`` and
  ``rec_unroll`` change no value; a checkpoint ``repro`` wrote restores
  sharded, block for block as ``repro`` places it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.models import model as ref_model
from repro.models.common import init_params as ref_init_params
from repro.models.moe import moe_schema as ref_moe_schema
from repro.models.moe_shard import make_sharded_moe as ref_sharded_moe
from repro.parallel import compression as ref_compression
from repro.parallel import pipeline as ref_pipeline
from repro.parallel.sharding import (
    make_activation_sharder as ref_activation_sharder)
from repro.parallel.sharding import spec_for_axes as ref_spec_for_axes
from repro.train import checkpoint as ref_checkpoint
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_train_loop
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model
from repro_torch.models.moe import apply_moe, moe_schema
from repro_torch.models.moe_shard import make_sharded_moe
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.compression import (
    quantized_psum, quantized_tree_psum)
from repro_torch.parallel.pipeline import pipeline_apply, split_stages
from repro_torch.parallel.sharding import (
    Placement, shard_tensor, spec_for_axes, tree_shardings)
from repro_torch.train import CheckpointManager, optimizer, train_loop
import torch_lm_train_cases as tc

AXES = ("data", "model")


def ref_mesh(shape, axes=AXES):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def port_mesh(shape, axes=AXES):
    return make_host_mesh(shape, axes, device="cpu")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------- collectives

def per_device(x, shape):
    """(n, ...) numpy rows -> blocks in flat order."""
    return [torch.as_tensor(x[i]) for i in range(int(np.prod(shape)))]


COLLECTIVES = {
    "all_gather": (lambda b, m, ax: coll.all_gather(b, m, ax, 1),
                   lambda x, ax: jax.lax.all_gather(x, ax, axis=1,
                                                    tiled=True)),
    "all_to_all": (lambda b, m, ax: coll.all_to_all(b, m, ax, 0, 1),
                   lambda x, ax: jax.lax.all_to_all(
                       x, ax, split_axis=0, concat_axis=1, tiled=True)),
    "psum": (coll.psum, jax.lax.psum),
    "pmean": (coll.pmean, jax.lax.pmean),
    "pmax": (coll.pmax, jax.lax.pmax),
    "ppermute": (lambda b, m, ax: coll.ppermute(b, m, ax, [(0, 1)]),
                 lambda x, ax: jax.lax.ppermute(x, ax, [(0, 1)])),
}


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")],
                         ids=["data", "model", "both"])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_equals_jax(name, axis):
    port_fn, jax_fn = COLLECTIVES[name]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 4, 6)).astype(np.float32)   # a block a device
    mesh = ref_mesh((2, 2))
    spec = P(("data", "model"))
    want = jax.jit(jax.shard_map(
        lambda b: jax_fn(b[0], axis)[None], mesh=mesh, in_specs=spec,
        out_specs=spec, check_vma=False))(jnp.asarray(x))
    got = port_fn(per_device(x, (2, 2)), port_mesh((2, 2)), axis)
    want = np.asarray(want)
    assert len(got) == 4
    for i in range(4):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-6,
                                   atol=1e-6)


def test_collectives_carry_gradients():
    """all_gather's gradient is a reduce-scatter, ppermute's the reverse
    permute."""
    mesh = port_mesh((4,), ("pod",))
    xs = [torch.randn(2, 3, requires_grad=True) for _ in range(4)]
    g = coll.all_gather(xs, mesh, "pod", 0)
    torch.autograd.backward(g, [torch.ones(8, 3) * (i + 1)
                                for i in range(4)])
    for x in xs:
        np.testing.assert_array_equal(x.grad.numpy(), np.full((2, 3), 10.))
    ys = [torch.randn(2, requires_grad=True) for _ in range(4)]
    out = coll.ppermute(ys, mesh, "pod", [(i, (i + 1) % 4)
                                          for i in range(4)])
    torch.autograd.backward(out, [torch.full((2,), float(i))
                                  for i in range(4)])
    for i, y in enumerate(ys):
        np.testing.assert_array_equal(y.grad.numpy(),
                                      np.full(2, float((i + 1) % 4)))


# ------------------------------------------------------- sharded MoE

def moe_setup(seed=0, shared=0):
    kw = dict(num_experts=8, top_k=2, num_shared_experts=shared,
              d_model=64, d_ff=96)
    ref_cfg = dataclasses.replace(
        ref_get_config("deepseek-moe-16b").reduced(), **kw)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              **kw)
    p = jax.tree.map(np.asarray, ref_init_params(
        ref_moe_schema(ref_cfg), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 16, 64)) * 0.5).astype(np.float32)
    return ref_cfg, cfg, p, x


MOE_CASES = [((2, 2), 1, 16.0), ((1, 4), 0, 16.0), ((2, 2), 1, 1.25),
             ((1, 4), 0, 1.25), ((2, 2), 0, 0.5)]


@functools.lru_cache(maxsize=None)
def ref_moe(shape, shared, cf):
    ref_cfg, _, p, x = moe_setup(shared=shared)
    mesh = ref_mesh(shape)
    specs = {k: ref_spec_for_axes(d.axes, d.shape, mesh)
             for k, d in ref_moe_schema(ref_cfg).items()}
    fn = ref_sharded_moe(ref_cfg, mesh, "data", specs, capacity_factor=cf)
    y, m = jax.jit(fn)(p, jnp.asarray(x))
    grads = jax.jit(jax.grad(lambda pp, xx: jnp.sum(fn(pp, xx)[0] ** 2),
                             argnums=(0, 1)))(p, jnp.asarray(x))
    aux = jax.jit(jax.grad(lambda pp, xx: fn(pp, xx)[1]["moe_aux_loss"]
                           + fn(pp, xx)[1]["moe_z_loss"]))(p, jnp.asarray(x))
    host = functools.partial(jax.tree.map, np.asarray)
    return host(y), host(m), host(grads), host(aux)


def port_moe(shape, shared, cf):
    _, cfg, p, x = moe_setup(shared=shared)
    mesh = port_mesh(shape)
    specs = {k: spec_for_axes(d.axes, d.shape, mesh)
             for k, d in moe_schema(cfg).items()}
    return cfg, p, x, make_sharded_moe(cfg, mesh, "data", specs,
                                       capacity_factor=cf)


@pytest.mark.parametrize("shape,shared,cf", MOE_CASES,
                         ids=[f"{s[0]}x{s[1]}-shared{h}-cf{c}"
                              for s, h, c in MOE_CASES])
def test_sharded_moe_matches_the_reference(shape, shared, cf):
    want_y, want_m, (want_gp, want_gx), want_aux = ref_moe(shape, shared, cf)
    cfg, p, x, fn = port_moe(shape, shared, cf)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, m = fn(tp, tx)
    assert rel(y.detach().numpy(), want_y) <= 2e-6
    np.testing.assert_array_equal(m["expert_load"].numpy(),
                                  want_m["expert_load"])
    assert int(m["dropped_tokens"]) == int(want_m["dropped_tokens"])
    assert (int(m["dropped_tokens"]) == 0) == (cf == 16.0)
    for key in ("moe_aux_loss", "moe_z_loss"):
        assert abs(float(m[key].detach()) - float(want_m[key])) <= 1e-6 * abs(
            float(want_m[key]))
    names = sorted(tp)
    grads = torch.autograd.grad(torch.sum(y ** 2),
                                [tx] + [tp[k] for k in names],
                                retain_graph=True)
    assert rel(grads[0].numpy(), want_gx) <= 2e-6
    for k, g in zip(names, grads[1:]):
        assert rel(g.numpy(), want_gp[k]) <= 2e-6, k
    aux = torch.autograd.grad(m["moe_aux_loss"] + m["moe_z_loss"],
                              tp["router"])[0]
    assert rel(aux.numpy(), want_aux["router"]) <= 2e-6
    if cf == 16.0:     # no drops: the grouping changes nothing
        y1, m1 = apply_moe(cfg, {k: torch.tensor(v) for k, v in p.items()},
                           torch.tensor(x), capacity_factor=16.0)
        assert rel(y.detach().numpy(), y1.numpy()) <= 1e-6
        assert torch.equal(m1["expert_load"], m["expert_load"])


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_sharded_moe_in_bfloat16_is_bit_for_bit(shape):
    arch = "granite-moe-3b-a800m"
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    p = jax.tree.map(np.asarray, ref_init_params(
        ref_moe_schema(ref_cfg), jax.random.PRNGKey(0)))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 16, 128)),
                    jnp.bfloat16)
    mesh = ref_mesh(shape)
    fn = ref_sharded_moe(ref_cfg, mesh, "data", {
        k: ref_spec_for_axes(d.axes, d.shape, mesh)
        for k, d in ref_moe_schema(ref_cfg).items()})
    want, want_m = jax.jit(fn)(p, x)
    pmesh = port_mesh(shape)
    got, m = make_sharded_moe(cfg, pmesh, "data", {
        k: spec_for_axes(d.axes, d.shape, pmesh)
        for k, d in moe_schema(cfg).items()})(
        {k: torch.tensor(v) for k, v in p.items()},
        torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert int(m["dropped_tokens"]) == int(want_m["dropped_tokens"]) > 0


def test_sharded_moe_takes_blocks():
    """Weights and tokens given as their ``shard_tensor`` blocks give the
    blocks of the whole-tensor call."""
    cfg, p, x, fn = port_moe((2, 2), 1, 1.25)
    mesh = port_mesh((2, 2))
    specs = {k: spec_for_axes(d.axes, d.shape, mesh)
             for k, d in moe_schema(cfg).items()}
    specs["router"] = (None, None)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    x_place = Placement(mesh, ("data", "model", None))
    blocks, _ = fn({k: shard_tensor(v, Placement(mesh, specs[k]))
                    for k, v in tp.items()},
                   shard_tensor(torch.tensor(x), x_place))
    whole, _ = fn(tp, torch.tensor(x))
    for got, want in zip(blocks, shard_tensor(whole, x_place)):
        assert torch.equal(got, want)


# ------------------------------------------------------- pipeline

def stage_layers(s, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(d, d)) * 0.3).astype(np.float32)}
            for _ in range(s)]


def torch_stage(p, x):
    for l in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][l])
    return x


def jax_stage(p, x):
    y, _ = jax.lax.scan(lambda xc, wl: (jnp.tanh(xc @ wl["w"]), None), x, p)
    return y


@pytest.mark.parametrize("layers_per_stage", [1, 2])
def test_pipeline_matches_sequential_and_the_reference(layers_per_stage):
    s, d, m = 4, 8, 4
    layers = stage_layers(s * layers_per_stage, d, 0)
    mbs = np.random.default_rng(0).normal(size=(m, 3, d)).astype(np.float32)
    mesh = ref_mesh((s,), ("pod",))
    want = jax.jit(ref_pipeline.pipeline_apply(jax_stage, mesh))(
        ref_pipeline.split_stages(
            [{"w": jnp.asarray(l["w"])} for l in layers], s),
        jnp.asarray(mbs))
    tl = [{"w": torch.tensor(l["w"])} for l in layers]
    got = pipeline_apply(torch_stage, port_mesh((s,), ("pod",)))(
        split_stages(tl, s), torch.tensor(mbs))
    seq = torch.tensor(mbs)
    for l in tl:
        seq = torch.tanh(seq @ l["w"])
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_grad_flows_through_pipeline():
    s, d = 4, 4
    layers = stage_layers(s, d, 1)
    mbs = np.random.default_rng(1).normal(size=(2, 2, d)).astype(np.float32)
    mesh = ref_mesh((s,), ("pod",))
    piped = ref_pipeline.pipeline_apply(jax_stage, mesh)
    want = jax.jit(jax.grad(lambda sp: jnp.sum(piped(sp, jnp.asarray(
        mbs)) ** 2)))(ref_pipeline.split_stages(
            [{"w": jnp.asarray(l["w"])} for l in layers], s))
    stacked = split_stages([{"w": torch.tensor(l["w"])} for l in layers], s)
    w = stacked["w"].requires_grad_()
    out = pipeline_apply(torch_stage, port_mesh((s,), ("pod",)))(
        {"w": w}, torch.tensor(mbs))
    (got,) = torch.autograd.grad(torch.sum(out ** 2), [w])
    seq_w = [torch.tensor(l["w"], requires_grad=True) for l in layers]
    x = torch.tensor(mbs)
    for wl in seq_w:
        x = torch.tanh(x @ wl)
    seq = torch.autograd.grad(torch.sum(x ** 2), seq_w)
    np.testing.assert_allclose(got.numpy(), split_stages(
        [{"w": g} for g in seq], s)["w"].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["w"]),
                               rtol=1e-4, atol=1e-5)


def test_split_stages_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="equal stages"):
        split_stages([{"w": torch.zeros(2)}] * 3, 2)


# ------------------------------------------------------- compression

@functools.lru_cache(maxsize=None)
def ref_quantized(n, bits, feedback):
    """repro's reduced values (and residuals) of the seed-2 tree over n
    data shards, under shard_map."""
    mesh = ref_mesh((n,), ("data",))
    tree = quant_tree(n)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    res = ({k: jnp.asarray(v * 1e-3) for k, v in tree.items()}
           if feedback else None)

    def f(t, r):
        return ref_compression.quantized_tree_psum(
            t, "data", bits=bits, residual=r)
    red, new = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))(jt, res)
    return jax.tree.map(np.asarray, red), jax.tree.map(np.asarray, new)


def quant_tree(n):
    rng = np.random.default_rng(2)
    return {"a": rng.normal(size=(n, 1, 64)).astype(np.float32),
            "b": (rng.normal(size=(n, 3, 5)) * 1e-3).astype(np.float32)}


@pytest.mark.parametrize("feedback", [False, True],
                         ids=["plain", "feedback"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantized_tree_psum_matches_the_reference(bits, feedback):
    n = 4
    want_red, want_res = ref_quantized(n, bits, feedback)
    tree = quant_tree(n)
    trees = [{k: torch.tensor(v[i]) for k, v in tree.items()}
             for i in range(n)]
    residual = ([{k: torch.tensor(v[i] * 1e-3) for k, v in tree.items()}
                 for i in range(n)] if feedback else None)
    red, res = quantized_tree_psum(trees, port_mesh((n,), ("data",)),
                                   "data", bits=bits, residual=residual)
    for i in range(n):
        for k in tree:
            np.testing.assert_array_equal(red[i][k].numpy(),
                                          want_red[k][i])
            got, want = res[i][k].numpy(), want_res[k][i]
            assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def test_quantized_psum_close_to_exact():
    n = 4
    xs = np.random.default_rng(2).normal(size=(n, 64)).astype(np.float32)
    out = quantized_psum([torch.tensor(x) for x in xs],
                         port_mesh((n,), ("data",)), "data", bits=8)
    exact = xs.sum(axis=0)
    err = np.abs(out[0].numpy() - exact).max()
    assert err <= n * float(np.abs(xs).max()) / 127 + 1e-5
    for o in out[1:]:
        assert torch.equal(o, out[0])


def test_bits16_tighter_than_bits4():
    n = 4
    xs = np.random.default_rng(3).normal(size=(n, 256)).astype(np.float32)
    mesh = port_mesh((n,), ("data",))

    def err_for(bits):
        out = quantized_psum([torch.tensor(x) for x in xs], mesh, "data",
                             bits=bits)
        return np.abs(out[0].numpy() - xs.sum(axis=0)).mean()
    assert err_for(16) < err_for(4)


def test_error_feedback_residual_shapes():
    n = 4
    trees = [{"a": torch.ones(1, 8), "b": torch.zeros(1, 4)}
             for _ in range(n)]
    red, res = quantized_tree_psum(trees, port_mesh((n,), ("data",)),
                                   "data", bits=8)
    assert red[0]["a"].shape == (1, 8) and res[0]["b"].shape == (1, 4)
    np.testing.assert_allclose(red[0]["a"].numpy(), np.full((1, 8), n),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="bits"):
        quantized_psum([torch.ones(2)], port_mesh((1,), ("data",)), "data",
                       bits=1)


# ------------------------------------------------------- train step

#: the shard_map step's bounds, per mesh, measured as ``tc.STEP``'s are
#: (worst leaf of mu (corr, rel), of nu (corr, rel), |loss| and
#: |grad_norm ratio - 1|, each the measured value widened by half its
#: distance from exact): reduced deepseek-moe-16b, 2x2 measured (0.999859,
#: 0.0207, 0.999599, 0.0380, 1.33e-3, 3.1e-4), 1x4 (0.999839, 0.0284,
#: 0.999701, 0.0499, 1.57e-3, 5.5e-4)
SHARD_STEP = {(2, 2): (0.99979, 0.031, 0.9994, 0.057, 0.002, 0.00046),
              (1, 4): (0.99976, 0.043, 0.99955, 0.075, 0.0024, 0.00083)}
MOE_ARCH = "deepseek-moe-16b"


@functools.lru_cache(maxsize=None)
def ref_shard_step(shape):
    ref_cfg, _ = tc.configs(MOE_ARCH)
    step, _, _ = ref_train_loop.build_train_step(
        ref_cfg, ref_mesh(shape), RefShapeSpec("t", "train", tc.S, tc.B),
        tc.opt_cfgs()[0], q_chunk=tc.Q_CHUNK, rec_chunk=tc.REC_CHUNK,
        remat=False, moe_impl="shard_map")
    params = jax.tree.map(jnp.asarray, tc.ref_params(MOE_ARCH))
    out = jax.jit(step)(params, ref_opt.init_state(params),
                        tc.jax_batch(tc.train_batch(ref_cfg)))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_shard_map_train_step_matches_the_reference(shape, monkeypatch):
    ref_cfg, cfg = tc.configs(MOE_ARCH)
    want = ref_shard_step(shape)
    step, shardings, abstract = train_loop.build_train_step(
        cfg, port_mesh(shape), ShapeSpec("t", "train", tc.S, tc.B),
        tc.opt_cfgs()[1], q_chunk=tc.Q_CHUNK, rec_chunk=tc.REC_CHUNK,
        remat=False, moe_impl="shard_map")
    m = tc.trainable(MOE_ARCH)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    m, opt_state, metrics = step(m, optimizer.init_state(m),
                                 tc.torch_batch(tc.train_batch(ref_cfg)))
    monkeypatch.setitem(tc.STEP, (MOE_ARCH, "shard_map"), SHARD_STEP[shape])
    tc.hold_step(MOE_ARCH, "shard_map", before, m, opt_state, metrics, want)
    assert int(metrics["dropped_tokens"]) > 0


def test_reference_values_move_with_the_mesh():
    """``repro``'s forward of reduced qwen2-0.5b under its activation
    sharder on a (2, 2) mesh differs from the same on (1, 1), which the
    port computes bit for bit: GSPMD partitions the program and reorders
    its float sums.  Printed under ``-s``."""
    arch = "qwen2-0.5b"
    ref_cfg, cfg = tc.configs(arch)
    batch = tc.train_batch(ref_cfg)
    with torch.no_grad():
        want, _, _ = model.forward(cfg, tc.trainable(arch),
                                   tc.torch_batch(batch), q_chunk=tc.Q_CHUNK)
    want = want.float().numpy()
    diffs = {}
    for shape in [(1, 1), (2, 2)]:
        sharder = ref_activation_sharder(ref_mesh(shape), tc.B, tc.S)
        x, _, _ = jax.jit(lambda p, b: ref_model.forward(
            ref_cfg, p, b, q_chunk=tc.Q_CHUNK, sharder=sharder))(
            tc.ref_params(arch), tc.jax_batch(batch))
        got = np.asarray(x.astype(jnp.float32))
        diffs[shape] = (int((got != want).sum()), rel(got, want))
    print(f"repro's hidden states against the port's: {diffs}")
    assert diffs[(1, 1)][0] == 0
    assert diffs[(2, 2)][0] > 0


@pytest.mark.parametrize("rows,grad_accum", [(3, 2), (3, 4), (2, 3)])
def test_train_step_refuses_a_batch_grad_accum_does_not_split(rows,
                                                              grad_accum):
    """The port once trained on ``grad_accum · (rows // grad_accum)`` rows
    and dropped the rest; ``repro``'s reshape refuses such a batch."""
    arch = "qwen2-0.5b"
    ref_cfg, cfg = tc.configs(arch)
    batch = tc.train_batch(ref_cfg, batch=rows)
    ref_step, _, _ = ref_train_loop.build_train_step(
        ref_cfg, ref_mesh((1, 1)), RefShapeSpec("t", "train", tc.S, rows),
        tc.opt_cfgs()[0], q_chunk=tc.Q_CHUNK, remat=False,
        grad_accum=grad_accum)
    params = jax.tree.map(jnp.asarray, tc.ref_params(arch))
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(ref_step, params, ref_opt.init_state(params),
                       tc.jax_batch(batch))
    step, _, _ = train_loop.build_train_step(
        cfg, None, ShapeSpec("t", "train", tc.S, rows), tc.opt_cfgs()[1],
        q_chunk=tc.Q_CHUNK, remat=False, grad_accum=grad_accum)
    m = tc.trainable(arch)
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    with pytest.raises(ValueError, match=f"grad_accum {grad_accum} .* "
                       f"{rows} rows"):
        step(m, optimizer.init_state(m), tc.torch_batch(batch))
    for n, p in m.named_parameters():      # refused before any update
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-1.3b",
                                  "granite-moe-3b-a800m"])
def test_scan_layers_and_rec_unroll_change_no_value(arch):
    ref_cfg, cfg = tc.configs(arch)
    m = tc.trainable(arch)
    batch = tc.torch_batch(tc.train_batch(ref_cfg))
    out = []
    for scan_layers, rec_unroll in [(True, False), (False, True)]:
        loss, metrics = model.loss_fn(
            cfg, m, batch, q_chunk=tc.Q_CHUNK, rec_chunk=tc.REC_CHUNK,
            scan_layers=scan_layers, rec_unroll=rec_unroll)
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()),
                                              allow_unused=True)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def test_sharded_restore_of_a_reference_checkpoint(tmp_path):
    """``repro`` writes a reduced config's parameters; the port restores
    them onto a (2, 2) mesh of CPU devices with ``build_train_step``'s
    placements into its abstract state: each leaf as its blocks, block
    for block as ``repro``'s ``restore(shardings=)`` places it."""
    arch = "qwen2-0.5b"
    ref_cfg, cfg = tc.configs(arch)
    params = tc.ref_params(arch)
    ref_checkpoint.CheckpointManager(tmp_path).save(3, {"params": params})
    mesh = ref_mesh((2, 2))
    ref_sh = ref_train_loop.build_train_step(
        ref_cfg, mesh, RefShapeSpec("t", "train", tc.S, tc.B))[1]["params"]
    want, _ = ref_checkpoint.CheckpointManager(tmp_path).restore(
        {"params": jax.tree.map(np.zeros_like, params)},
        shardings={"params": ref_sh})
    pmesh = port_mesh((2, 2))
    _, shardings, abstract = train_loop.build_train_step(
        cfg, pmesh, ShapeSpec("t", "train", tc.S, tc.B))
    got, step = CheckpointManager(tmp_path).restore(
        {"params": abstract["params"]},
        shardings={"params": shardings["params"]})
    assert step == 3
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    n_sharded = 0
    for path, arr in flat_want:
        node = got
        for k in path:
            node = node[k.key]
        assert isinstance(node, list) and len(node) == 4
        for shard in arr.addressable_shards:
            np.testing.assert_array_equal(node[order[shard.device]].numpy(),
                                          np.asarray(shard.data))
        n_sharded += node[0].shape != arr.shape
    assert n_sharded > 0
    # placements of the reference tree, as the port computes them
    assert tree_shardings(model.params_axes(cfg),
                          model.make_abstract_params(cfg), pmesh) == \
        shardings["params"]
