"""The port's sharding rules, placements and abstract state against the
JAX package's (``repro.parallel.sharding``, ``repro.parallel.inputs``,
``repro.train.train_loop``).

For every one of the 10 configs, on (1, 1), (2, 2) and (2, 2, 2) meshes
of ``tests/conftest.py``'s 8 virtual devices and at the production sizes
(16, 16) and (2, 16, 16), entry for entry:

* the placement of every parameter and optimizer-state leaf that
  ``build_train_step`` returns, and the abstract state's shapes and
  dtypes;
* the placement of every decode-cache leaf and of the token
  (``decode_inputs`` at train_4k's batch and length), and the cache's
  shapes and dtypes;
* the placements, shapes and dtypes of the train batch
  (``train_batch_specs``).

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so at the production sizes they run on a
stand-in object carrying those two fields; its ``NamedSharding``, which
needs real devices, is swapped there for the spec it would carry
(``unittest.mock.patch`` on the reference's module names, nothing of the
reference edited).  Each reference run is cached per (config, mesh).

Then ``shard_tensor``'s blocks against ``jax.device_put(...,
NamedSharding)``'s addressable shards, block for block, and
``unshard`` back; the cases of ``tests/test_sharding.py`` on the port's
mesh; the abstract parameters against ``make_abstract_params``; and
``make_concrete_batch`` value for value.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import all_configs as ref_all_configs
from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.models import model as ref_model
from repro.parallel import inputs as ref_inputs
from repro.parallel import sharding as ref_sharding
from repro.train import train_loop as ref_train_loop
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model
from repro_torch.parallel import inputs, sharding
from repro_torch.parallel.sharding import Placement, shard_tensor, unshard
from repro_torch.train import train_loop

ARCHS = sorted(ref_all_configs())
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the meshes of real (virtual CPU) devices; the others are stand-ins
REAL = ("1x1", "2x2", "2x2x2")


class StandIn:
    """What the reference's rules read of a mesh: its axis names and the
    shape of its device array."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


def ref_mesh(name):
    shape, axes = MESHES[name]
    if name in REAL:
        return jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(axes))
    return StandIn(shape, axes)


@contextlib.contextmanager
def reference_rules(name):
    """On a stand-in mesh, the reference's ``NamedSharding`` stands for
    its spec."""
    if name in REAL:
        yield
        return
    spec_only = lambda mesh, spec: spec  # noqa: E731
    with contextlib.ExitStack() as stack:
        for mod in (ref_sharding, ref_inputs, ref_train_loop):
            stack.enter_context(mock.patch.object(mod, "NamedSharding",
                                                  spec_only))
        yield


def spec_of(leaf) -> tuple:
    return tuple(leaf.spec if isinstance(leaf, NamedSharding) else leaf)


def flat(tree, prefix=()):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def same_specs(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        assert isinstance(got[path], Placement), path
        assert got[path].spec == spec_of(want[path]), (
            path, got[path].spec, spec_of(want[path]))
    return len(want)


def same_shapes(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        if path == ("pos",):             # the port's is the Python 0
            assert got[path] == 0 and want[path].shape == ()
            continue
        assert tuple(got[path].shape) == tuple(want[path].shape), path
        assert got[path].device.type == "meta", path
        assert str(got[path].dtype).split(".")[-1] == str(
            np.dtype(want[path].dtype)), path


def port_mesh(name):
    return Mesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def ref_train_state(arch, name):
    mesh = ref_mesh(name)
    shape = REF_SHAPES["train_4k"]
    with reference_rules(name):
        _, shardings, abstract = ref_train_loop.build_train_step(
            ref_get_config(arch), mesh, shape)
    return shardings, abstract


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_placements_equal_the_reference(arch, name):
    want_sh, want_abs = ref_train_state(arch, name)
    _, got_sh, got_abs = train_loop.build_train_step(
        get_config(arch), port_mesh(name), SHAPES["train_4k"])
    n = same_specs(got_sh, want_sh)
    assert n == 3 * len(flat(want_abs["params"])) + 1
    same_shapes(got_abs, want_abs)


@functools.lru_cache(maxsize=None)
def ref_decode_inputs(arch, name):
    with reference_rules(name):
        token, cache, shardings = ref_inputs.decode_inputs(
            ref_get_config(arch), REF_SHAPES["train_4k"], ref_mesh(name))
    return token, cache, shardings


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_placements_equal_the_reference(arch, name):
    token, cache, want = ref_decode_inputs(arch, name)
    got_token, got_cache, got = inputs.decode_inputs(
        get_config(arch), SHAPES["train_4k"], port_mesh(name))
    same_specs(got, want)
    same_shapes(got_cache, cache)
    assert tuple(got_token.shape) == token.shape
    assert got_token.dtype == torch.int32


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_placements_equal_the_reference(arch, name):
    with reference_rules(name):
        want_batch, want = ref_inputs.train_batch_specs(
            ref_get_config(arch), REF_SHAPES["train_4k"], ref_mesh(name))
    got_batch, got = inputs.train_batch_specs(
        get_config(arch), SHAPES["train_4k"], port_mesh(name))
    same_specs(got, want)
    same_shapes(got_batch, want_batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference(arch):
    want = jax.eval_shape(lambda: ref_model.make_abstract_params(
        ref_get_config(arch)))
    same_shapes(model.make_abstract_params(get_config(arch)), want)
    assert flat(model.params_axes(get_config(arch))) == flat(
        ref_model.params_axes(ref_get_config(arch)))


# ------------------------------------------------------- blocks

CASES = [("2x2", ("data", "model", None)), ("2x2", ("model", "data", None)),
         ("2x2", (None, None, "model")), ("2x2", (None, None, None)),
         ("2x2", (("data", "model"), None, None)),
         ("2x2x2", (("pod", "data"), "model", None)),
         ("2x2x2", ("data", None, ("pod", "model"))),
         ("2x2x2", (None, "pod", None)), ("2x2x2", ("model",))]


@pytest.mark.parametrize("name,spec", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_shard_tensor_blocks_equal_addressable_shards(name, spec):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 12, 4)).astype(np.float32)
    mesh = ref_mesh(name)
    arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
    pmesh = make_host_mesh(*MESHES[name], device="cpu")
    place = Placement(pmesh, spec)
    blocks = shard_tensor(torch.as_tensor(x), place)
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    assert len(arr.addressable_shards) == len(blocks)
    for shard in arr.addressable_shards:
        np.testing.assert_array_equal(blocks[order[shard.device]].numpy(),
                                      np.asarray(shard.data))
    np.testing.assert_array_equal(unshard(blocks, place).numpy(), x)


def test_shard_tensor_refuses_an_uneven_dim():
    mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        shard_tensor(torch.zeros(3, 4), Placement(mesh, ("data", None)))


def test_abstract_mesh_holds_no_devices():
    mesh = Mesh((16, 16), ("data", "model"))
    assert mesh.devices.shape == (16, 16) and not mesh.concrete
    with pytest.raises(ValueError, match="abstract"):
        shard_tensor(torch.zeros(16, 16), Placement(mesh, ("data", None)))
    # the reference's reader takes the port's mesh
    assert ref_sharding.mesh_axis_sizes(mesh) == {"data": 16, "model": 16}


# ------------------------------------------------------- test_sharding.py

@pytest.fixture(scope="module")
def mesh():
    return Mesh((2, 2), ("data", "model"))


class TestSpecForAxes:
    def test_ffn_weight(self, mesh):
        s = sharding.spec_for_axes(("embed", "ffn"), (896, 4864), mesh)
        assert s == ("data", "model")

    def test_divisibility_fallback(self, mesh):
        s = sharding.spec_for_axes(("embed", "heads", "head_dim"),
                                   (896, 7, 64), mesh)
        assert s == ("data", None, None)

    def test_mesh_axis_used_once(self, mesh):
        s = sharding.spec_for_axes(("experts", "embed", "ffn"),
                                   (64, 896, 512), mesh)
        assert s == ("model", "data", None)

    def test_batch_combo(self, mesh):
        assert sharding.batch_axes(mesh, 256) == "data"
        s = sharding.spec_for_axes(("batch", None), (256, 128), mesh)
        assert s == ("data", None)

    def test_batch_of_one_replicated(self, mesh):
        assert sharding.batch_axes(mesh, 1) is None

    def test_pod_combo(self):
        m3 = Mesh((2, 2, 2), ("pod", "data", "model"))
        assert sharding.batch_axes(m3, 8) == ("pod", "data")
        assert sharding.batch_axes(m3, 2) == "data"


class TestActivationAndCacheSpecs:
    def test_activation_seq_shard(self, mesh):
        assert sharding.activation_spec(mesh, 256, 4096) == (
            "data", "model", None)

    def test_activation_odd_seq_falls_back(self, mesh):
        assert sharding.activation_spec(mesh, 256, 4097) == (
            "data", None, None)

    def test_kv_cache_spec(self, mesh):
        s = sharding.cache_leaf_spec(("layers", "0", "k"),
                                     (128, 32768, 8, 64), mesh, 128)
        assert s == ("data", "model", None, None)

    def test_mlstm_state_spec(self, mesh):
        s = sharding.cache_leaf_spec(("layers", "3", "c"),
                                     (1, 4, 1024, 1024), mesh, 1)
        assert s == (None, None, "model", None)

    def test_scalar_spec(self, mesh):
        assert sharding.cache_leaf_spec(("pos",), (), mesh, 128) == ()


def test_all_archs_produce_valid_shardings(mesh):
    """Every param of every arch gets a spec whose sharded dims all
    divide evenly."""
    for arch in ARCHS:
        cfg = get_config(arch)
        placements = flat(sharding.tree_shardings(
            model.params_axes(cfg), model.make_abstract_params(cfg), mesh))
        leaves = flat(model.make_abstract_params(cfg))
        for path, place in placements.items():
            assert place.fits(tuple(leaves[path].shape)), (arch, path)


def test_sharders_check_and_return_their_tensor(mesh):
    sharder = sharding.make_activation_sharder(mesh, 4, 8)
    x = torch.zeros(4, 8, 3)
    assert sharder(x) is x
    _, gsh, epsh = sharding.moe_dispatch_plan(get_config(
        "granite-moe-3b-a800m"), mesh, 4, 8)
    y = torch.zeros(4, 5, 3)
    assert gsh(y) is y and epsh(y) is y
    with pytest.raises(ValueError, match="does not fit"):
        gsh(torch.zeros(()))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-2b",
                                  "seamless-m4t-medium"])
def test_concrete_batch_equals_the_reference(arch):
    """``make_concrete_batch`` draws the reference's values from the same
    ``default_rng`` stream, bfloat16 ones rounded alike."""
    want = ref_inputs.make_concrete_batch(ref_get_config(arch).reduced(), 2,
                                          16, np.random.default_rng(5))
    got = inputs.make_concrete_batch(get_config(arch).reduced(), 2, 16,
                                     np.random.default_rng(5), device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v)
        np.testing.assert_array_equal(got[k].float().numpy()
                                      if got[k].dtype == torch.bfloat16
                                      else got[k].numpy(), v, err_msg=k)
