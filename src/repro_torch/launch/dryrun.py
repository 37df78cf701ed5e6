"""Multi-pod dry run: trace every (arch × shape × mesh) cell on ``meta``.

The port of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell on 512 virtual CPU devices; the port traces the step on the
``meta`` device (shapes and dtypes, no storage), so nothing is allocated
on any device.  For each cell this produces a JSON record under
``build/dryrun/`` with the reference's keys, which the roofline analysis
(``repro_torch.analysis.roofline``) and the report read:

* ``memory`` — per device.  ``argument_bytes`` is exact: every argument
  of the step (parameters, optimizer state, batch; decode: token and
  cache, its position an int32 scalar) cut by its placement on the mesh
  (``parallel.sharding``), each device's block.  ``temp_bytes`` and
  ``output_bytes`` come from a ``meta`` trace of the *per-device* step
  that counts live storages (:class:`_Tracer`): the step run on one
  device's batch shard (its rows, and its positions where the residual
  stream is sharded over ``model``; decode: its rows and its share of
  the KV cache's positions), the parameters full width, each counted at
  its per-device size — a cast of a weight for use at its size gathered
  over ``data`` and still split over ``model`` (FSDP gathers one layer
  at a time when remat recomputes it), a gradient and every temporary of
  the optimizer at the leaf's block size.  ``output_bytes`` is what the
  step returns that is not an argument updated in place, ``temp_bytes``
  the peak live bytes less that.  ``generated_code_bytes`` is 0: eager
  torch generates no program.
* ``cost_corrected`` — global: ``flops`` from
  ``torch.utils.flop_counter.FlopCounterMode`` around the whole step at
  the global batch, remat off and one full-sequence query chunk, as the
  reference's cost lowering; ``bytes_accessed`` the same trace's unfused
  per-op bytes (every tensor read and written by each op that is not a
  view); ``collective_bytes`` the modelled schedule of
  ``analysis.collectives`` times the devices.  A config with recurrent
  layers is counted as the reference's docstring counts a scan (outer +
  repetitions × period): the step with no layers, plus each distinct
  layer signature traced once, times its layers — an sLSTM or mLSTM
  block traced over one and over two trips of its loop (a position; a
  chunk) and extended to the sequence's trips (its cost is affine in
  them: :func:`_looped_block_cost`).  The FLOPs so counted equal a
  full trace's; the unfused bytes leave out the elementwise traffic of
  the residual stream between blocks (4 % of a reduced xlstm step).
* ``cost_raw`` — the per-device trace's FLOPs and bytes, its
  micro-batch loop traced for at most three trips (the live bytes of the
  third repeat in every later one), as XLA counts a scan body once.
* ``collectives`` — ``analysis.collectives.collective_schedule``, per
  device (the reference's is read from the compiled HLO).

``FlopCounterMode`` counts matrix products and attention kernels only;
XLA's count covers every op, so elementwise work (the recurrent scans,
the norms, the softmax) is the gap between the two.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
        --shape train_4k --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis.collectives import collective_schedule
from repro_torch.configs import SHAPES, all_configs, get_config, shapes_for
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.common import ParamTree, norm_schema, tree_paths
from repro_torch.models.model import (
    LanguageModel, _positions_for, _top_schema, apply_block,
    block_schema, count_params, decode_step, layer_sigs,
    make_abstract_params, params_axes, serve_prefill)
from repro_torch.parallel.inputs import decode_inputs, train_batch_specs
from repro_torch.parallel.sharding import (
    activation_spec, batch_axes, mesh_axis_sizes, moe_dispatch_plan,
    make_activation_sharder, spec_for_axes, tree_shardings)
from repro_torch.train.optimizer import (
    OptConfig, apply_update, init_state, tree_leaves)
from repro_torch.train.train_loop import build_train_step

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: the sLSTM and mLSTM loop over positions and chunks in Python: their
#: cost is counted one trip at a time (module docstring)
LOOPED = ("slstm", "mlstm")
#: the mLSTM's chunk length (``build_train_step``'s and the forward's
#: default ``rec_chunk``)
REC_CHUNK = 256


def _one_device_mesh() -> Mesh:
    return Mesh((1, 1), ("data", "model"))


# ------------------------------------------------------------ the tracer

class _Tracer(TorchDispatchMode):
    """Counts, over the ops run under it, the live bytes of the storages
    they create (the peak, and the bytes live now), their unfused bytes
    accessed and their FLOPs (by ``FlopCounterMode``'s formulas).
    Storages of ``external`` tensors (the step's arguments) are not
    counted.  A storage is counted at its bytes over a divisor:
    ``cast_divisor`` for an op that casts a parameter (``aten._to_copy``
    of it), else that of the first same-sized input that has one
    (``divisor``: the arguments' own, gradients' from :meth:`rescale`,
    and so on down elementwise chains), else 1."""

    def __init__(self, external=(), divisor=None, cast_divisor=None):
        super().__init__()
        self.external = {self.key(t) for t in external}
        self.divisor = dict(divisor or {})
        self.cast_divisor = dict(cast_divisor or {})
        self.live: dict[int, list] = {}
        self.now = 0.0
        self.peak = 0.0
        self.bytes_accessed = 0
        self.flops = 0

    @staticmethod
    def key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _drop(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.now -= entry[0]
            del self.live[key]
            # a storage allocated later at the same address is another
            self.divisor.pop(key, None)

    def _div(self, func, ins, out: torch.Tensor) -> float:
        if func is torch.ops.aten._to_copy.default and ins:
            key = self.key(ins[0])
            if key in self.cast_divisor:
                return self.cast_divisor[key]
        for t in ins:
            key = self.key(t)
            if key in self.divisor and t.numel() == out.numel():
                return self.divisor[key]
        return 1

    def rescale(self, t: torch.Tensor, div: float) -> None:
        """Count ``t``'s storage at its bytes over ``div`` from now on."""
        key = self.key(t)
        self.divisor[key] = div
        entry = self.live.get(key)
        if entry is not None:
            nb = t.untyped_storage().nbytes() / div
            self.now += nb - entry[0]
            entry[0] = nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat_tensors((out,), [])
        ins = _flat_tensors(kwargs.values(), _flat_tensors(args, []))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in outs:
            key = self.key(t)
            if key in self.external:
                continue
            if key not in self.live:
                div = self._div(func, ins, t)
                if div != 1:
                    self.divisor[key] = div
                self.live[key] = [t.untyped_storage().nbytes() / div, 0]
                self.now += self.live[key][0]
                self.peak = max(self.peak, self.now)
            self.live[key][1] += 1
            weakref.finalize(t, self._drop, key)
        return out

    def bytes_of(self, tensors) -> float:
        """Live bytes of the counted storages among ``tensors``."""
        keys = {self.key(t) for t in tensors}
        return sum(self.live[k][0] for k in keys if k in self.live)


def _flat_tensors(xs, out: list) -> list:
    """The tensors in ``xs`` (nested lists and tuples), appended to
    ``out``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _flat_tensors(x, out)
    return out


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@dataclass
class _Traced:
    """What a traced cell gives, in the roles of a compiled program's
    ``memory_analysis()`` and ``cost_analysis()``."""
    argument_parts: dict = field(default_factory=dict)
    output_bytes: int = 0
    temp_bytes: int = 0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: dict = field(default_factory=dict)

    @property
    def argument_bytes(self) -> int:
        return int(sum(self.argument_parts.values()))


def _mem_dict(traced: _Traced):
    return {
        "argument_bytes": traced.argument_bytes,
        "output_bytes": traced.output_bytes,
        "temp_bytes": traced.temp_bytes,
        "generated_code_bytes": 0,
    }


def _cost_dict(traced: _Traced):
    return {"flops": float(traced.flops),
            "bytes_accessed": float(traced.bytes_accessed)}


# ------------------------------------------------------------ placements

def _local_bytes(tree, placements) -> int:
    """Bytes one device holds of ``tree`` (tensors, or Python numbers,
    counted as int32 scalars) under ``placements`` (the same tree)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], placements[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v, p) for v, p in zip(tree, placements))
    if not isinstance(tree, torch.Tensor):
        return 4
    blocks = int(np.prod([placements.blocks(d)
                          for d in range(len(placements.spec))] or [1]))
    return tree.numel() * tree.element_size() // blocks


def _param_divisors(model: LanguageModel, cfg, mesh, rules=None):
    """Per parameter of ``model`` (by storage): (blocks in all, blocks
    over ``model``) under its placement on ``mesh``."""
    sizes = mesh_axis_sizes(mesh)
    out = {}

    def visit(tree, schema):
        for path, leaf in tree_paths(schema):
            t = tree
            for name in path:
                t = t[name]
            spec = spec_for_axes(leaf.axes, leaf.shape, mesh, rules)
            parts = [a for part in spec if part is not None
                     for a in (part if isinstance(part, tuple) else (part,))]
            out[_Tracer.key(t)] = (
                int(np.prod([sizes[a] for a in parts] or [1])),
                sizes["model"] if "model" in parts else 1)
    visit(model, _top_schema(cfg))
    for layer, sig in zip(model.layers, layer_sigs(cfg, len(model.layers))):
        visit(layer, block_schema(cfg, sig, cross=cfg.is_encdec))
    if cfg.is_encdec:
        enc_sig = layer_sigs(cfg, cfg.encoder_layers)[0]
        visit(model.encoder, {"out_norm": norm_schema(cfg)})
        for layer in model.encoder.layers:
            visit(layer, block_schema(cfg, enc_sig))
    return out


def _local_shape(cfg, shape: ShapeSpec, mesh, seq_shard: bool) -> ShapeSpec:
    """One device's share of ``shape``: its batch rows; for train and
    prefill its positions when the residual stream is sharded over
    ``model``, for decode its share of the KV cache's positions."""
    sizes = mesh_axis_sizes(mesh)
    b_ax = batch_axes(mesh, shape.global_batch)
    parts = (b_ax,) if isinstance(b_ax, str) else tuple(b_ax or ())
    rows = shape.global_batch // int(np.prod([sizes[a] for a in parts]
                                             or [1]))
    m = sizes.get("model", 1)
    if shape.kind == "decode":
        split = m > 1 and shape.seq_len % m == 0
    else:
        split = activation_spec(mesh, shape.global_batch, shape.seq_len,
                                seq_shard)[1] == "model"
    s = shape.seq_len // m if split else shape.seq_len
    return ShapeSpec(shape.name, shape.kind, s, rows)


# ------------------------------------------------------------ traces

def _run_traced(run, args, external, divisors=None, casts=None,
                grads_of=None, flop_counter: bool = False):
    """Run ``run(*args)`` under a :class:`_Tracer` -> (tracer, FLOPs,
    output tensors); the FLOPs are ``FlopCounterMode``'s around the run
    when ``flop_counter``, else the tracer's own.  ``grads_of`` maps each
    leaf whose gradient is counted at its block size to that size's
    divisor."""
    tracer = _Tracer(external, divisors, casts)
    hooks = [leaf.register_hook(
        lambda g, div=div: (tracer.rescale(g, div), g)[1])
        for leaf, div in (grads_of or {}).items()]
    counter = FlopCounterMode(display=False) if flop_counter else None
    try:
        with counter or contextlib.nullcontext(), tracer:
            out = run(*args)
    finally:
        for h in hooks:
            h.remove()
    flops = counter.get_total_flops() if counter else tracer.flops
    return tracer, flops, _tensors(out)


def _train_parts(cfg, shape, mesh, num_layers=None, rules=None, **kw):
    """Per-device bytes of a train step's arguments on ``mesh``, by
    argument (params, opt, batch)."""
    _, shardings, abstract = build_train_step(
        cfg, mesh, shape, OptConfig(), num_layers=num_layers, rules=rules,
        **kw)
    batch, batch_shard = train_batch_specs(cfg, shape, mesh)
    parts = {"params": _local_bytes(abstract["params"],
                                    shardings["params"]),
             "opt": _local_bytes(abstract["opt"], shardings["opt"]),
             "batch": _local_bytes(batch, batch_shard)}
    return parts


def _meta_model(cfg, num_layers=None, trainable=False) -> LanguageModel:
    return LanguageModel(cfg, num_layers, device="meta").requires_grad_(
        trainable)


def _trace_step(kind, cfg, shape, mesh, *, num_layers=None, q_chunk=512,
                seq_shard=True, remat=True, grad_accum=1, kv_quant=False,
                rules=None, divisors_mesh=None, flop_counter=False):
    """Trace one step of ``kind`` at ``shape`` on ``mesh`` -> (tracer,
    flops, outputs).  ``divisors_mesh`` (default: none) is the mesh whose
    placements set each parameter's divisors; ``flop_counter`` is
    :func:`_run_traced`'s."""
    model = _meta_model(cfg, num_layers, trainable=kind == "train")
    divisors, casts, grads = {}, {}, {}
    if divisors_mesh is not None:
        per = _param_divisors(model, cfg, divisors_mesh, rules)
        for p in model.parameters():
            total, over_model = per[_Tracer.key(p)]
            divisors[_Tracer.key(p)] = total
            casts[_Tracer.key(p)] = over_model
            if kind == "train":
                grads[p] = total
    if kind == "train":
        step, _, _ = build_train_step(
            cfg, mesh, shape, OptConfig(), num_layers=num_layers,
            q_chunk=q_chunk, seq_shard=seq_shard, remat=remat,
            grad_accum=grad_accum)
        opt = init_state(model)
        for name, p in model.named_parameters():
            for moment in ("mu", "nu"):
                if _Tracer.key(p) in divisors:
                    divisors[_Tracer.key(opt[moment][name])] = \
                        divisors[_Tracer.key(p)]
        batch, _ = train_batch_specs(cfg, shape, mesh)
        args = (model, opt, batch)
        return _run_traced(step, args, _tensors(args), divisors, casts,
                           grads, flop_counter)
    if kind == "prefill":
        sharder = make_activation_sharder(mesh, shape.global_batch,
                                          shape.seq_len, seq_shard=seq_shard)
        groups, gsh, ep = moe_dispatch_plan(cfg, mesh, shape.global_batch,
                                            shape.seq_len, seq_shard)
        batch, _ = train_batch_specs(cfg, shape, mesh)
        batch.pop("labels")

        def step(params, batch):
            return serve_prefill(cfg, params, batch, q_chunk=q_chunk,
                                 sharder=sharder, moe_groups=groups,
                                 ep_sharder=ep, moe_group_sharder=gsh)
        args = (model, batch)
        return _run_traced(step, args, _tensors(args), divisors, casts,
                           flop_counter=flop_counter)
    token, cache, _ = decode_inputs(cfg, shape, mesh, kv_quant=kv_quant)

    def step(params, token, cache):
        return decode_step(cfg, params, token, cache)
    args = (model, token, cache)
    return _run_traced(step, args, _tensors(args), divisors, casts,
                       flop_counter=flop_counter)


def _block_cost(cfg, sig, kind, rows, s, q_chunk):
    """(FLOPs, bytes accessed) of one block of ``sig`` over ``rows`` x
    ``s`` positions; for a train step its backward and the optimizer's
    update of its leaves too."""
    train = kind == "train"
    p = ParamTree(block_schema(cfg, sig), "meta").requires_grad_(train)
    x = torch.empty((rows, s, cfg.d_model), dtype=torch.bfloat16,
                    device="meta", requires_grad=train)
    opt = init_state(p) if train else {}
    ctx = dict(positions=_positions_for(cfg, {}, rows, s, "meta"),
               causal=True, q_chunk=q_chunk, rec_chunk=REC_CHUNK,
               want_cache=kind == "prefill", enc_out=None, remat=False)

    def run():
        y, _ = apply_block(cfg, sig, p, x, ctx)
        if train:
            names, leaves = zip(*tree_leaves(p))
            grads = torch.autograd.grad(y, [x, *leaves],
                                        grad_outputs=torch.empty_like(y))
            apply_update(OptConfig(), p, dict(zip(names, grads[1:])), opt)
        return y
    tracer, flops, _ = _run_traced(run, (), [x, *p.parameters()]
                                   + _tensors(opt), flop_counter=True)
    return flops, tracer.bytes_accessed


def _looped_block_cost(cfg, sig, kind, rows, s, q_chunk):
    """:func:`_block_cost` at ``s`` positions, a looped block counted by
    its trips: with ``t`` positions a trip (the sLSTM 1, the mLSTM a
    chunk), ``s = r + q·t`` for ``0 < r <= t``, the cost is affine in
    ``q`` (a trip's work, plus the weights and the first trip's, which
    do not repeat), so two traces, at ``r`` and ``r + t`` positions,
    give it exactly: ``cost(r) + q · (cost(r + t) - cost(r))``."""
    if sig[0] not in LOOPED:
        return _block_cost(cfg, sig, kind, rows, s, q_chunk)
    t = 1 if sig[0] == "slstm" else REC_CHUNK
    r = s % t or t
    q = (s - r) // t
    first = _block_cost(cfg, sig, kind, rows, r, q_chunk)
    if q == 0:
        return first
    second = _block_cost(cfg, sig, kind, rows, r + t, q_chunk)
    return tuple(a + q * (b - a) for a, b in zip(first, second))


def _global_cost(kind, cfg, shape, mesh, *, q_chunk, seq_shard, kv_quant,
                 num_layers=None):
    """Global (FLOPs, bytes accessed) of one step, remat off: one trace of
    the whole step, or for a config with looped layers the step with no
    layers plus each signature's blocks (:func:`_looped_block_cost`)."""
    n = cfg.num_layers if num_layers is None else num_layers
    sigs = layer_sigs(cfg, n)
    looped = kind != "decode" and any(k in LOOPED for k, _ in sigs)
    if not looped:
        tracer, flops, _ = _trace_step(
            kind, cfg, shape, mesh, num_layers=num_layers, q_chunk=q_chunk,
            seq_shard=seq_shard, remat=False, kv_quant=kv_quant,
            flop_counter=True)
        return flops, tracer.bytes_accessed
    if cfg.is_encdec:
        raise NotImplementedError("looped layers in an encoder-decoder")
    tracer, flops, _ = _trace_step(
        kind, cfg, shape, mesh, num_layers=0, q_chunk=q_chunk,
        seq_shard=seq_shard, remat=False, kv_quant=kv_quant,
        flop_counter=True)
    nbytes = tracer.bytes_accessed
    for sig in sorted(set(sigs)):
        f, b = _looped_block_cost(cfg, sig, kind, shape.global_batch,
                                  shape.seq_len, q_chunk)
        flops += f * sigs.count(sig)
        nbytes += b * sigs.count(sig)
    return flops, nbytes


def _compile(kind, cfg, shape, mesh, *, num_layers=None, scan_layers=True,
             rec_unroll=False, q_chunk=512, seq_shard=True, rules=None,
             remat=True, lower_only=False, grad_accum=1, moe_impl="gspmd",
             kv_quant=False):
    """The port's counterpart of the reference's compile of one cell (a
    ``meta`` trace; nothing is compiled) -> (:class:`_Traced`, seconds).
    ``lower_only``: the global cost trace alone (remat as given; the
    caller turns it off).  Otherwise: the argument bytes, the per-device
    trace and the collective schedule.  ``scan_layers`` and
    ``rec_unroll`` are the reference's compile choices and change
    nothing here; ``moe_impl`` reaches the collective model (the traces
    run the grouped dispatch: ``"shard_map"`` needs concrete devices)."""
    del scan_layers, rec_unroll
    t0 = time.time()
    if lower_only:
        flops, nbytes = _global_cost(kind, cfg, shape, mesh, q_chunk=q_chunk,
                                     seq_shard=seq_shard, kv_quant=kv_quant,
                                     num_layers=num_layers)
        return _Traced(flops=flops, bytes_accessed=nbytes), time.time() - t0
    if kind == "train":
        parts = _train_parts(cfg, shape, mesh, num_layers, rules,
                                q_chunk=q_chunk, seq_shard=seq_shard,
                                remat=remat, grad_accum=grad_accum)
    else:
        abs_params = make_abstract_params(cfg, num_layers)
        p_shard = tree_shardings(params_axes(cfg, num_layers), abs_params,
                                 mesh, rules)
        parts = {"params": _local_bytes(abs_params, p_shard)}
        if kind == "prefill":
            batch, batch_shard = train_batch_specs(cfg, shape, mesh)
            batch.pop("labels")
            batch_shard.pop("labels")
            parts["batch"] = _local_bytes(batch, batch_shard)
        else:
            token, cache, sh = decode_inputs(cfg, shape, mesh,
                                             kv_quant=kv_quant)
            parts["token"] = _local_bytes(token, sh["token"])
            parts["cache"] = _local_bytes(cache, sh["cache"])
    local = _local_shape(cfg, shape, mesh, seq_shard)
    trips = grad_accum
    if kind == "train":
        if local.global_batch % grad_accum:
            raise ValueError(f"grad_accum {grad_accum} does not divide a "
                             f"device's {local.global_batch} rows")
        # the live bytes of micro-batch 3 (the gradient sum, the last
        # micro-batch's gradients and a new one's activations: the second
        # sums into the first's) repeat in every later one: three trips
        # give the step's peak
        trips = min(grad_accum, 3)
        local = ShapeSpec(local.name, local.kind, local.seq_len,
                          local.global_batch // grad_accum * trips)
    tracer, flops, outs = _trace_step(
        kind, cfg, local, _one_device_mesh(), num_layers=num_layers,
        q_chunk=q_chunk, seq_shard=seq_shard, remat=remat,
        grad_accum=trips, kv_quant=kv_quant, rules=rules,
        divisors_mesh=mesh)
    output = tracer.bytes_of(outs)
    coll = collective_schedule(cfg, shape, mesh, rules=rules,
                               grad_accum=grad_accum, remat=remat,
                               seq_shard=seq_shard, moe_impl=moe_impl,
                               num_layers=num_layers)
    traced = _Traced(argument_parts=parts, output_bytes=int(output),
                     temp_bytes=int(tracer.peak - output), flops=flops,
                     bytes_accessed=tracer.bytes_accessed,
                     collectives=coll)
    return traced, time.time() - t0


def _lower_train(cfg, shape, mesh, **kw):
    return _compile("train", cfg, shape, mesh, **kw)


def _lower_prefill(cfg, shape, mesh, **kw):
    kw.pop("grad_accum", None)
    return _compile("prefill", cfg, shape, mesh, **kw)


def _lower_decode(cfg, shape, mesh, *, num_layers=None, rules=None,
                  lower_only=False, kv_quant=False, **_ignored):
    return _compile("decode", cfg, shape, mesh, num_layers=num_layers,
                  rules=rules, lower_only=lower_only, kv_quant=kv_quant)


def _cell_record(cfg, shape, mesh, rec: dict, *, q_chunk: int = 512,
                 seq_shard: bool = True, rules=None,
                 overrides: dict | None = None) -> dict:
    """Fill ``rec`` with the cell's traced fields, as the reference's
    ``run_cell`` does, for any config, shape and mesh."""
    kind = shape.kind
    ndev = mesh.size
    lower_map = {
        "train": _lower_train, "prefill": _lower_prefill,
        "decode": _lower_decode,
    }
    # long sequences: bigger q chunks keep the chunk count bounded;
    # memory stays sharded per-device
    q_main = 2048 if shape.seq_len >= 32_768 else q_chunk
    # MoE: keep the token layout purely data-sharded so dispatch groups
    # align with device shards
    if cfg.is_moe:
        seq_shard = False
    kwargs = {} if kind == "decode" else dict(
        q_chunk=q_main, seq_shard=seq_shard)
    main_kwargs = dict(kwargs)
    if cfg.is_moe and kind == "train":
        # microbatch the dispatch transients, as the reference does
        main_kwargs["grad_accum"] = 4
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
        if "seq_shard" in overrides and kind != "decode":
            main_kwargs["seq_shard"] = overrides["seq_shard"]
            kwargs["seq_shard"] = overrides["seq_shard"]
        for key in ("grad_accum", "moe_impl", "kv_quant", "q_chunk"):
            if key in overrides:
                main_kwargs[key] = overrides[key]
    traced, dt = lower_map[kind](cfg, shape, mesh, rules=rules,
                                 **main_kwargs)
    rec["compile_seconds"] = round(dt, 1)
    rec["memory"] = _mem_dict(traced)
    rec["cost_raw"] = _cost_dict(traced)
    coll = traced.collectives
    rec["collectives"] = coll

    # global cost: one trace at the global batch, remat off, one
    # full-sequence query chunk (attention FLOPs do not depend on it)
    kwargs_cost = dict(kwargs, q_chunk=shape.seq_len)
    if "kv_quant" in main_kwargs:
        kwargs_cost["kv_quant"] = main_kwargs["kv_quant"]
    cost, dt2 = lower_map[kind](cfg, shape, mesh, rules=rules,
                                scan_layers=False, rec_unroll=True,
                                remat=False, lower_only=True, **kwargs_cost)
    cc = _cost_dict(cost)
    cc["collective_bytes"] = coll["total_bytes"] * ndev  # global-ize
    rec["cost_corrected"] = cc
    rec["cost_method"] = "meta-trace"
    rec["cost_scope"] = "global"
    rec["lower_seconds_cost"] = round(dt2, 1)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             *, q_chunk: int = 512, seq_shard: bool = True,
             rules=None, variant: str = "baseline",
             overrides: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "devices": mesh.size,
        "variant": variant,
        "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "timestamp": time.time(),
    }
    return _cell_record(cfg, shape, mesh, rec, q_chunk=q_chunk,
                        seq_shard=seq_shard, rules=rules,
                        overrides=overrides)


def cell_list(archs=None):
    cells = []
    for arch, cfg in sorted(all_configs().items()):
        if archs and arch not in archs:
            continue
        for shape in shapes_for(cfg):
            cells.append((arch, shape.name))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    cells = cell_list(args.arch)
    if args.shape:
        cells = [c for c in cells if c[1] in args.shape]

    results = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            path = out / f"{tag}.json"
            if path.exists() and not args.force:
                print(f"[skip] {tag}")
                continue
            print(f"[run ] {tag}", flush=True)
            t0 = time.time()
            try:
                rec = run_cell(arch, shape, mp)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — record the failure
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
            rec["wall_seconds"] = round(time.time() - t0, 1)
            path.write_text(json.dumps(rec, indent=2, default=str))
            print(f"       {rec['status']} in {rec['wall_seconds']}s",
                  flush=True)
            results.append(rec)
    ok = sum(r["status"] == "ok" for r in results)
    print(f"done: {ok}/{len(results)} cells ok")
    return results


if __name__ == "__main__":
    main()
