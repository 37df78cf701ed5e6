"""The collective schedule of one step, from the step's placements.

The port's stand-in for ``repro.analysis.hlo``: the reference reads each
device's collectives from the compiled SPMD program's HLO text; the port
has no HLO and no SPMD partitioner, and its placements on a production
mesh are computed, not executed.  So this module *models* the schedule a
GSPMD-style program of the same placements runs on one device in one
step.  It is a model, not a measurement.  The result has the form
``repro.analysis.hlo.collective_summary`` returns (``bytes_by_kind``,
``counts_by_kind``, ``total_bytes``, ``total_count``), per device, with
the reference's kind names.

Notation: the mesh has axes ``pod`` (P, 1 when absent), ``data`` (D) and
``model`` (M).  A parameter leaf has ``n`` elements, ``r`` repeats (its
stacked ``layers`` dim, 1 for a top-level leaf), ``bm`` blocks over
``model`` and ``b`` blocks in all under its placement; it is read in
bfloat16 (2 bytes) unless the forward reads it in float32 (norm scales
and biases, the recurrent blocks' ``F32_LEAVES``: 4 bytes).  The batch
is ``Bl`` rows a device (``batch_axes``); a micro-batch of a step under
``grad_accum`` ``a`` holds ``Bl/a``.  ``S`` is the sequence a row
carries (half the cell's for an encoder-decoder's decoder, the other
half its encoder's; 1 for decode), ``T = Bl·S/a`` the tokens of a
micro-batch and ``h = T·d_model·2`` bytes its bfloat16 hidden states.
The sequence is *sharded* when ``activation_spec`` puts ``model`` on it
(``seq_shard``, ``S % M == 0``, ``M > 1``; never for decode).

A step runs ``a`` micro-batches (prefill and decode: one) and each
micro-batch these passes over the layers: forward, backward, and with
``remat`` the forward again (``2 + remat``; prefill and decode 1); the
embedding, final norm, head and loss run forward and backward only (2;
prefill and decode 1).  The backward mirrors each forward collective
(all-gather ↔ reduce-scatter, all-reduce ↔ all-reduce) at the same
bytes.  Per device:

* **FSDP all-gathers** — each leaf whose placement uses ``data`` is
  gathered over ``data`` at every use, once per pass it runs in:
  ``r`` all-gathers of ``n/bm · read_bytes`` (the gathered size) each.
* **Gradient reductions** (train, once per micro-batch), of each leaf's
  float32 gradient: over ``data``, a reduce-scatter of ``n/bm · 4``
  bytes (``r`` of them) when the leaf is sharded over ``data``, else an
  all-reduce of ``n/b · 4`` when ``D > 1``; over ``model``, an
  all-reduce of ``n/b · 4`` when the sequence is sharded and the leaf is
  not sharded over ``model`` (each model shard saw only its positions);
  across pods, an all-reduce of ``n/b · 4`` when ``P > 1``.
* **Activations over model** (``M > 1``), per pass, for each sub-layer
  of a block (its mixer, cross-attention, FFN or MoE): with the sequence
  sharded, a sub-layer with a leaf sharded over ``model`` all-gathers
  its input and reduce-scatters its output (``h`` each: Megatron
  sequence parallelism); one with none all-gathers its input if it is a
  mixer (it needs every position) and nothing if it is an FFN.  Without
  sequence sharding, a sub-layer with a leaf sharded over ``model``
  all-reduces its output (``h``), others nothing.  A vocabulary sharded
  over ``model`` adds, at the embedding, a reduce-scatter (sequence
  sharded) or an all-reduce (not) of ``h``; at the head, an all-gather
  of ``h`` when the sequence is sharded; and for the loss (train) one
  all-reduce of ``T · 8`` bytes (the float32 max and sum over the
  vocabulary shards).
* **MoE all-to-alls** — with ``moe_impl="shard_map"`` and experts split
  over ``model`` (``E % M == 0``, ``M > 1``), each MoE layer sends its
  (E, C, d) expert batch one way and its outputs back, per pass: 2
  all-to-alls of ``E · C · d · 2`` bytes, ``C = max(ceil(t·k/E·1.25),
  4)`` for a device's ``t = (Bl/a) · S/M`` tokens, as
  ``models.moe_shard.make_sharded_moe`` dispatches.  The grouped
  (``gspmd``) dispatch's re-layout is not modelled.

Not modelled: collective-permutes, the attention's own resharding when
heads do not divide ``model``, decode's combine over a cache split by
position, pipeline stages, and any overlap.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.models import recurrent as rec_mod
from repro_torch.models.common import pad_vocab, tree_paths
from repro_torch.models.model import (
    NORMS, block_schema, layer_sigs, param_schema)
from repro_torch.parallel.sharding import (
    activation_spec, batch_axes, mesh_axis_sizes, spec_for_axes)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
#: each sub-layer's subtree in a block, and whether it is a mixer
SUBLAYERS = (("mixer", True), ("cross_attn", True), ("ffn", False),
             ("moe", False))
#: ``make_sharded_moe``'s default capacity factor
MOE_CAPACITY_FACTOR = 1.25


def _parts(spec) -> set:
    out = set()
    for part in spec:
        if part is not None:
            out.update(part if isinstance(part, tuple) else (part,))
    return out


def _blocks(spec, sizes) -> int:
    return int(np.prod([sizes[a] for a in _parts(spec)] or [1]))


def read_bytes(path: tuple) -> int:
    """Bytes per element the forward reads leaf ``path`` in."""
    f32 = any(p in NORMS for p in path) or path[-1] in rec_mod.F32_LEAVES
    return 4 if f32 else 2


def collective_schedule(cfg, shape, mesh, *, rules=None, grad_accum: int = 1,
                        remat: bool = True, seq_shard: bool = True,
                        moe_impl: str = "gspmd",
                        num_layers: int | None = None) -> dict:
    """The modelled per-device collectives of one step of ``shape`` (a
    ``ShapeSpec``) on ``mesh``, in the module docstring's formulas."""
    sizes = mesh_axis_sizes(mesh)
    m, d_ax, pods = (sizes.get(ax, 1) for ax in ("model", "data", "pod"))
    kind = shape.kind
    train = kind == "train"
    a = grad_accum if train else 1
    b_ax = batch_axes(mesh, shape.global_batch)
    b_blocks = _blocks((b_ax,), sizes)
    rows = shape.global_batch // b_blocks
    s = 1 if kind == "decode" else shape.seq_len
    s_dec, s_enc = (s, 0)
    if cfg.is_encdec and kind != "decode":
        s_dec, s_enc = s // 2, s // 2
    seq = (kind != "decode" and m > 1 and activation_spec(
        mesh, shape.global_batch, shape.seq_len, seq_shard)[1] == "model")
    layer_passes = (2 + int(remat)) if train else 1
    top_passes = 2 if train else 1
    by = {k: 0 for k in KINDS}
    ct = {k: 0 for k in KINDS}

    def add(k, nbytes, count=1):
        by[k] += int(nbytes) * count
        ct[k] += count

    # ---- parameters: FSDP gathers and gradient reductions
    for path, leaf in tree_paths(param_schema(cfg, num_layers)):
        spec = spec_for_axes(leaf.axes, leaf.shape, mesh, rules)
        axes = {ax for ax in _parts(spec) if sizes[ax] > 1}
        n = int(np.prod(leaf.shape))
        reps = leaf.shape[0] if leaf.axes and leaf.axes[0] == "layers" else 1
        bm = sizes["model"] if "model" in axes else 1
        local = n // _blocks(spec, sizes)
        in_layer = path[0].startswith("g") or (
            path[0] == "encoder" and path[1] != "out_norm")
        passes = layer_passes if in_layer else top_passes
        if "data" in axes:
            add("all-gather", n // bm // reps * read_bytes(path),
                reps * passes * a)
        if not train:
            continue
        if "data" in axes:
            add("reduce-scatter", n // bm // reps * 4, reps * a)
        elif d_ax > 1:
            add("all-reduce", local // reps * 4, reps * a)
        if seq and "model" not in axes:
            add("all-reduce", local // reps * 4, reps * a)
        if pods > 1:
            add("all-reduce", local // reps * 4, reps * a)

    # ---- activations over model, and the MoE all-to-alls
    def stack(sigs, s_len, cross):
        h = rows // a * s_len * cfg.d_model * 2
        for sig in sigs:
            block = block_schema(cfg, sig, cross=cross)
            for sub, mixer in SUBLAYERS:
                if sub not in block:
                    continue
                sharded = m > 1 and any(
                    "model" in _parts(spec_for_axes(d.axes, d.shape, mesh,
                                                    rules))
                    for _, d in tree_paths(block[sub]))
                if m > 1 and seq:
                    if sharded:
                        add("all-gather", h, layer_passes * a)
                        add("reduce-scatter", h, layer_passes * a)
                    elif mixer:
                        add("all-gather", h, layer_passes * a)
                elif m > 1 and sharded:
                    add("all-reduce", h, layer_passes * a)
                if sub == "moe" and moe_impl == "shard_map" and m > 1 \
                        and cfg.num_experts % m == 0:
                    t = rows // a * (s_len // m)
                    cap = max(int(math.ceil(t * cfg.top_k / cfg.num_experts
                                            * MOE_CAPACITY_FACTOR)), 4)
                    add("all-to-all", cfg.num_experts * cap * cfg.d_model
                        * 2, 2 * layer_passes * a)

    stack(layer_sigs(cfg, num_layers), s_dec, cfg.is_encdec)
    if cfg.is_encdec:
        stack(layer_sigs(cfg, cfg.encoder_layers), s_enc, False)
    vocab_spec = spec_for_axes(("vocab", "embed"),
                               (pad_vocab(cfg.vocab_size), cfg.d_model),
                               mesh, rules)
    vocab_split = m > 1 and "model" in _parts(vocab_spec)
    if vocab_split:
        h = rows // a * s_dec * cfg.d_model * 2
        add("reduce-scatter" if seq else "all-reduce", h, top_passes * a)
        if seq:
            add("all-gather", h, top_passes * a)
        if train:
            add("all-reduce", rows // a * s_dec * 8, top_passes * a)
    by = {k: v for k, v in by.items() if ct[k]}
    ct = {k: v for k, v in ct.items() if v}
    return {"bytes_by_kind": by, "counts_by_kind": ct,
            "total_bytes": sum(by.values()), "total_count": sum(ct.values())}

