"""Logical-axis sharding rules → placements.

The port of ``repro.parallel.sharding``.  Every parameter carries logical
axis names from its schema (``vocab``, ``embed``, ``ffn``, ``heads``,
``experts``, ...).  Rules map logical axes to mesh axes with two
safeguards applied dim by dim:

* divisibility — a dim that doesn't divide evenly by the mesh axis size
  falls back to unsharded (e.g. 40 experts or 14 heads over a 16-way
  ``model`` axis);
* uniqueness — a mesh axis is used at most once per tensor.

Default layout = FSDP(``data``) × TP(``model``): weights shard their
feature dim over ``model`` and their ``embed`` dim over ``data``,
activations shard batch over ``data`` (+``pod``) and the sequence over
``model``.

What differs from the reference, and why: torch has no
``PartitionSpec``/``NamedSharding`` outside a process group, so a *spec*
is a plain tuple with one entry per dim (``None``, a mesh axis name or a
tuple of names) and a :class:`Placement` pairs it with a
:class:`~repro_torch.launch.mesh.Mesh`.  The rules read only
``mesh.axis_names`` and ``mesh.devices.shape``, so they run at the
production sizes on an abstract mesh.  :func:`shard_tensor` cuts a tensor
into each device's block and :func:`unshard` puts the blocks back.  The
sharders (:func:`make_activation_sharder`, :func:`moe_dispatch_plan`'s)
are constraints: in one process there is nothing to re-lay-out, so each
checks that its tensor's rank fits the spec and returns it unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: logical axis -> preferred mesh axes, in priority order.
DEFAULT_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": (),            # usually too small; replicated
    "lru": ("model",),
    "embed": ("data",),        # FSDP / ZeRO-3 param sharding
    "head_dim": (),
    "layers": (),
    "batch": ("pod", "data"),
    "seq": ("model",),
}


@dataclass(frozen=True)
class Placement:
    """A tensor's layout over ``mesh``: ``spec`` has one entry per dim,
    ``None`` (whole on every device), a mesh axis name or a tuple of
    names (split over those axes, the first outermost)."""
    mesh: object
    spec: tuple

    def parts(self, dim: int) -> tuple:
        part = self.spec[dim] if dim < len(self.spec) else None
        if part is None:
            return ()
        return part if isinstance(part, tuple) else (part,)

    def blocks(self, dim: int) -> int:
        """How many blocks dim ``dim`` is cut into."""
        sizes = mesh_axis_sizes(self.mesh)
        return int(np.prod([sizes[a] for a in self.parts(dim)]))

    def block_index(self, i: int, dim: int) -> int:
        """Which block of dim ``dim`` flat device ``i`` holds."""
        coords = self.mesh.coords(i)
        sizes = mesh_axis_sizes(self.mesh)
        idx = 0
        for a in self.parts(dim):
            idx = idx * sizes[a] + coords[a]
        return idx

    def fits(self, shape) -> bool:
        """Whether every sharded dim of ``shape`` divides evenly."""
        return len(self.spec) <= len(shape) and all(
            shape[d] % self.blocks(d) == 0 for d in range(len(self.spec)))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for_axes(axes: tuple, shape: tuple, mesh,
                  rules: dict | None = None) -> tuple:
    """The spec of one tensor, honoring both safeguards."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = mesh_axis_sizes(mesh)
    used: set[str] = set()
    parts = []
    for dim, name in enumerate(axes):
        cand = rules.get(name, ()) if name else ()
        if name == "batch":
            # batch may combine (pod, data) when both divide
            combo = [a for a in cand if a in sizes and a not in used]
            total = int(np.prod([sizes[a] for a in combo])) if combo else 1
            if combo and shape[dim] % total == 0:
                parts.append(tuple(combo) if len(combo) > 1 else combo[0])
                used.update(combo)
                continue
            combo = [a for a in combo if a == "data"]
            if combo and shape[dim] % sizes[combo[0]] == 0:
                parts.append(combo[0])
                used.add(combo[0])
                continue
            parts.append(None)
            continue
        placed = False
        for a in cand:
            if a in sizes and a not in used and shape[dim] % sizes[a] == 0:
                parts.append(a)
                used.add(a)
                placed = True
                break
        if not placed:
            parts.append(None)
    return tuple(parts)


def tree_shardings(axes_tree, shape_tree, mesh, rules: dict | None = None):
    """Placement tree for (axes tree, tree of tensors or anything with a
    ``shape``, e.g. meta tensors)."""
    def walk(ax, sh):
        if isinstance(ax, tuple):
            return Placement(mesh, spec_for_axes(ax, tuple(sh.shape), mesh,
                                                 rules))
        return {k: walk(ax[k], sh[k]) for k in ax}
    return walk(axes_tree, shape_tree)


# ------------------------------------------------------- blocks

def shard_tensor(t: torch.Tensor, placement: Placement) -> list:
    """Each flat device's block of ``t`` under ``placement``, on that
    device, in flat mesh order (a view of ``t`` where the device is
    ``t``'s; autograd flows back through every block)."""
    devices = placement.mesh.flat_devices
    if not placement.fits(tuple(t.shape)):
        raise ValueError(f"shape {tuple(t.shape)} does not fit the spec "
                         f"{placement.spec} on {placement.mesh}")
    out = []
    for i, ld in enumerate(devices):
        block = t
        for dim in range(len(placement.spec)):
            n = placement.blocks(dim)
            if n > 1:
                size = t.shape[dim] // n
                block = block.narrow(dim, placement.block_index(i, dim) * size,
                                     size)
        out.append(block.to(ld.device))
    return out


def unshard(blocks: list, placement: Placement, device=None):
    """The whole tensor from its blocks (flat mesh order), on ``device``
    (the first block's when not given): the inverse of
    :func:`shard_tensor`.  Where a dim is whole on several devices, the
    block of the device at index 0 along the unused axes is read."""
    mesh = placement.mesh
    device = blocks[0].device if device is None else torch.device(device)
    ndim = blocks[0].dim()
    used = {a for d in range(len(placement.spec))
            for a in placement.parts(d)}
    grid = {}
    for i, b in enumerate(blocks):
        coords = mesh.coords(i)
        if any(coords[a] for a in mesh.axis_names if a not in used):
            continue
        key = tuple(placement.block_index(i, d) if d < len(placement.spec)
                    else 0 for d in range(ndim))
        grid[key] = b.to(device)

    def join(prefix: tuple, dim: int):
        if dim == ndim:
            return grid[prefix]
        n = placement.blocks(dim) if dim < len(placement.spec) else 1
        parts = [join(prefix + (j,), dim + 1) for j in range(n)]
        return parts[0] if n == 1 else torch.cat(parts, dim)
    return join((), 0)


def _constrain(x, spec: tuple, mesh, what: str):
    """``x`` unchanged, once its rank holds ``spec`` and every axis the
    spec names is the mesh's.  A dim that does not divide evenly is
    allowed, as ``jax.lax.with_sharding_constraint`` allows it (GSPMD
    pads); :func:`shard_tensor` refuses one."""
    sizes = mesh_axis_sizes(mesh)
    names = [a for part in spec if part is not None
             for a in (part if isinstance(part, tuple) else (part,))]
    if len(spec) > x.dim() or any(a not in sizes for a in names):
        raise ValueError(f"{what}: spec {spec} does not fit shape "
                         f"{tuple(x.shape)} on {mesh}")
    return x


# ------------------------------------------------------- activation specs

def batch_axes(mesh, global_batch: int):
    sizes = mesh_axis_sizes(mesh)
    cand = [a for a in ("pod", "data") if a in sizes]
    total = int(np.prod([sizes[a] for a in cand]))
    if cand and global_batch % total == 0:
        return tuple(cand) if len(cand) > 1 else cand[0]
    if "data" in sizes and global_batch % sizes["data"] == 0:
        return "data"
    return None


def activation_spec(mesh, global_batch: int, seq_len: int,
                    seq_shard: bool = True) -> tuple:
    """Residual-stream spec: (batch, seq, d_model)."""
    b_ax = batch_axes(mesh, global_batch)
    sizes = mesh_axis_sizes(mesh)
    s_ax = ("model" if seq_shard and "model" in sizes
            and seq_len % sizes["model"] == 0 else None)
    return (b_ax, s_ax, None)


def make_activation_sharder(mesh, global_batch: int, seq_len: int,
                            seq_shard: bool = True):
    """A constraint on the residual stream, :func:`activation_spec` for a
    rank-3 tensor; every tensor is returned unchanged."""
    spec = activation_spec(mesh, global_batch, seq_len, seq_shard)

    def sharder(x):
        if x.dim() == 3:
            _constrain(x, spec, mesh, "activation")
        return x
    return sharder


def moe_dispatch_plan(cfg, mesh, global_batch: int, seq_len: int = 0,
                      seq_shard: bool = True):
    """(groups, group_sharder, ep_sharder) for the grouped MoE dispatch.

    groups = the device count over the token layout (batch shards ×
    sequence shards), so each device owns whole dispatch groups and
    per-group capacity is per-device capacity (GShard semantics).
    ``group_sharder`` holds every (G, ...) dispatch tensor to that layout;
    ``ep_sharder`` holds the (E, G·C, d) expert batch to EP over ``model``
    when E divides it, else to the capacity dim.
    """
    if not getattr(cfg, "is_moe", False):
        return 1, None, None
    sizes = mesh_axis_sizes(mesh)
    b_ax = batch_axes(mesh, global_batch)
    axes = [b_ax] if isinstance(b_ax, str) else list(b_ax or ())
    tp = sizes.get("model", 1)
    if (seq_shard and "model" in sizes and seq_len
            and seq_len % sizes["model"] == 0):
        axes.append("model")
    groups = int(np.prod([sizes[a] for a in axes])) if axes else 1
    g_spec = tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)

    def group_sharder(a):
        return _constrain(a, (g_spec,) + (None,) * (a.dim() - 1), mesh,
                          "moe group")

    def ep_sharder(xe):
        e = xe.shape[0]
        if e % tp == 0:
            spec = ("model", None, None)
        elif xe.shape[1] % tp == 0:
            spec = (None, "model", None)
        else:
            spec = (None, None, None)
        return _constrain(xe, spec, mesh, "moe expert batch")

    return max(groups, 1), group_sharder, ep_sharder


# ------------------------------------------------------- cache specs

def cache_leaf_spec(path_names: tuple, shape: tuple, mesh,
                    global_batch: int) -> tuple:
    """Spec of a decode-cache leaf, keyed by leaf name + rank."""
    name = path_names[-1]
    b_ax = batch_axes(mesh, global_batch)
    sizes = mesh_axis_sizes(mesh)

    def fit(ax, dim):
        return ax if ax in sizes and shape[dim] % sizes[ax] == 0 else None
    if name in ("k", "v", "cross_k", "cross_v"):     # (B, S, Hkv, hd)
        return (b_ax, fit("model", 1), None, None)
    if name in ("k_scale", "v_scale"):               # (B, S, Hkv)
        return (b_ax, fit("model", 1), None)
    if name == "c" and len(shape) == 4:              # mLSTM (B, H, K, K)
        return (b_ax, None, fit("model", 2), None)
    if name in ("c", "n", "h", "m") and len(shape) == 3:
        return (b_ax, None, fit("model", 2))
    if name == "m" and len(shape) == 2:
        return (b_ax, None)
    if name == "conv":                               # (B, cw-1, W)
        return (b_ax, None, fit("model", 2))
    if name == "h" and len(shape) == 2:              # (B, W)
        return (b_ax, fit("model", 1))
    if len(shape) == 0:
        return ()
    return (b_ax,) + (None,) * (len(shape) - 1)


def cache_shardings(cache_tree, mesh, global_batch: int):
    """Placement tree of a decode cache (dicts and lists; a leaf is a
    tensor, or a Python number such as ``pos``, of shape ())."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return Placement(mesh, cache_leaf_spec(
            path, tuple(np.shape(node) if not torch.is_tensor(node)
                        else node.shape), mesh, global_batch))
    return walk(cache_tree, ())
