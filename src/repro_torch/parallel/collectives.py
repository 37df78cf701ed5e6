"""Collectives over one named axis of a mesh of logical devices.

The port's stand-in for ``shard_map``'s collectives: a sharded value is
the list of its per-device blocks in flat mesh order, and each
collective takes and returns such a list.  ``all_gather``, ``all_to_all``
(tiled), ``psum``, ``pmean``, ``pmax`` and ``ppermute`` combine the
blocks of the devices that differ only along ``axis`` (a mesh axis name
or a tuple of names), as ``jax.lax``'s do inside ``shard_map``.

They are built from ``torch.cat``, ``split``, ``stack`` and ``sum``, so
autograd flows through them: the transpose of ``all_gather`` comes out as
a reduce-scatter (each block's gradient is the sum of its slice of every
gathered copy's), and ``ppermute``'s as the reverse permute.

Each result block lives on its logical device's physical device and is
computed on that device's stream (:func:`on_device`).  Several logical
devices may share one card: the collectives then move no bytes between
cards, and their launches from different streams may run at once.  A
result that is the same for every device of a group (``all_gather``,
``psum``, ``pmean``, ``pmax``) is computed once per physical device and
shared by the group's devices on it; nothing writes a block in place.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def on_device(ld):
    """Run the body on logical device ``ld``'s stream: the stream first
    waits for the work queued on the current stream (so it reads what
    came before, whichever stream made it), and the current stream waits
    for the body's work at the end (so what comes after reads it).  On
    the CPU, or for a device without a stream, nothing is done."""
    stream = getattr(ld, "stream", None)
    if stream is None:
        yield
        return
    outer = torch.cuda.current_stream(ld.device)
    stream.wait_stream(outer)
    with torch.cuda.stream(stream):
        yield
    outer.wait_stream(stream)


def map_shards(fn, mesh, *blocks):
    """``[fn(i, blocks[0][i], blocks[1][i], ...)]`` over the flat devices
    of ``mesh``, each call on its device's stream: the per-device body of
    a ``shard_map``.  A call that returns a tuple gives a tuple of
    lists."""
    out = []
    for i, ld in enumerate(mesh.flat_devices):
        with on_device(ld):
            out.append(fn(i, *(b[i] for b in blocks)))
    if out and isinstance(out[0], tuple):
        return tuple(list(col) for col in zip(*out))
    return out


def _check(blocks, mesh):
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size} "
                         f"devices")


def _per_group(blocks, mesh, axis, combine, same: bool = False):
    """``out[i] = combine(position of i in its group, the group's blocks,
    device i)`` for every flat device, on its stream.  ``same`` says the
    result does not depend on the position: devices of a group that
    share one physical device then share one result, computed once."""
    _check(blocks, mesh)
    devices = mesh.flat_devices
    out = [None] * len(blocks)
    for group in mesh.groups(axis):
        members = [blocks[j] for j in group]
        done = {}
        for pos, i in enumerate(group):
            dev = devices[i].device
            if same and dev in done:
                out[i] = done[dev]
                continue
            with on_device(devices[i]):
                out[i] = done[dev] = combine(pos, members, dev)
    return out


def all_gather(blocks, mesh, axis, dim: int = 0):
    """Tiled all-gather: each device gets its group's blocks concatenated
    along ``dim`` in group order."""
    if mesh.axis_size(axis) == 1:
        return list(blocks)
    return _per_group(blocks, mesh, axis, lambda pos, members, dev:
                      torch.cat([b.to(dev) for b in members], dim),
                      same=True)


def all_to_all(blocks, mesh, axis, split_axis: int, concat_axis: int):
    """Tiled all-to-all: each block splits into n pieces along
    ``split_axis``; device ``pos`` of a group gets piece ``pos`` of every
    member's block, concatenated along ``concat_axis`` in group order."""
    n = mesh.axis_size(axis)
    if n == 1:
        return list(blocks)
    for b in blocks:
        if b.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(b.shape)} does not split {n} ways")
    return _per_group(blocks, mesh, axis, lambda pos, members, dev:
                      torch.cat([b.chunk(n, split_axis)[pos].to(dev)
                                 for b in members], concat_axis))


def psum(blocks, mesh, axis):
    """Each device gets the sum of its group's blocks, added in group
    order."""
    def add(pos, members, dev):
        total = members[0].to(dev)
        for b in members[1:]:
            total = total + b.to(dev)
        return total
    return _per_group(blocks, mesh, axis, add, same=True)


def pmean(blocks, mesh, axis):
    """``psum`` over the group's size, as a multiply by its float32
    reciprocal (as XLA compiles the division by a constant)."""
    n = mesh.axis_size(axis)
    return [s * (1.0 / n) for s in psum(blocks, mesh, axis)]


def pmax(blocks, mesh, axis):
    """Each device gets the elementwise max of its group's blocks."""
    return _per_group(blocks, mesh, axis, lambda pos, members, dev:
                      torch.stack([b.to(dev) for b in members]).amax(0),
                      same=True)


def ppermute(blocks, mesh, axis, perm):
    """``perm`` holds (source, destination) positions along ``axis``:
    each destination gets its source's block; a device that no pair
    names as a destination gets zeros, as ``jax.lax.ppermute`` gives."""
    src_of = {}
    for src, dst in perm:
        if dst in src_of:
            raise ValueError(f"ppermute: position {dst} receives twice")
        src_of[dst] = src
    return _per_group(blocks, mesh, axis, lambda pos, members, dev: (
        members[src_of[pos]].to(dev) if pos in src_of
        else torch.zeros_like(members[pos], device=dev)))

