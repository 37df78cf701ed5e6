"""Device meshes: named axes over logical devices.

The port of ``repro.launch.mesh``.  A :class:`Mesh` is a grid of named
axes; a concrete one holds a :class:`~repro_torch.core.engine.LogicalDevice`
at each coordinate (several may share one card, each with a stream of its
own), an abstract one holds none and only carries the shape the sharding
rules read.  ``mesh.devices.shape`` gives the axis sizes, as the
reference's rules read them from a JAX mesh, so those rules and the
port's (``repro_torch.parallel.sharding``) take either.

Single pod: (16, 16) = 256 devices, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 devices, axes (pod, data, model).
"""

from __future__ import annotations

import numpy as np


class Mesh:
    """``shape`` named by ``axis_names``; ``devices`` is an object array
    of that shape holding one logical device per coordinate (row-major:
    flat device ``i`` is ``devices.flat[i]``), or ``None`` everywhere for
    an abstract mesh."""

    def __init__(self, shape, axis_names, devices=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not name its "
                             f"axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes repeat: {self.axis_names}")
        grid = np.empty(self.shape, dtype=object)
        if devices is not None:
            devices = list(devices)
            if len(devices) != grid.size:
                raise ValueError(f"a {self.shape} mesh needs {grid.size} "
                                 f"devices, got {len(devices)}")
            for i, d in enumerate(devices):
                grid.flat[i] = d
        self.devices = grid

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def concrete(self) -> bool:
        return self.size > 0 and self.devices.flat[0] is not None

    @property
    def flat_devices(self) -> list:
        """The logical devices in flat (row-major) order; raises on an
        abstract mesh."""
        if not self.concrete:
            raise ValueError(f"the {self.shape} mesh is abstract: it holds "
                             f"no devices")
        return list(self.devices.flat)

    def axis_size(self, axis) -> int:
        """The size of one axis, or the product over a tuple of axes."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in names]))

    def groups(self, axis) -> list[list[int]]:
        """The flat device indices that differ only along ``axis`` (a name
        or a tuple of names), one list per group, each ordered by the
        index along those axes (row-major in the order given)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        dims = [self.axis_names.index(a) for a in names]
        flat = np.arange(self.size).reshape(self.shape)
        flat = np.moveaxis(flat, dims, list(range(-len(dims), 0)))
        return flat.reshape(-1, self.axis_size(names)).tolist()

    def coords(self, i: int) -> dict:
        """Flat device ``i``'s index along each axis."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(i, self.shape))))

    def __repr__(self) -> str:
        kind = "" if self.concrete else ", abstract"
        return f"Mesh({dict(zip(self.axis_names, self.shape))}{kind})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh: (16, 16) over (data, model), or with
    ``multi_pod`` (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(shape=None, axes=None, *, device=None,
                   devices=None) -> Mesh:
    """A concrete mesh of ``shape`` over ``devices`` (default:
    ``default_devices(prod(shape), device)``, logical devices each with a
    stream of its own on the card unless ``device`` names another).
    Without a shape, one ``data`` axis over the devices given, or over
    one logical device per card."""
    from repro_torch.core.distributed import default_devices
    if shape is None:
        if devices is None:
            devices = default_devices(None, device)
        shape, axes = (len(devices),), ("data",)
    if axes is None:
        raise ValueError("a mesh shape needs its axis names")
    if devices is None:
        devices = default_devices(int(np.prod(shape)), device)
    return Mesh(shape, axes, devices)
