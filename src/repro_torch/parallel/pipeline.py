"""GPipe-style pipeline parallelism over a stage axis (``pod``).

The port of ``repro.parallel.pipeline`` over logical devices: every
device along ``axis`` holds one *stage* (an equal slice of the layer
stack, the leading axis of the stage parameters).  The GPipe schedule
runs M + S - 1 ticks; at tick t stage s processes microbatch t - s, and
activations hop to the next stage by ``ppermute``, whose transpose is the
reverse permute, so autograd through a pipelined apply gives the GPipe
backward schedule.

What differs from the reference: a stage that has no microbatch at a
tick computes nothing (the reference computes and discards), and the
result is the last stage's outputs (the reference adds the other
stages' zeros to them).  Devices that differ along other mesh axes hold
the same replicated values in the reference; here the pipeline runs on
the group of devices at index 0 along every other axis.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import collectives as coll


def pipeline_apply(stage_fn, mesh, axis: str = "pod"):
    """Build a pipelined apply: (stage_params, microbatches) -> outputs.

    ``stage_params``: a dict tree whose leaves have a leading axis of
    num_stages; stage ``s`` reads ``leaf[s]``, moved to its device.
    ``microbatches``: an (M, ...) tensor (or a list of M tensors), fed to
    stage 0; the result stacks the last stage's M outputs on the device
    of the first microbatch.  ``stage_fn(params_for_stage, x) -> y`` with
    y.shape == x.shape.
    """
    n_stages = mesh.axis_size(axis)

    def apply(stage_params, mbs):
        stage_mesh = Mesh((n_stages,), (axis,), [
            mesh.flat_devices[i] for i in mesh.groups(axis)[0]])
        devices = stage_mesh.flat_devices
        local = [_tree_map(lambda a, s=s: a[s].to(devices[s].device),
                           stage_params) for s in range(n_stages)]
        m = len(mbs)
        out_device = mbs[0].device
        # what each stage received from the one before it
        buf = [torch.zeros_like(mbs[0], device=ld.device) for ld in devices]
        outs = []
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        for t in range(m + n_stages - 1):
            ys = []
            for s, ld in enumerate(devices):
                with coll.on_device(ld):
                    if 0 <= t - s < m:
                        x_in = (mbs[t].to(ld.device) if s == 0
                                else buf[s])
                        ys.append(stage_fn(local[s], x_in))
                    else:             # idle: pass on what it holds
                        ys.append(buf[s])
            if t >= n_stages - 1:
                outs.append(ys[-1].to(out_device))
            buf = coll.ppermute(ys, stage_mesh, axis, perm)
        return torch.stack(outs)

    return apply


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_stages(params_list: list, n_stages: int):
    """Stack per-layer param trees (dicts of tensors) into
    (n_stages, layers/stage, ...) leaves."""
    per = len(params_list) // n_stages
    if per * n_stages != len(params_list):
        raise ValueError(f"{len(params_list)} layers do not split into "
                         f"{n_stages} equal stages")

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        a = torch.stack(xs)
        return a.reshape(n_stages, per, *a.shape[1:])
    return stack(*params_list)
