"""Checkpoints of a training state, on the reference's on-disk layout.

The port of ``repro.train.checkpoint``'s ``CheckpointManager``: one
``.npy`` per leaf keyed by its tree path, plus a JSON manifest, under
``step_{:010d}/``; writes are atomic (tmp dir + rename), optionally on a
background thread, and a retention policy keeps the newest ``keep``.  A
tree of numpy leaves written by either package's manager restores with
the other's.

What differs, and why:

* a leaf may be a torch tensor, and a node an ``nn.Module`` (its
  ``state_dict`` entries, one key each under the module's path);
* :meth:`CheckpointManager.save_async` copies every leaf to the host
  *before it returns*: the port's optimizer updates leaves in place, so
  a copy still in flight would race the next step;
* :meth:`CheckpointManager.restore` copies a tensor leaf's saved value
  into the skeleton's tensor, in place, and returns that tensor (so the
  restored values replace the live state's, wherever it is referenced);
  a non-tensor skeleton leaf comes back as the saved numpy array;
* a bfloat16 leaf is stored as its ``uint16`` view with ``bfloat16`` in
  the manifest (numpy has no bfloat16 without ``ml_dtypes``); the
  reference's bfloat16 leaves (``|V2`` on disk) restore the same way;
* ``restore(shardings=)`` takes a tree of
  ``repro_torch.parallel.sharding.Placement``s, any mesh, and returns
  each placed leaf as its list of per-device blocks (``shard_tensor``),
  where the reference ``device_put``s it into one sharded array.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.parallel.sharding import shard_tensor


def _flatten(tree, prefix=()):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict(keep_vars=True)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _unflatten_into(skeleton, flat: dict, bf16: set, path=(),
                    placements=None):
    if isinstance(skeleton, nn.Module):
        out = {name: _unflatten_into(t, flat, bf16, path + (name,),
                                     placements)
               for name, t in skeleton.state_dict(keep_vars=True).items()}
        # restored in place, unless a placement cut a leaf into blocks
        placed = any(isinstance(v, list) for v in out.values())
        return out if placed else skeleton
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, bf16, path + (str(k),),
                                   placements)
                for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(
            _unflatten_into(v, flat, bf16, path + (str(i),), placements)
            for i, v in enumerate(skeleton))
    key = "/".join(path)
    arr = flat[key]
    if torch.is_tensor(skeleton) and tuple(arr.shape) != tuple(
            skeleton.shape):
        raise ValueError(f"{key}: saved shape {arr.shape}, skeleton shape "
                         f"{tuple(skeleton.shape)}")
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
         if key in bf16 else torch.from_numpy(arr))
    if placements is not None and key in placements:
        return shard_tensor(t, placements[key])
    if not torch.is_tensor(skeleton):
        return arr
    with torch.no_grad():
        skeleton.copy_(t)
    return skeleton


def _host_leaf(leaf) -> np.ndarray:
    """A host copy of one leaf, owned by the caller (bfloat16 as its
    ``uint16`` view)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()

    # ---------------------------------------------------------- save

    def save(self, step: int, state) -> Path:
        """Blocking save of a state tree."""
        return self._write(step, self._gather(state))

    def save_async(self, step: int, state) -> Future:
        """Copy every leaf to the host now, write on a background
        thread."""
        return self._pool.submit(self._write, step, self._gather(state))

    @staticmethod
    def _gather(state) -> list:
        """``[(key, host array, manifest dtype)]`` of ``state``."""
        out = []
        for path, leaf in _flatten(state):
            arr = _host_leaf(leaf)
            bf16 = torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16
            out.append(("/".join(path), arr,
                        "bfloat16" if bf16 else str(arr.dtype)))
        return out

    def _write(self, step: int, host_state: list) -> Path:
        with self._lock:
            final = self.dir / f"step_{step:010d}"
            tmp = self.dir / f".tmp_step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "time": time.time(), "leaves": {}}
            for key, arr, dtype in host_state:
                fname = key.replace("/", "__") + ".npy"
                np.save(tmp / fname, arr, allow_pickle=False)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": dtype}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()
            return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, skeleton, step: int | None = None, shardings=None):
        """Restore into the structure of ``skeleton`` -> (state, step):
        tensor leaves (a module's included) are overwritten in place and
        returned, other leaves come back as numpy arrays (a bfloat16 one
        as its ``uint16`` view).  ``shardings``, a tree of ``Placement``s
        shaped as ``skeleton`` (a module as a dict of its ``state_dict``
        names), places each leaf it names: that leaf comes back as its
        blocks (``shard_tensor``), each on its logical device's device,
        whatever the skeleton's leaf is (a ``meta`` tensor of the
        abstract state, say); a module with a placed leaf comes back as
        that dict."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat, bf16 = {}, set()
        for key, info in manifest["leaves"].items():
            flat[key] = np.load(d / info["file"], allow_pickle=False)
            if info["dtype"] == "bfloat16":
                flat[key] = flat[key].view(np.uint16)
                bf16.add(key)
        placements = None if shardings is None else {
            "/".join(path): p for path, p in _flatten(shardings)}
        return _unflatten_into(skeleton, flat, bf16,
                               placements=placements), step

    def wait(self):
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(max_workers=1)

