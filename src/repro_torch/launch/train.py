"""Training launcher: the train step, the deterministic data pipeline,
async checkpoints and the fault coordinator, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 50 --batch 8 --seq 64          # reduced, card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --seq 4096 --batch 8 --grad-accum 4 --remat      # full config
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --device cpu                           # plain torch, host

The port of ``repro.launch.train``, with the same flags and
``--device``: without it the step runs on the CUDA device and refuses to
start without one.  The mesh is (n, 1) over (data, model), n logical
devices from ``default_devices`` (one per card; one on the CPU), or with
``--multi-pod`` (or n ≥ 256) the production mesh, which is printed and
refused below its 512 devices, as the reference cannot build it
either.  ``--reduced`` is ``store_true``, so the full config is the
default, as in the reference.  Each step prints a line with its time on
the host's clock after the card is synchronised, its tokens/s and the
card's peak memory so far; the last line gives the loss's first and
last values.  Checkpoints go to ``--ckpt-dir`` (a new temporary
directory when not given).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-sized) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 production mesh (needs 512 "
                    "devices)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs plain torch on the host "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.distributed import default_devices
    from repro_torch.core.engine import resolve_device
    from repro_torch.data import DataConfig, TokenPipeline, device_batch
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.models.model import count_params, make_params
    from repro_torch.train import (
        CheckpointManager, Coordinator, OptConfig, StragglerDetector,
        build_train_step, init_state)

    device = resolve_device(args.device)
    devices = default_devices(None, args.device)
    n = len(devices)
    if args.multi_pod or n >= 256:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        print(f"mesh {dict(zip(mesh.axis_names, mesh.shape))} "
              f"({mesh.size} devices)", flush=True)
        if n < mesh.size:
            raise SystemExit(f"the production mesh needs {mesh.size} "
                             f"devices; {n} present")
    else:
        mesh = Mesh((n, 1), ("data", "model"), devices)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=min(100, args.steps // 10 + 1))
    step_fn, _, _ = build_train_step(
        cfg, mesh, shape, opt_cfg, q_chunk=min(512, args.seq),
        remat=args.remat, grad_accum=args.grad_accum)

    params = make_params(cfg, seed=0, device=device, trainable=True)
    opt = init_state(params)
    print(f"{args.arch}: {count_params(cfg)/1e6:.1f}M params on {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + f", mesh {dict(zip(mesh.axis_names, mesh.shape))}")

    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=args.batch, seq_len=args.seq))
    mgr = CheckpointManager(args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_ckpt_"), keep=3)
    state = {"params": params, "opt": opt, "step": np.int64(0)}
    if args.resume and mgr.latest_step() is not None:
        state, s0 = mgr.restore(state)
        print(f"resumed from step {s0}")
    tokens = args.batch * args.seq

    def wrapped(st, batch):
        t0 = time.perf_counter()
        p, o, m = step_fn(st["params"], st["opt"], batch)
        loss = float(m["loss"])               # waits for the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
                f"GiB" if device.type == "cuda" else "not measured (cpu)")
        print(f"step {int(st['step'])}: loss {loss:.4f} grad_norm "
              f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3e}; "
              f"{ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s; peak "
              f"memory {peak}", flush=True)
        return {"params": p, "opt": o, "step": st["step"] + 1}, m

    def batch_fn(s):
        return device_batch(pipe.batch_at(s), device)

    coord = Coordinator(wrapped, batch_fn, mgr,
                        ckpt_every=args.ckpt_every,
                        straggler=StragglerDetector())
    t0 = time.time()
    state, last, hist = coord.run(state, int(state["step"]), args.steps)
    dt = time.time() - t0
    losses = [h["loss"] for h in hist if "loss" in h]
    print(f"{last} steps in {dt:.1f}s; loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-5:]):.3f}; "
          f"{args.steps * tokens / dt:.0f} tok/s")
    mgr.save(last, state)


if __name__ == "__main__":
    main()
