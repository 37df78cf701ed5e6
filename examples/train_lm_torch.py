"""End-to-end training demo on the PyTorch/CUDA port: a small GQA LM
trained for a few hundred steps with the full stack -- train step,
AdamW, deterministic data pipeline, async checkpointing and the fault
coordinator, with an injected failure to demonstrate recovery.

    PYTHONPATH=src python examples/train_lm_torch.py               # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu  # host

The port of ``examples/train_lm.py``: the same reduced-and-narrowed
config of the selected family (4 layers, d_model 256, d_ff 1024, a
2,048-token vocabulary), the same schedule and data, a failure injected
at ``steps // 2``.  It runs on the CUDA device unless given
``--device cpu``.
"""

import argparse
import dataclasses
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.engine import resolve_device
from repro_torch.data import DataConfig, TokenPipeline, device_batch
from repro_torch.models.model import count_params, make_params
from repro_torch.train import (
    CheckpointManager, Coordinator, OptConfig, StragglerDetector,
    build_train_step, init_state)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--inject-failure", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs plain torch on the host "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # a genuinely trainable small config of the selected family
    cfg = dataclasses.replace(
        get_config(args.arch).reduced(),
        num_layers=4, d_model=256, d_ff=1024, vocab_size=2048)
    shape = ShapeSpec("demo", "train", args.seq, args.batch)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                        weight_decay=0.01)
    step_fn, _, _ = build_train_step(cfg, None, shape, opt_cfg,
                                     q_chunk=args.seq, remat=False)

    params = make_params(cfg, seed=0, device=device, trainable=True)
    opt = init_state(params)
    print(f"arch family {args.arch}: {count_params(cfg)/1e6:.1f}M params, "
          f"on {device}, batch {args.batch}x{args.seq}")

    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=args.batch, seq_len=args.seq,
                                    zipf_a=1.2, seed=0))
    ckdir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    mgr = CheckpointManager(ckdir, keep=2)

    state = {"params": params, "opt": opt, "step": np.int64(0)}
    injected = {"done": not args.inject_failure}

    def wrapped_step(st, batch):
        if not injected["done"] and int(st["step"]) == args.steps // 2:
            injected["done"] = True
            raise RuntimeError("injected node failure (demo)")
        p, o, metrics = step_fn(st["params"], st["opt"], batch)
        return ({"params": p, "opt": o, "step": st["step"] + 1}, metrics)

    def batch_fn(s):
        return device_batch(pipe.batch_at(s), device)

    coord = Coordinator(wrapped_step, batch_fn, mgr, ckpt_every=50,
                        straggler=StragglerDetector())
    t0 = time.time()
    state, last, hist = coord.run(state, 0, args.steps)
    dt = time.time() - t0

    losses = [h.get("loss", float("nan")) for h in hist]
    first = np.nanmean(losses[:10])
    final = np.nanmean(losses[-10:])
    toks = args.steps * args.batch * args.seq
    print(f"\ntrained {last} steps in {dt:.1f}s ({toks / dt:.0f} tok/s)")
    print(f"loss: first-10 avg {first:.3f} -> last-10 avg {final:.3f}")
    print(f"recoveries: {len(coord.restarts)} "
          f"{[r['error'] for r in coord.restarts]}")
    print(f"checkpoints kept: {mgr.all_steps()} under {ckdir}")
    assert final < first, "loss should decrease"
    print("loss decreased ✓")
    return dict(first=first, final=final, recoveries=len(coord.restarts),
                steps=last, seconds=dt)


if __name__ == "__main__":
    main()
