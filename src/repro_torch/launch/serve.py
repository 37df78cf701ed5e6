"""Serving launcher: batched generation via ServeEngine, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 4 --new-tokens 16                  # reduced config, card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --no-reduced --prompt-len 512 --new-tokens 64   # full config
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --device cpu                               # plain torch on the host
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma-2b --no-reduced --prompt-len 2048 \\
        --batch 4 --new-tokens 64       # recurrent: RG-LRU + local attention

The port of ``repro.launch.serve``.  Its ``--reduced`` is on by default
as the reference's is, but ``--no-reduced`` turns it off (the reference's
flag is ``store_true`` with a default of True, so it can never serve a
full config).  Without ``--device`` the engine runs on the CUDA device and
refuses to start without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=3,
                    help="number of batched request rounds")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs plain torch on the host "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.model import make_params
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = make_params(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params,
                      max_seq_len=args.prompt_len + args.new_tokens + 8,
                      q_chunk=16, device=args.device)
    rng = np.random.default_rng(0)
    total, t0 = 0, time.time()
    for r in range(args.requests):
        prompts = rng.integers(
            0, cfg.vocab_size,
            (args.batch, args.prompt_len)).astype(np.int32)
        src = (rng.normal(size=(args.batch, args.prompt_len, cfg.d_model))
               .astype(np.float32) if cfg.is_encdec else None)
        out = eng.generate(prompts, max_new_tokens=args.new_tokens,
                           temperature=args.temperature, seed=r,
                           src_embeds=src)
        total += out[:, args.prompt_len:].size
        print(f"request {r}: generated {out.shape} "
              f"(first row tail: {out[0, -8:].tolist()}); prefill "
              f"{eng.timing['prefill_ms']:.3f} ms, decode "
              f"{eng.timing['decode_ms'] / args.new_tokens:.3f} ms/step")
    dt = time.time() - t0
    print(f"{total} tokens in {dt:.1f}s = {total / dt:.1f} tok/s "
          f"on {eng.device}")


if __name__ == "__main__":
    main()
