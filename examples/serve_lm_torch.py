"""Serving demo on the PyTorch/CUDA port: batched prefill + decode
generation with KV-cache management (ring buffers for local-attention
layers) and, for the recurrent architectures (xlstm-1.3b,
recurrentgemma-2b), their mLSTM, sLSTM and RG-LRU states.

    PYTHONPATH=src python examples/serve_lm_torch.py                # card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu   # host
    PYTHONPATH=src python examples/serve_lm_torch.py --arch seamless-m4t-medium
    PYTHONPATH=src python examples/serve_lm_torch.py --arch xlstm-1.3b

The model is the architecture's reduced config with random weights; the
engine runs on the CUDA device unless given ``--device cpu``.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.model import count_params, make_params
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs plain torch on the host "
                         "(default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    params = make_params(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params, max_seq_len=128, q_chunk=16,
                      device=args.device)
    print(f"{args.arch} (reduced, {count_params(cfg)/1e6:.1f}M) on "
          f"{eng.device}: batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens}")

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    src = None
    if cfg.is_encdec:
        src = rng.normal(size=(args.batch, args.prompt_len,
                               cfg.d_model)).astype(np.float32)

    t0 = time.time()
    out = eng.generate(prompts, max_new_tokens=args.new_tokens,
                       temperature=0.8, seed=1, src_embeds=src)
    dt = time.time() - t0
    new = out[:, args.prompt_len:]
    print(f"generated {new.size} tokens in {dt:.1f}s: "
          f"{new.size / dt:.1f} tok/s")
    for i, row in enumerate(new[:2]):
        print(f"  seq{i}: {row.tolist()}")
    assert out.shape == (args.batch, args.prompt_len + args.new_tokens)
    assert (out[:, :args.prompt_len] == prompts).all()
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    print("shapes ✓")


if __name__ == "__main__":
    main()
