"""xLSTM 1.3B — sLSTM + mLSTM blocks at 1:7 [arXiv:2405.04517].

d_ff = 0: xLSTM blocks carry their own up/down projections (mLSTM
projection factor 2, sLSTM gated factor 4/3). Sub-quadratic -> runs the
long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50_304, rope_variant="none",
    block_pattern=("slstm",) + ("mlstm",) * 7,
    sub_quadratic=True,
    source="arXiv:2405.04517",
))
