"""RecurrentGemma 2B — RG-LRU recurrent blocks + local attention at 2:1
[arXiv:2402.19427].

26 layers cycle (rglru, rglru, local_attn); MQA (kv=1), window 2048,
GeGLU FFN. Sub-quadratic -> runs the long_500k cell.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local_attn"), window=2048,
    lru_width=2560, ffn_activation="geglu", rope_variant="rope",
    sub_quadratic=True,
    source="arXiv:2402.19427",
))
