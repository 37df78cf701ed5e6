"""Qwen2 0.5B — dense GQA decoder with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151_936, qkv_bias=True,
    ffn_activation="swiglu", tie_embeddings=True,
    source="arXiv:2407.10671",
))
