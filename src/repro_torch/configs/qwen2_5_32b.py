"""Qwen2.5 32B — dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5-32B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152_064, qkv_bias=True,
    ffn_activation="swiglu",
    source="hf:Qwen/Qwen2.5-32B",
))
