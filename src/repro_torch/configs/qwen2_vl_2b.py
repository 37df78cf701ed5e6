"""Qwen2-VL 2B — text backbone with M-RoPE; vision frontend stub
[arXiv:2409.12191].

input_specs() supplies precomputed patch embeddings merged into the token
stream via a vision mask, plus 3-section (t/h/w) M-RoPE position ids.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151_936, qkv_bias=True,
    rope_variant="mrope", ffn_activation="swiglu", modality="vlm",
    tie_embeddings=True,
    source="arXiv:2409.12191",
))
