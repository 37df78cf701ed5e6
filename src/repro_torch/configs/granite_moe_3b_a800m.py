"""Granite 3.0 3B-A800M MoE — 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base].

The assignment line reads "MoE 40e top-8" in the shape field and "32
experts" in the comment; we follow the shape field (40 experts) and note
the discrepancy in DESIGN.md. d_ff=512 is per-expert.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49_155,
    num_experts=40, top_k=8,
    ffn_activation="swiglu", tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
))
