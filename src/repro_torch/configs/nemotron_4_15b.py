"""Nemotron-4 15B — dense GQA decoder, squared-ReLU FFN [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256_000,
    ffn_activation="sq_relu", rope_variant="rope",
    source="arXiv:2402.16819",
))
