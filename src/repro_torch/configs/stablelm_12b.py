"""StableLM-2 12B — dense GQA decoder [hf:stabilityai/stablelm-2-12b]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100_352,
    ffn_activation="swiglu", norm="layernorm",
    source="hf:stabilityai/stablelm-2-12b",
))
