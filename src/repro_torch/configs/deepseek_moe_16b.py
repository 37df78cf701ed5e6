"""DeepSeekMoE 16B — 2 shared + 64 routed top-6, fine-grained experts,
first layer dense [arXiv:2401.06066]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102_400,
    num_experts=64, top_k=6, num_shared_experts=2,
    first_layer_dense=True, dense_d_ff=10944,
    ffn_activation="swiglu",
    source="arXiv:2401.06066",
))
