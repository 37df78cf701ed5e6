"""SeamlessM4T medium — encoder-decoder, audio frontend stub
[arXiv:2308.11596].

The speech frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings of shape (batch, src_len, d_model); the
transformer backbone (12 enc + 12 dec, cross-attention) is real.
Positional encoding adapted to RoPE (orig uses learned/relative; noted in
DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256_206,
    ffn_activation="gelu", norm="layernorm", modality="audio",
    source="arXiv:2308.11596",
))
