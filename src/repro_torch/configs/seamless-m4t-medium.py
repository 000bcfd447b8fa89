"""SeamlessM4T-medium — encoder-decoder, multimodal [arXiv:2308.11596].

Transformer backbone only: 12-layer bidirectional encoder over precomputed
speech-frame embeddings (the conformer/mel frontend is a STUB per the
carve-out) + 12-layer causal decoder with cross-attention. Decode shapes
run the decoder against a fixed encoder memory; long_500k uses windowed
decoder self-attention (window=8192).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    dec_layers=12, cross_attention=True, frontend_embed_len=512,
    source="arXiv:2308.11596",
)
