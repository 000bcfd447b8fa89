"""InternVL2-1B — InternViT + InternLM2-backbone VLM [arXiv:2404.16821].

The language decoder (Qwen2-0.5B-scale InternLM2 family config). The vision
frontend (InternViT + MLP projector) is a STUB per the assignment carve-out:
input_specs() supplies 256 precomputed patch embeddings per sample
(frontend_embed_len) concatenated ahead of the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    frontend_embed_len=256,
    source="arXiv:2404.16821",
    notes="vision encoder stubbed to patch embeddings; "
          "long_500k uses window=8192",
)
