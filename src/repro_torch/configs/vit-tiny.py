"""ViT-Tiny — the paper's own encoder backbone (Dosovitskiy et al., 2021).

32x32x3 inputs, patch size 4, 12 blocks, d=192, 3 heads, MLP 768, GELU;
MoCo v3 heads attach on top (repro_torch.core.heads). This is the FL/SSL
experiment backbone, not part of the 40-pair dry-run table.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="vit-tiny", family="dense",
    num_layers=12, d_model=192, num_heads=3, num_kv_heads=3,
    d_ff=768, vocab_size=0, causal=False, act="gelu",
    source="arXiv:2010.11929 (ViT); paper Section 5.1",
)
