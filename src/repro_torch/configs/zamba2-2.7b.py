"""Zamba2-2.7B — hybrid Mamba2 + shared attention [arXiv:2411.15242].

54 Mamba2 blocks; one *shared* (weight-tied) attention+MLP block applied
every 6 Mamba blocks (attn_every=6 -> 9 stage groups). Layer-wise stage =
one group of 6 Mamba blocks; the shared attention block trains whenever any
stage is active (weight sharing spans depths — DESIGN.md Arch-applicability).
long_500k: native (sub-quadratic SSM; the shared-attn KV cache is context-
parallel sharded).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    source="arXiv:2411.15242",
    notes="shared attention block trained in every stage (weight tying)",
)
