"""Zamba2-7B at its published widths [arXiv:2411.15242;
https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json].

81 Mamba2 layers (d 3584; 112 heads of 64, state 64, 2 groups of B and C,
conv 4, chunk 256); at the 13 hybrid layers one of two shared blocks in
turn, over the stream joined to the embedding (7168 wide, 32 heads of
224, causal RoPE over the whole head, q.k scaled by (224 / 2)^-0.5, an
exact-GELU GeGLU MLP of 14336), each use with its own rank-128 LoRA on the
gate-up product and its own 3584 x 3584 projection into the layer's Mamba2
input. Embeddings tied and not scaled. A layer-wise stage is 6 layers:
``models/lm.py``'s ``zamba2`` topology. The JAX package has no such
config; ``zamba2-2.7b`` keeps its JAX layout.
"""
from repro_torch.configs.base import GroupedSSMConfig, Zamba2Config

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = Zamba2Config(
    arch_id="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=224,
    rope_theta=10000.0, act="geglu", norm_eps=1e-5, tie_embeddings=True,
    ssm=GroupedSSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                         chunk_size=256, n_groups=2),
    hybrid_layer_ids=HYBRID_LAYER_IDS, num_mem_blocks=2, adapter_rank=128,
    stage_layers=6,
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/"
           "config.json",
    notes="published Zamba2 layout: shared blocks over [x, e], per-use LoRA "
          "and output projections, 2-group SSD",
)
