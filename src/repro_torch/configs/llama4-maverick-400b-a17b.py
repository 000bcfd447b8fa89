"""Llama-4 Maverick 400B-A17B — interleaved MoE (every 2nd block:
128 routed experts top-1 + 1 shared), early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, TrainConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    moe=MoEConfig(num_experts=128, experts_per_token=1,
                  num_shared_experts=1, d_ff_expert=8192,
                  moe_every=2),   # 1 MoE : 1 dense interleave
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    notes="expert-parallel over the model axis; adafactor + microbatching; "
          "long_500k uses window=8192",
)
TRAIN = TrainConfig(optimizer="adafactor", remat=True, microbatch=8)
