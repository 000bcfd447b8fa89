"""DeepSeek-V2 (236B) — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6
[arXiv:2405.04434]. d_ff=1536 is the per-expert hidden dim."""
from repro_torch.configs.base import ModelConfig, MLAConfig, MoEConfig, TrainConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, experts_per_token=6,
                  num_shared_experts=2, d_ff_expert=1536),
    source="arXiv:2405.04434",
    notes="MLA latent cache makes long_500k decode practical: "
          "cache is (seq, 512+64) per layer, context-parallel sharded; "
          "long_500k uses window=8192 on the latent cache",
)
TRAIN = TrainConfig(optimizer="adafactor", remat=True, microbatch=8)
