"""StarCoder2-15B — dense GQA with RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152, act="gelu",
    source="arXiv:2402.19173",
    notes="StarCoder2 trains with a 4k sliding window natively; "
          "long_500k uses window=8192",
)
TRAIN = TrainConfig(optimizer="adamw", remat=True, microbatch=4)
