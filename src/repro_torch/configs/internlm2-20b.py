"""InternLM2-20B — dense GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    source="arXiv:2403.17297",
    notes="long_500k uses window=8192",
)
TRAIN = TrainConfig(optimizer="adamw", remat=True, microbatch=4)
