"""Mistral-Large-Instruct-2407 (123B) — dense GQA
[hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    notes="adafactor + microbatching at train_4k; "
          "long_500k uses window=8192",
)
TRAIN = TrainConfig(optimizer="adafactor", remat=True, microbatch=8)
