"""InternLM2-1.8B — dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544,
    source="arXiv:2403.17297",
    notes="long_500k uses the sliding-window variant (window=8192)",
)
