"""xLSTM-125M — sLSTM + mLSTM blocks [arXiv:2405.04517].

12 blocks in groups of 6 (5 mLSTM + 1 sLSTM); layer-wise stage = one group
(the paper's "layer" may be a block of layers). d_ff=0: xLSTM blocks carry
their own up/down projections (proj_factor=2).
long_500k: native (recurrent state is O(1)).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=6, proj_factor=2.0),
    source="arXiv:2405.04517",
)
