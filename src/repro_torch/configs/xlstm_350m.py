"""xLSTM-350m — sLSTM + mLSTM blocks.  [arXiv:2405.04517]

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry
their own projection (factor 2).  Pattern: one sLSTM block every 6 layers
(positions 5, 11, 17, 23), mLSTM elsewhere — the paper's sparse-sLSTM ratio.
"""
from repro_torch.config import ModelConfig, SSM, register

CONFIG = register(ModelConfig(
    arch_id="xlstm-350m",
    family=SSM,
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    ssm_pattern="mlstm*5,slstm",
    source="arXiv:2405.04517",
))
