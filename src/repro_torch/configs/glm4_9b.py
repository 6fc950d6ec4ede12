"""GLM-4 9B — dense, RoPE, aggressive GQA (kv=2).  [hf:THUDM/glm-4-9b]

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.config import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    arch_id="glm4-9b",
    family=DENSE,
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    head_dim=128,
    rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
))
