"""Qwen3-1.7B — dense, qk_norm, GQA.  [hf:Qwen/Qwen3-8B]

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.config import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    arch_id="qwen3-1.7b",
    family=DENSE,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B",
))
