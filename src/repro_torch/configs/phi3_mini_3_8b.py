"""Phi-3-mini 3.8B — dense, RoPE SwiGLU GQA.  [arXiv:2404.14219]

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.config import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    arch_id="phi3-mini-3.8b",
    family=DENSE,
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    rope_theta=10000.0,
    source="arXiv:2404.14219",
))
