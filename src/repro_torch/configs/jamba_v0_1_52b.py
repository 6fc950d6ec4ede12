"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  One attention layer
per 8 (attn at positions 7, 15, 23, 31 within each block group, matching the
paper's a=1:m=7 ratio); MoE FFN every other layer (e=2).
"""
from repro_torch.config import ModelConfig, HYBRID, register

CONFIG = register(ModelConfig(
    arch_id="jamba-v0.1-52b",
    family=HYBRID,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_every=2,
    attn_every=8,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    source="arXiv:2403.19887",
))
