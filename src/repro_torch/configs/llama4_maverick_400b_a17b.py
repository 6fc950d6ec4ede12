"""Llama-4 Maverick 400B-A17B — MoE, 128 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E]  (assigned spec)
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Sliding-window (chunked-attention) variant used for long_500k, matching the
model card's interleaved chunked attention.
"""
from repro_torch.config import ModelConfig, MOE, register

CONFIG = register(ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family=MOE,
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    n_experts=128,
    top_k=1,
    d_ff_expert=8192,
    moe_every=2,   # Maverick interleaves dense/MoE layers (model card) -> ~400B total
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
