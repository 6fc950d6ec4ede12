"""DBRX 132B — fine-grained MoE, 16 experts top-4.  [hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""
from repro_torch.config import ModelConfig, MOE, register

CONFIG = register(ModelConfig(
    arch_id="dbrx-132b",
    family=MOE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    n_experts=16,
    top_k=4,
    d_ff_expert=10752,
    moe_every=1,
    rope_theta=500000.0,
    source="hf:databricks/dbrx-base",
))
