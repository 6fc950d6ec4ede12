"""SmolLM-135M — llama-arch small dense.  [hf:HuggingFaceTB/SmolLM-135M]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.config import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    arch_id="smollm-135m",
    family=DENSE,
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
))

# CPU-scale member of the same family, registered so declarative
# `repro_torch.api.ExperimentSpec`s can name a token-arch cell (the
# dispatch-bound regime the grid runner and sim_speed's lm-tiny
# configuration target) — `reduced()` transforms can't be expressed in
# a JSON spec, registry entries can.
TINY = register(ModelConfig(
    arch_id="smollm-tiny",
    family=DENSE,
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=256,
    head_dim=32,
    tie_embeddings=True,
    source="reduced smollm-135m (CPU-scale; not a released model)",
))
