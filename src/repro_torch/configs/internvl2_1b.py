"""InternVL2-1B — VLM backbone (InternLM2 LM; InternViT stub).  [arXiv:2404.16821]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The InternViT vision
encoder + MLP projector are a STUB per the carve-out: input_specs() provides
precomputed patch embeddings (256 patches per image tile) merged with text.
"""
from repro_torch.config import ModelConfig, VLM, register

CONFIG = register(ModelConfig(
    arch_id="internvl2-1b",
    family=VLM,
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    n_patches=256,
    source="arXiv:2404.16821",
))
