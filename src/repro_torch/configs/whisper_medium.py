"""Whisper-medium — audio enc-dec backbone.  [arXiv:2212.04356]

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.  The mel-spectrogram +
conv frontend is a STUB per the assignment carve-out: input_specs() provides
precomputed frame embeddings (1500 frames for 30 s audio).
"""
from repro_torch.config import ModelConfig, AUDIO, register

CONFIG = register(ModelConfig(
    arch_id="whisper-medium",
    family=AUDIO,
    n_layers=24,              # decoder layers
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    source="arXiv:2212.04356",
))
