"""VGG-16 on CIFAR — the paper's own experiment model.  [arXiv:1409.1556]

13 conv + 3 FC layers; HASFL cut points are conv/fc boundaries (16 cuts).
"""
from repro_torch.config import ModelConfig, CNN, register

CONFIG = register(ModelConfig(
    arch_id="vgg16-cifar",
    family=CNN,
    n_layers=0,
    d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    conv_channels=(64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512),
    fc_dims=(512, 512),
    image_size=32,
    n_classes=10,
    dtype="float32",
    source="arXiv:1409.1556 (paper SecVII model)",
))

# Reduced-width variant actually *trained* on CPU in benchmarks (documented
# reduction; layer structure + cut semantics identical).
CONFIG_SMALL = register(ModelConfig(
    arch_id="vgg9-cifar-small",
    family=CNN,
    n_layers=0,
    d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    conv_channels=(16, 16, 32, 32, 64, 64),
    fc_dims=(128,),
    image_size=32,
    n_classes=10,
    dtype="float32",
    source="reduced VGG for CPU-feasible training",
))
