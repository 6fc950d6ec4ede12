"""ResNet-18 on CIFAR — the paper's own experiment model.  [arXiv:1512.03385]

17 conv + 1 FC; residual blocks; 18 cut points.
"""
from repro_torch.config import ModelConfig, CNN, register

CONFIG = register(ModelConfig(
    arch_id="resnet18-cifar",
    family=CNN,
    n_layers=0,
    d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    conv_channels=(64,) + (64,) * 4 + (128,) * 4 + (256,) * 4 + (512,) * 4,
    fc_dims=(),
    image_size=32,
    n_classes=100,
    residual=True,
    dtype="float32",
    source="arXiv:1512.03385 (paper SecVII model)",
))

CONFIG_SMALL = register(ModelConfig(
    arch_id="resnet10-cifar-small",
    family=CNN,
    n_layers=0,
    d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=0,
    conv_channels=(16,) + (16,) * 2 + (32,) * 2 + (64,) * 2,
    fc_dims=(),
    image_size=32,
    n_classes=100,
    residual=True,
    dtype="float32",
    source="reduced ResNet for CPU-feasible training",
))
