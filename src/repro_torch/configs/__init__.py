"""Architecture registry: importing this package registers the CNN configs.

Only the paper's CNN families are ported so far; the token architectures
of `repro.configs` are listed in ROADMAP.md as still to port.
"""
from repro_torch.configs import (  # noqa: F401
    vgg16_cifar,
    resnet18_cifar,
)
