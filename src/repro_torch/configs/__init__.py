"""Architecture registry: importing this package registers the configs.

The paper's CNN families and the token models the port serves (the dense
`qwen3-1.7b` and `smollm-135m`, the SSM `xlstm-350m`); the other token
architectures of `repro.configs` are listed in ROADMAP.md as still to port.
"""
from repro_torch.configs import (  # noqa: F401
    vgg16_cifar,
    resnet18_cifar,
    qwen3_1_7b,
    smollm_135m,
    xlstm_350m,
)
from repro_torch.configs.input_shapes import (  # noqa: F401
    INPUT_SHAPES,
    concrete_inputs,
    input_specs,
)
