"""Architecture registry: importing this package registers the configs.

The paper's CNN families and every token architecture of `repro.configs`:
the DENSE `qwen3-1.7b`, `smollm-135m`, `glm4-9b` and `phi3-mini-3.8b`, the
SSM `xlstm-350m`, the MOE `dbrx-132b` and `llama4-maverick-400b-a17b`,
the HYBRID `jamba-v0.1-52b`, the AUDIO `whisper-medium` and the VLM
`internvl2-1b`.
"""
from repro_torch.configs import (  # noqa: F401
    vgg16_cifar,
    resnet18_cifar,
    qwen3_1_7b,
    smollm_135m,
    xlstm_350m,
    glm4_9b,
    phi3_mini_3_8b,
    dbrx_132b,
    llama4_maverick_400b_a17b,
    jamba_v0_1_52b,
    whisper_medium,
    internvl2_1b,
)
from repro_torch.configs.input_shapes import (  # noqa: F401
    INPUT_SHAPES,
    concrete_inputs,
    input_specs,
)

# the token architectures, in the reference's order
ASSIGNED = [
    "llama4-maverick-400b-a17b",
    "phi3-mini-3.8b",
    "glm4-9b",
    "whisper-medium",
    "xlstm-350m",
    "smollm-135m",
    "internvl2-1b",
    "dbrx-132b",
    "jamba-v0.1-52b",
    "qwen3-1.7b",
]
