"""A plain VGG in PyTorch: one client's model, one batch, fp32.

Convolutions are 3x3, stride 1, SAME padding, each followed by ReLU and,
after the configured convs, a 2x2 max-pool; the flatten before the first
FC layer is in NHWC order (images are ``[B, H, W, 3]``, filters HWIO), as
the cuttable-unit layout stores them.  FC layers are ``x @ w + b`` with
ReLU between them.  The loss is the mean negative log-likelihood.

The reference of a configuration whose ``"reference"`` is ``"vgg"``: the
module supplies `reference.contract`'s names.  One unit a conv or FC layer
(``{"w", "b"}``: HWIO filters, ``[in, out]`` FC weights), He normal convs,
``N(0, 1/fan_in)`` FC weights, zero biases; a cut ``c`` keeps units
``0..c-1`` on the clients.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from simbench.reference.contract import frozen_arch
from simbench.reference.hasfl.config import ModelConfig
from simbench.reference.host import make_cifar_like

# A CNN's sizes, and the token widths the frozen type requires (all 0).
READS = ("arch_id", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
         "d_ff", "vocab_size", "conv_channels", "fc_dims", "image_size",
         "n_classes", "residual", "dtype")
TOKEN_WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size")
SMALL = {"program_arch": "vgg9-cifar-small",
         "model": {"arch_id": "vgg9-cifar-small",
                   "conv_channels": [16, 16, 32, 32, 64, 64],
                   "fc_dims": [128]},
         "traffic": {"n_clients": 4, "n_train": 400, "n_test": 50},
         "counts": {}}


def make_arch(model: dict) -> ModelConfig:
    arch = frozen_arch(ModelConfig, model, READS, __file__)
    if arch.family != "cnn" or arch.residual:
        raise ValueError(f"{arch.arch_id}: vgg.py runs a plain CNN, not "
                         f"family {arch.family!r} residual {arch.residual}")
    if any(getattr(arch, k) for k in TOKEN_WIDTHS):
        raise ValueError(f"{arch.arch_id}: a CNN has no {TOKEN_WIDTHS}")
    return arch


def pools_after(arch) -> list:
    """1-based conv indices followed by a 2x2 max-pool."""
    n = len(arch.conv_channels)
    return [i for i in range(1, n + 1)
            if (i in (2, 4, 7, 10, 13) if n == 13 else i % 2 == 0)]


def leaf_specs(arch) -> list:
    out, cin = [], 3
    for u, c in enumerate(arch.conv_channels):
        out.append((u, ("w",), (3, 3, cin, c), "float32",
                    math.sqrt(2.0 / (9 * cin))))
        out.append((u, ("b",), (c,), "float32", "zeros"))
        cin = c
    spatial = max(1, arch.image_size // 2 ** len(pools_after(arch)))
    prev = cin * spatial * spatial
    for f in list(arch.fc_dims) + [arch.n_classes]:
        u = out[-1][0] + 1
        out.append((u, ("w",), (prev, f), "float32", 1 / math.sqrt(prev)))
        out.append((u, ("b",), (f,), "float32", "zeros"))
        prev = f
    return out


def forward(units: list, images, arch, quant=None):
    """Logits ``[B, n_classes]``.  ``quant`` (a control's rounding of
    every product's operands) is applied to each conv's and FC's inputs."""
    q = quant or (lambda t: t)
    pools = set(pools_after(arch))
    x = images.permute(0, 3, 1, 2)
    n_conv = len(arch.conv_channels)
    for i in range(n_conv):
        w = units[i]["w"].permute(3, 2, 0, 1)
        x = torch.relu(F.conv2d(q(x), q(w), units[i]["b"], padding=1))
        if i + 1 in pools:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for j, u in enumerate(units[n_conv:]):
        x = q(x) @ q(u["w"]) + u["b"]
        if j < len(units) - n_conv - 1:
            x = torch.relu(x)
    return x


def loss(units: list, batch: dict, arch, quant=None):
    """Mean NLL of ``batch`` (``images``, ``labels``)."""
    logits = forward(units, batch["images"], arch, quant)
    return F.cross_entropy(logits, batch["labels"].long())


def train_data(arch, traffic: dict, seed: int):
    (xtr, ytr), _ = make_cifar_like(arch.n_classes, traffic["n_train"],
                                    traffic["n_test"], arch.image_size,
                                    seed=seed)
    return {"images": xtr, "labels": ytr}, ytr


def n_labels(arch) -> int:
    return arch.n_classes


def client_specific(arch, cuts, n_units: int) -> list:
    """Units before the deepest cut (one unit a layer)."""
    l_c = max(int(c) for c in cuts)
    return [u < l_c for u in range(n_units)]


def unit_layer_spans(arch, n_units: int, n_layers: int) -> list:
    return [(u, u + 1) for u in range(n_units)]          # one unit a layer


def layer_flops(arch) -> list:
    """Forward FLOPs of each conv and FC layer, per sample."""
    out, cin, hw = [], 3, arch.image_size
    pools = set(pools_after(arch))
    for i, c in enumerate(arch.conv_channels):
        out.append(2 * hw * hw * 9 * cin * c)
        cin = c
        if i + 1 in pools:
            hw //= 2
    prev = cin * hw * hw
    for f in list(arch.fc_dims) + [arch.n_classes]:
        out.append(2 * prev * f)
        prev = f
    return out


def train_flops(arch, samples: int, seq: int = 0,
                causal_half: bool = True) -> float:
    """The forward, and twice it for the backward, less the first conv's
    input gradient, which nothing needs."""
    layers = layer_flops(arch)
    return samples * (3 * sum(layers) - layers[0])


def conv_gemm_flops(arch) -> float:
    """Forward, weight and input gradients of every conv, less the first
    conv's input gradient."""
    convs = layer_flops(arch)[:len(arch.conv_channels)]
    return 3 * sum(convs) - convs[0]


def attention_calls(arch):
    return None


def norms_per_step(arch):
    return None


def example_batch(arch, rows: int, seq: int, generator) -> dict:
    return {"images": torch.randn(rows, arch.image_size, arch.image_size, 3,
                                  generator=generator),
            "labels": torch.randint(0, arch.n_classes, (rows,),
                                    generator=generator)}
