"""A plain VGG in PyTorch: one client's model, one batch, fp32.

Convolutions are 3x3, stride 1, SAME padding, each followed by ReLU and,
after the configured convs, a 2x2 max-pool; the flatten before the first
FC layer is in NHWC order (images are ``[B, H, W, 3]``, filters HWIO), as
the cuttable-unit layout stores them.  FC layers are ``x @ w + b`` with
ReLU between them.  The loss is the mean negative log-likelihood.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from simbench.reference.params import pools_after


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
