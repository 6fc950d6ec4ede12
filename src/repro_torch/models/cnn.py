"""CNN models (VGG-16 / ResNet-18 families) for the paper-faithful CIFAR
experiments, in PyTorch.  Port of `repro.models.cnn`.

A model is a list of *cuttable layers* (one parameter dict per conv/fc
layer), so the HASFL split/latency machinery applies at conv/fc
granularity, exactly as the paper splits VGG-16.  Layouts follow the
reference: NHWC activations, HWIO filters ``[3, 3, Cin, Cout]``, and the
flatten before the first FC layer is in NHWC order.

Every forward runs over ``[N, ...]``-stacked per-client parameters and
batches (`cnn_stacked_forward`), with each convolution going through
`kernels.ops.batched_conv` — the client-batched GEMM kernel on the card,
its plain version on the CPU.  The single-model functions run the stacked
path at N = 1.

``cell_size`` (a grid's N, where the leading axis folds G cells of N
clients) reaches every conv, and runs the FC layers' GEMMs and the masked
loss means once per cell (`utils.cells.by_cell`): cuBLAS and
PyTorch's reductions choose their plans from the leading extent, so only
a cell's own shape sums as its own run does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as KOPS
from repro_torch.utils.cells import by_cell


def _conv_init(gen, cin, cout):
    scale = math.sqrt(2.0 / (9 * cin))
    return {"w": torch.randn((3, 3, cin, cout), generator=gen) * scale,
            "b": torch.zeros((cout,))}


def cnn_init(gen: torch.Generator, cfg: ModelConfig, device=None) -> list:
    """A list of per-layer param dicts (the cuttable units), drawn from
    ``gen`` (a CPU generator) with the reference's distributions: He
    normal convs, ``N(0, 1/fan_in)`` FC weights, zero biases."""
    params = []
    cin = 3
    for i, c in enumerate(cfg.conv_channels):
        p = _conv_init(gen, cin, c)
        if cfg.residual and i > 0 and cin != c:
            p["proj"] = _conv_init(gen, cin, c)
        params.append(p)
        cin = c
    n_pools = sum(1 for i in range(1, len(cfg.conv_channels) + 1)
                  if _pool_after(cfg, i))
    if cfg.residual:
        flat = cfg.conv_channels[-1]  # global average pool
    else:
        spatial = max(1, cfg.image_size // (2 ** n_pools))
        flat = cin * spatial * spatial
    prev = flat
    for f in list(cfg.fc_dims) + [cfg.n_classes]:
        w = torch.randn((prev, f), generator=gen) / math.sqrt(prev)
        params.append({"w": w, "b": torch.zeros((f,))})
        prev = f
    return [{k: _to(v, device) for k, v in p.items()} for p in params]


def _to(v, device):
    if isinstance(v, dict):
        return {k: _to(x, device) for k, x in v.items()}
    return v.to(device)


def cnn_layer_kinds(cfg: ModelConfig) -> list:
    return (["conv"] * len(cfg.conv_channels)
            + ["fc"] * len(cfg.fc_dims) + ["head"])


def _pool_after(cfg: ModelConfig, conv_idx_1based: int) -> bool:
    if cfg.residual:
        return False
    if len(cfg.conv_channels) == 13:  # full VGG-16
        return conv_idx_1based in (2, 4, 7, 10, 13)
    # reduced variants: pool every 2 convs
    return conv_idx_1based % 2 == 0


def _max_pool_2x2(x):
    """2x2 VALID max-pool over the H, W axes of ``[N, B, H, W, C]``."""
    n, b, h, w, c = x.shape
    x = x[:, :, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, b, h // 2, 2, w // 2, 2, c).amax(dim=(3, 5))


def _fc(x, w, b):
    return torch.bmm(x, w) + b[:, None, :]


def _masked_mean(nll, loss_mask):
    total = torch.clamp(loss_mask.sum(dim=1), min=1.0)
    return (nll * loss_mask).sum(dim=1) / total


def cnn_stacked_forward(params: list, x, cfg: ModelConfig, cell_size=None):
    """Full forward over [N, ...]-stacked per-client params and batches.

    x: [N, B, H, W, C]; every leaf of ``params`` carries a leading client
    axis.  Returns logits [N, B, n_classes].  ``cell_size``: a grid's N
    (see the module's note), or None.
    """
    kinds = cnn_layer_kinds(cfg)
    conv_seen = 0
    for i, p in enumerate(params):
        if kinds[i] == "conv":
            conv_seen += 1

            def conv(q, z, stride=1):
                return KOPS.batched_conv(z, q["w"], q["b"], stride=stride,
                                         cell_size=cell_size)

            if cfg.residual and "proj" not in p \
                    and x.shape[-1] == p["w"].shape[-1]:
                x = torch.relu(conv(p, x) + x)
            elif cfg.residual and "proj" in p:
                x = torch.relu(conv(p, x, 2) + conv(p["proj"], x, 2))
            else:
                x = torch.relu(conv(p, x))
            if _pool_after(cfg, conv_seen):
                x = _max_pool_2x2(x)
        else:
            if x.dim() == 5:
                if cfg.residual:
                    x = x.mean(dim=(2, 3))               # global average pool
                else:
                    x = x.reshape(x.shape[0], x.shape[1], -1)  # NHWC flatten
            x = by_cell(_fc, cell_size, x, p["w"], p["b"])
            if kinds[i] == "fc":
                x = torch.relu(x)
    return x


def _nll(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def cnn_stacked_loss(params: list, images, labels, cfg: ModelConfig,
                     loss_mask=None, cell_size=None):
    """Per-client masked-mean NLL [N] over the stacked forward.

    Differentiating the *sum* over clients yields exactly the per-client
    gradients (client i's stacked slice only touches loss i).
    """
    nll = _nll(cnn_stacked_forward(params, images, cfg, cell_size), labels)
    if loss_mask is not None:
        return by_cell(_masked_mean, cell_size, nll, loss_mask)
    return by_cell(lambda t: t.mean(dim=1), cell_size, nll)


def _stack1(params: list) -> list:
    return [{k: (_stack1([v])[0] if isinstance(v, dict) else v[None])
             for k, v in p.items()} for p in params]


def cnn_forward_layers(params: list, x, cfg: ModelConfig):
    """Single-model forward ``[B, H, W, C] -> [B, n_classes]``: the stacked
    path at N = 1."""
    return cnn_stacked_forward(_stack1(params), x[None], cfg)[0]


def cnn_loss(params: list, images, labels, cfg: ModelConfig, loss_mask=None):
    logits = cnn_forward_layers(params, images, cfg)
    nll = _nll(logits, labels)
    hit = (logits.argmax(-1) == labels.long()).to(logits.dtype)
    if loss_mask is not None:
        total = torch.clamp(loss_mask.sum(), min=1.0)
        loss = (nll * loss_mask).sum() / total
        acc = (hit * loss_mask).sum() / total
    else:
        loss = nll.mean()
        acc = hit.mean()
    return loss, {"accuracy": acc}
