"""Core layers of the token models, in PyTorch.  Port of
`repro.models.layers` (the parts the serving path runs).

Dense weights keep the reference's ``[in, out]`` layout (``x @ W``), so
weights carry across without transposes.  Initializers draw from an
explicit `torch.Generator` (their numbers differ from the reference's
``jax.random`` draws; parity tests carry the reference's weights across
with `repro_torch.convert.params_from_numpy`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS


def _normal(gen, shape, device):
    """Standard normal fp32 draws on the generator's device, moved to
    ``device``."""
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device=None, lead=()):
    """``N(0, 1/in_dim)`` weights ``[*lead, in_dim, out_dim]`` in ``dtype``."""
    w = _normal(gen, (*lead, in_dim, out_dim), device) / math.sqrt(in_dim)
    return w.to(dtype)


def embed_init(gen, vocab: int, d: int, dtype, device=None):
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last axis, through `kernels.ops.rmsnorm` (the CUDA
    kernel on the card, its plain version on the CPU)."""
    return KOPS.rmsnorm(x, scale, eps)


# --- rotary position embeddings --------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  fp32
    math, out in x's type."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = torch.tensor(rope_freqs(hd, theta), dtype=torch.float32,
                         device=x.device)                       # [hd/2]
    ang = positions.to(torch.float32)[..., None] * freqs         # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- feed-forward ------------------------------------------------------------

def swiglu(params: dict, x):
    g = F.silu(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]


def gelu(x):
    """The reference's ``jax.nn.gelu`` (its default: the tanh form)."""
    return F.gelu(x, approximate="tanh")
