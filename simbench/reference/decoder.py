"""A plain dense decoder in PyTorch (the SmolLM / Llama block): one
client's model, one batch, in the configuration's type.

Per layer: ``x += Wo·attn(rope(Wq·n(x)), rope(Wk·n(x)), Wv·n(x))`` with
grouped-query heads (query head h reads key/value head ``h // (H/Hkv)``),
causal softmax attention computed in fp32 from the stored q, k, v, and
``x += Wdown·(silu(Wgate·n(x)) * Wup·n(x))``, where ``n`` is RMSNorm in
fp32 (``x·rsqrt(mean(x²) + eps)·scale``, rounded to x's type).  RoPE
rotates the two halves of each head by ``pos · theta^(-2i/hd)`` in fp32.
The head is the embedding transposed (tied), the logits fp32, the loss
the mean cross-entropy over the batch's tokens.  SiLU is taken op by op,
``x · 1/(1 + exp(-x))``, each op in x's type.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rmsnorm(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rope(x, theta: float):
    """``x [b, S, H, hd]`` rotated by position."""
    hd = x.shape[-1]
    freqs = torch.tensor(1.0 / (theta ** (np.arange(0, hd, 2) / hd)),
                         dtype=torch.float32, device=x.device)
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    ang = pos[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attention(q, k, v):
    """Causal GQA attention, ``[b, S, H, hd]`` against ``[b, S, Hkv, hd]``."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def hidden(units: list, tokens, arch, quant=None):
    """The final-normed hidden states ``[b, S, d]``."""
    q8 = quant or (lambda t: t)

    def mm(a, w):
        return q8(a) @ q8(w)

    b, s = tokens.shape
    h, hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    eps = arch.norm_eps
    x = units[0]["embed"][tokens.long()]
    for rep in units[1:-1]:
        a, f = rep["l0"]["b0"], rep["l0"]["b1"]
        n = rmsnorm(x, a["norm"], eps)
        q = rope(mm(n, a["wq"]).view(b, s, h, hd), arch.rope_theta)
        k = rope(mm(n, a["wk"]).view(b, s, hkv, hd), arch.rope_theta)
        v = mm(n, a["wv"]).view(b, s, hkv, hd)
        x = x + mm(attention(q, k, v).reshape(b, s, h * hd), a["wo"])
        n = rmsnorm(x, f["norm"], eps)
        g = mm(n, f["w_gate"])
        g = g * (1 / (1 + torch.exp(-g)))
        x = x + mm(g * mm(n, f["w_up"]), f["w_down"])
    return rmsnorm(x, units[-1]["final_norm"], eps), q8


def loss(units: list, batch: dict, arch, quant=None):
    """Mean cross-entropy over every token of ``batch`` (``tokens``,
    ``labels`` ``[b, S]``)."""
    x, q8 = hidden(units, batch["tokens"], arch, quant)
    logits = (q8(x) @ q8(units[0]["embed"]).T).float()
    labels = batch["labels"].long()
    nll = torch.logsumexp(logits, dim=-1) \
        - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll.mean()
