"""Core layers of the token models, in PyTorch.  Port of
`repro.models.layers` (the parts the serving path runs).

Dense weights keep the reference's ``[in, out]`` layout (``x @ W``), so
weights carry across without transposes.  Initializers draw from an
explicit `torch.Generator` (their numbers differ from the reference's
``jax.random`` draws; parity tests carry the reference's weights across
with `repro_torch.convert.params_from_numpy`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS
from repro_torch.utils.cells import by_cell


def _normal(gen, shape, device):
    """Standard normal fp32 draws on the generator's device, moved to
    ``device``; on the ``meta`` device (the dry-run's shapes-only state)
    nothing is drawn."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device=None, lead=()):
    """``N(0, 1/in_dim)`` weights ``[*lead, in_dim, out_dim]`` in ``dtype``."""
    w = _normal(gen, (*lead, in_dim, out_dim), device) / math.sqrt(in_dim)
    return w.to(dtype)


def stacked_normal_init(gen, shape, scale: float, dtype, device=None):
    """``N(0, scale²)`` weights of ``shape`` in ``dtype``, drawn one
    trailing ``[in, out]`` matrix at a time straight into the leaf, so the
    fp32 transient is one matrix and not the whole leaf (an expert stack
    ``[R, E, d, d_ff]`` is tens of GB in bf16)."""
    w = torch.empty(shape, dtype=dtype, device=device)
    flat = w.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = _normal(gen, shape[-2:], device) * scale
    return w


def _bmm(x, w):
    n = w.shape[0]
    return torch.bmm(x.reshape(n, -1, x.shape[-1]), w).reshape(
        *x.shape[:-1], w.shape[-1])


def mm(x, w, cell_size=None):
    """``x @ w`` for ``w [in, out]``; for client-stacked ``w [N, in, out]``
    and ``x [N, ..., in]``, one product per client as a single `torch.bmm`
    (the reference's vmap over clients).  ``cell_size`` (a grid's N, where
    the leading axis folds G cells of N clients) makes it one `torch.bmm`
    a cell (`utils.cells.by_cell`): cuBLAS picks its algorithm, and with
    it the split of ``dW = xᵀ·dy``'s sum, by the batch count."""
    if w.dim() == 2:
        return x @ w
    return by_cell(_bmm, cell_size, x, w)


def per_client(p, x, rank: int):
    """A leaf beside a stream ``x``: as it is when it has its own
    ``rank``, or client-stacked ``[N, *rest]`` beside ``x [N, ..., d]``
    viewed ``[N, 1, …, 1, *rest]`` to broadcast over x's axes between the
    client axis and the last."""
    if p.dim() == rank:
        return p
    return p[(slice(None),) + (None,) * (x.dim() - 2)]


def embed_init(gen, vocab: int, d: int, dtype, device=None):
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


def rmsnorm(x, scale, eps: float = 1e-5, cell_size=None):
    """RMSNorm over the last axis, through `kernels.ops.rmsnorm` (the CUDA
    kernel on the card, its plain version on the CPU); ``cell_size`` as
    `mm`'s, for a client-stacked ``[N, d]`` scale."""
    return KOPS.rmsnorm(x, scale, eps, cell_size=cell_size)


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


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


SINUSOIDAL_ROWS = 8192   # rows of the cached table (decode's, in the reference)


@functools.lru_cache(maxsize=8)
def _sinusoidal_table(seq: int, d: int, dtype, device) -> torch.Tensor:
    return torch.tensor(sinusoidal_positions(seq, d), device=device).to(dtype)


def sinusoidal_table(seq: int, d: int, dtype, device) -> torch.Tensor:
    """``sinusoidal_positions(seq, d)`` as a tensor in ``dtype`` on
    ``device``: the first ``seq`` rows of one table of at least
    ``SINUSOIDAL_ROWS`` rows, built once per (d, dtype, device) and cached
    (a row does not depend on the table's length)."""
    rows = max(seq, SINUSOIDAL_ROWS)
    return _sinusoidal_table(rows, d, dtype, torch.device(device))[:seq]


# --- feed-forward ------------------------------------------------------------

def swiglu_init(gen, d: int, d_ff: int, dtype, device=None, lead=()) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device, lead),
        "w_up": dense_init(gen, d, d_ff, dtype, device, lead),
        "w_down": dense_init(gen, d_ff, d, dtype, device, lead),
    }


def silu(x):
    """``x · 1/(1 + exp(-x))`` op by op, each op rounded to x's type: the
    reference's ``jax.nn.silu`` as it lowers (negate, exp, add, divide,
    multiply), so bf16 rounds where the reference rounds.  ``F.silu``
    rounds once, one bf16 ulp off it in ~40 % of elements, which the MoE
    and mamba stacks carry past the bf16 parity bar."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(params: dict, x, cell_size=None):
    g = silu(mm(x, params["w_gate"], cell_size))
    return mm(g * mm(x, params["w_up"], cell_size), params["w_down"],
              cell_size)


def gelu(x):
    """The reference's ``jax.nn.gelu`` (its default: the tanh form)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp_init(gen, d: int, d_ff: int, dtype, device=None, lead=()) -> dict:
    return {"w_up": dense_init(gen, d, d_ff, dtype, device, lead),
            "w_down": dense_init(gen, d_ff, d, dtype, device, lead)}


def gelu_mlp(params: dict, x, cell_size=None):
    return mm(gelu(mm(x, params["w_up"], cell_size)), params["w_down"],
              cell_size)
