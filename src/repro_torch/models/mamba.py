"""Mamba-1 selective-scan mixer (for the Jamba hybrid).  Port of
`repro.models.mamba`.  [arXiv:2312.00752]

Rounding points are the reference's: the conv output, ``bc`` and ``dt``
are rounded to the stream dtype; the carried state and its update run in
fp32.  The reference's ``chunked_scan`` is forward-identical to a plain
scan (its chunks only checkpoint the backward), so the forward here is a
loop over time with an fp32 state.  The reference has no Pallas kernel
for it; on the card the loop is plain PyTorch: the state-independent
factors ``exp(dt·A)`` and ``dt·x·B`` are formed a chunk of steps at a time,
so a step is three launches (update, readout, store).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_init, rmsnorm, silu

F32 = torch.float32
SCAN_CHUNK = 64       # steps whose factors are formed at once


def mamba_init(gen, d: int, *, expand: int, state_dim: int, conv_dim: int,
               dtype, device=None, lead=()) -> dict:
    """Parameters of one mamba block, stacked ``[*lead, ...]``; all but
    ``w_in`` and ``w_out`` are fp32, as in the reference."""
    d_in = expand * d
    dt_init = torch.log(torch.expm1(torch.linspace(
        1e-3, 1e-1, d_in, dtype=F32)))
    a_log = torch.log(torch.arange(1, state_dim + 1, dtype=F32))

    def full(v, shape):
        return v.to(device).expand(*lead, *shape).clone()

    return {
        "norm_in": torch.ones((*lead, d), dtype=F32, device=device),
        "w_in": dense_init(gen, d, 2 * d_in, dtype, device, lead),
        "conv_w": _normal(gen, (*lead, conv_dim, d_in), device)
        / math.sqrt(conv_dim),
        "conv_b": torch.zeros((*lead, d_in), dtype=F32, device=device),
        "w_bc": dense_init(gen, d_in, 2 * state_dim, F32, device, lead),
        "w_dt": dense_init(gen, d_in, d_in, F32, device, lead),
        "b_dt": full(dt_init, (d_in,)),
        "a_log": full(a_log, (d_in, state_dim)),
        "d_skip": torch.ones((*lead, d_in), dtype=F32, device=device),
        "w_out": dense_init(gen, d_in, d, dtype, device, lead),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, fp32.  x: [B, S, C]; w: [K, C]."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * w[i]
    return out + b


def _step(state, da, dbx):
    """One fp32 state update ``da · state + dbx`` in one launch, the same
    op on the full and decode paths."""
    return torch.addcmul(dbx, da, state)


def mamba_block(params: dict, x, *, state_dim: int, eps: float = 1e-5):
    """Full-sequence selective scan. x: [B, S, d]; returns block output."""
    b, s, d = x.shape
    dtype = x.dtype
    xn = rmsnorm(x, params["norm_in"], eps)
    x1, z = (xn @ params["w_in"]).chunk(2, dim=-1)       # [B, S, d_in] each
    x1 = silu(_causal_conv(x1, params["conv_w"],
                             params["conv_b"])).to(dtype)
    bc = x1 @ params["w_bc"].to(dtype)                   # [B, S, 2N]
    b_mat, c_mat = bc.chunk(2, dim=-1)
    dt = F.softplus(x1.float() @ params["w_dt"] + params["b_dt"]).to(dtype)
    a = -torch.exp(params["a_log"])                      # [d_in, N]

    d_in = x1.shape[-1]
    state = torch.zeros((b, d_in, state_dim), dtype=F32, device=x.device)
    ys = torch.empty((b, s, d_in), dtype=dtype, device=x.device)
    for t0 in range(0, s, SCAN_CHUNK):
        sl = slice(t0, min(s, t0 + SCAN_CHUNK))
        dt_f, x_f = dt[:, sl].float(), x1[:, sl].float()
        da = torch.exp(dt_f[..., None] * a)              # [B, c, d_in, N]
        dbx = (dt_f * x_f)[..., None] * b_mat[:, sl].float()[:, :, None, :]
        c_f = c_mat[:, sl].float()[..., None]            # [B, c, N, 1]
        for i in range(da.shape[1]):
            state = _step(state, da[:, i], dbx[:, i])
            ys[:, t0 + i] = torch.bmm(state, c_f[:, i])[..., 0]
    y = ys + (params["d_skip"] * x1.float()).to(dtype)
    y = y * silu(z)
    return y @ params["w_out"]


def mamba_decode_init(batch: int, d_in: int, state_dim: int, conv_dim: int,
                      device=None, lead=()) -> dict:
    return {"ssm": torch.zeros((*lead, batch, d_in, state_dim), dtype=F32,
                               device=device),
            "conv": torch.zeros((*lead, batch, conv_dim - 1, d_in),
                                dtype=F32, device=device)}


def mamba_block_decode(params, x, state, *, state_dim: int,
                       eps: float = 1e-5):
    """Single-token step. x: [B, 1, d].  Returns (out, new state).

    Dtype handling mirrors ``mamba_block`` exactly (streams in the compute
    dtype, state/update math in fp32): the full-sequence path rounds the
    conv output, ``bc`` and ``dt`` through the compute dtype, and keeping
    those fp32 here would let the recurrent state drift past the
    decode == full-forward tolerance after a few steps.
    """
    dtype = x.dtype
    xn = rmsnorm(x, params["norm_in"], eps)
    x1, z = (xn @ params["w_in"])[:, 0].chunk(2, dim=-1)
    hist = torch.cat([state["conv"], x1[:, None].float()], dim=1)  # [B, K, d_in]
    conv = torch.einsum("bkc,kc->bc", hist, params["conv_w"]) \
        + params["conv_b"]
    x1c = silu(conv).to(dtype)
    b_t, c_t = (x1c @ params["w_bc"].to(dtype)).chunk(2, dim=-1)
    dt = F.softplus(x1c.float() @ params["w_dt"] + params["b_dt"]).to(dtype)
    a = -torch.exp(params["a_log"])
    x_f, dt_f = x1c.float(), dt.float()
    ssm = _step(state["ssm"], torch.exp(dt_f[..., None] * a),
                (dt_f * x_f)[..., None] * b_t.float()[:, None, :])
    y = torch.bmm(ssm, c_t.float()[..., None])[..., 0].to(dtype) \
        + (params["d_skip"] * x_f).to(dtype)
    y = y * silu(z)
    return (y @ params["w_out"])[:, None], {"ssm": ssm, "conv": hist[:, 1:]}
