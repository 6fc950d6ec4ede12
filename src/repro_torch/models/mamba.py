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

Training differentiates the loop with autograd, one chunk of steps at a
time under `torch.utils.checkpoint`: the forward keeps only each chunk's
entering state, and the backward recomputes a chunk's factors and states
(``SCAN_CHUNK`` states of ``[rows, d_in, N]`` fp32 at once) before it
differentiates them.  With client-stacked weights (leaves ``[N, ...]``,
``x [N, b, S, d]``) every client's rows run in the same loop, each with its
own conv, ``dt`` projection and ``A``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import meta as META
from repro_torch.models.layers import (_normal, dense_init, mm, per_client,
                                      rmsnorm, silu)
from repro_torch.utils.cells import apart, by_cell

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
    """Depthwise causal conv, fp32.  x: [B, S, C]; w: [K, C]; b: [C] — or
    per client, x [N, b, S, C], w [N, K, C], b [N, C]."""
    k, s = w.shape[-2], x.shape[-2]
    w, b = per_client(w, x, 2), per_client(b, x, 1)
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k):
        out = out + xp[..., i:i + s, :].float() * w[..., i, :]
    return out + b


def _step(state, da, dbx):
    """One fp32 state update ``da · state + dbx`` in one launch, the same
    op on the full and decode paths."""
    return torch.addcmul(dbx, da, state)


def _scan_chunk(state, a, dt, x1, b_mat, c_mat):
    """Up to `SCAN_CHUNK` steps of the selective scan from ``state [R,
    d_in, N]`` (R: the stream's rows): dt, x1 ``[*lead, c, d_in]`` and
    b_mat, c_mat ``[*lead, c, N]`` in the stream dtype, ``a`` broadcasting
    against ``[*lead, c, d_in, N]``.  Returns (ys ``[R, c, d_in]`` in the
    stream dtype, the state after the chunk)."""
    c, d_in = dt.shape[-2:]
    n = b_mat.shape[-1]
    dt_f, x_f = dt.float(), x1.float()
    da = torch.exp(dt_f[..., None] * a).reshape(-1, c, d_in, n)
    dbx = ((dt_f * x_f)[..., None] * b_mat.float()[..., None, :]).reshape(
        -1, c, d_in, n)
    c_f = c_mat.float().reshape(-1, c, n)[..., None]     # [R, c, N, 1]
    ys = torch.empty((da.shape[0], c, d_in), dtype=dt.dtype,
                     device=dt.device)
    for i in range(c):
        state = _step(state, da[:, i], dbx[:, i])
        ys[:, i] = torch.bmm(state, c_f[:, i])[..., 0]
    return ys, state


def mamba_block(params: dict, x, *, state_dim: int, eps: float = 1e-5,
                cell_size=None):
    """Full-sequence selective scan. x: [B, S, d] (or [N, b, S, d] on
    client-stacked weights); returns block output.  ``cell_size`` (a
    grid's N, where the client axis folds G cells) runs the block once per
    cell: the state's readout products and the backward's sums over the
    per-client parameters' broadcast may plan by the leading extent."""
    if apart(x, cell_size):
        return by_cell(lambda p, xc: mamba_block(p, xc, state_dim=state_dim,
                                                 eps=eps),
                       cell_size, params, x)
    *lead, s, d = x.shape
    dtype = x.dtype
    xn = rmsnorm(x, params["norm_in"], eps)
    x1, z = mm(xn, params["w_in"]).chunk(2, dim=-1)      # [.., S, d_in] each
    x1 = silu(_causal_conv(x1, params["conv_w"],
                             params["conv_b"])).to(dtype)
    bc = mm(x1, params["w_bc"].to(dtype))                # [.., S, 2N]
    b_mat, c_mat = bc.chunk(2, dim=-1)
    dt = F.softplus(mm(x1.float(), params["w_dt"])
                    + per_client(params["b_dt"], x1, 1)).to(dtype)
    a = per_client(-torch.exp(params["a_log"]), x1, 2)   # [.., d_in, N]

    d_in = x1.shape[-1]
    state = torch.zeros((math.prod(lead), d_in, state_dim), dtype=F32,
                        device=x.device)
    if x.is_meta:      # the dry-run: the loop's shapes and work only
        ys = [META.mamba_loop(dt, x1, b_mat, c_mat, a, state_dim)]
    else:
        ys = []
        for t0 in range(0, s, SCAN_CHUNK):
            part = [t[..., t0:t0 + SCAN_CHUNK, :]
                    for t in (dt, x1, b_mat, c_mat)]
            if torch.is_grad_enabled():
                y_c, state = checkpoint(_scan_chunk, state, a, *part,
                                        use_reentrant=False)
            else:
                y_c, state = _scan_chunk(state, a, *part)
            ys.append(y_c)
    ys = (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)).reshape(
        *lead, s, d_in)
    y = ys + (per_client(params["d_skip"], x1, 1) * x1.float()).to(dtype)
    y = y * silu(z)
    return mm(y, params["w_out"])


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
