"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).  Port of
`repro.models.ssm`.

Both use exponential gating with log-domain max-stabilizers (m_t), per
arXiv:2405.04517.  The mLSTM block's recurrence over the sequence goes
through `kernels.ops.mlstm_scan` (the CUDA kernel on the card, the
sequential plain version on the CPU); its one-token decode step is inline
PyTorch, as in the reference.  The sLSTM recurrence is a Python loop over
time on either device (it is jnp in the reference too, no Pallas kernel).

Training differentiates both: the mLSTM scan through its backward kernel
on the card (`kernels.mlstm_scan.MLSTMScanFn`), the sLSTM loop through
autograd.  Both blocks also take client-stacked weights (leaves ``[N,
...]``, ``x [N, b, S, d]``), the port's form of the reference's vmap over
clients: the products run per client (`layers.mm`), the norms take grouped
``[N, d]`` scales, the mLSTM scan folds the clients into its batch (one
kernel call over ``N·b`` rows) and the sLSTM's recurrent product takes
each client's own ``r_zifo``.  Unstacked weights run the serving code
unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS
from repro_torch.models.layers import (_normal, dense_init, gelu, mm,
                                      per_client, rmsnorm)
from repro_torch.utils.cells import apart, by_cell

F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d: int, n_heads: int, dtype, device=None, lead=()) -> dict:
    """Parameters of one mLSTM block, stacked ``[*lead, ...]``."""
    d_in = 2 * d

    def w(i, o, dt=dtype):
        return dense_init(gen, i, o, dt, device, lead)

    return {
        "w_up": w(d, d_in),
        "w_z": w(d, d_in),
        "w_q": w(d_in, d_in),
        "w_k": w(d_in, d_in),
        "w_v": w(d_in, d_in),
        "w_if": w(d, 2 * n_heads, F32),
        "b_if": torch.zeros((*lead, 2 * n_heads), dtype=F32, device=device),
        "w_down": w(d_in, d),
        "norm_in": torch.ones((*lead, d), dtype=F32, device=device),
        "norm_h": torch.ones((*lead, d_in), dtype=F32, device=device),
    }


def _softplus_log_f(ft):
    """log sigmoid(f~) = -softplus(-f~), in fp32."""
    return -F.softplus(-ft)


def mlstm_block(params: dict, x, n_heads: int, eps: float = 1e-5,
                cell_size=None):
    """Pre-norm mLSTM block with gated output; residual outside.  x ``[B,
    S, d]``, or ``[N, b, S, d]`` on client-stacked weights; ``cell_size``
    (a grid's N, where the client axis folds G cells) runs the block once
    per cell, as `models.mamba.mamba_block`."""
    if apart(x, cell_size):
        return by_cell(lambda p, xc: mlstm_block(p, xc, n_heads, eps),
                       cell_size, params, x)
    *lead, s, d = x.shape
    xn = rmsnorm(x, params["norm_in"], eps)
    u = mm(xn, params["w_up"])
    z = mm(xn, params["w_z"])
    d_in = u.shape[-1]
    hd = d_in // n_heads

    def heads(t):   # clients folded into the scan's batch
        return t.reshape(-1, s, n_heads, hd)

    q, k, v = (heads(mm(u, params["w_q"])), heads(mm(u, params["w_k"])),
               heads(mm(u, params["w_v"])))
    gates = (mm(xn.float(), params["w_if"])
             + per_client(params["b_if"], xn, 1))
    gates = gates.reshape(-1, s, 2, n_heads)
    h = KOPS.mlstm_scan(q, k, v, gates[:, :, 0].contiguous(),
                        gates[:, :, 1].contiguous())
    h = h.reshape(*lead, s, d_in)
    h = rmsnorm(h, params["norm_h"], eps) * F.silu(z)
    return mm(h, params["w_down"])


def mlstm_decode_init(batch: int, n_heads: int, hd: int, device=None,
                      lead=()) -> dict:
    return {"c": torch.zeros((*lead, batch, n_heads, hd, hd), dtype=F32,
                             device=device),
            "n": torch.zeros((*lead, batch, n_heads, hd), dtype=F32,
                             device=device),
            "m": torch.full((*lead, batch, n_heads), -1e30, dtype=F32,
                            device=device)}


def mlstm_block_decode(params, x, state, n_heads: int, eps: float = 1e-5):
    """Single-token step. x: [B, 1, d]."""
    b, _, d = x.shape
    xn = rmsnorm(x, params["norm_in"], eps)
    u = (xn @ params["w_up"])[:, 0]
    z = (xn @ params["w_z"])[:, 0]
    d_in = u.shape[-1]
    hd = d_in // n_heads

    def heads(t):
        return t.reshape(b, n_heads, hd)

    q, k, v = (heads(u @ params["w_q"]), heads(u @ params["w_k"]),
               heads(u @ params["w_v"]))
    k = k.float() / math.sqrt(hd)
    q, v = q.float(), v.float()
    gates = xn[:, 0].float() @ params["w_if"] + params["b_if"]
    it, ft = gates[:, :n_heads], gates[:, n_heads:]
    log_f = _softplus_log_f(ft)
    m_new = torch.maximum(log_f + state["m"], it)
    i = torch.exp(it - m_new)
    f = torch.exp(log_f + state["m"] - m_new)
    c = f[..., None, None] * state["c"] + i[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f[..., None] * state["n"] + i[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, d_in).to(x.dtype)
    h = rmsnorm(h, params["norm_h"], eps) * F.silu(z)[:, None]
    out = h @ params["w_down"]
    return out, {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, d: int, n_heads: int, dtype, device=None, lead=()) -> dict:
    """Parameters of one sLSTM block, stacked ``[*lead, ...]``."""
    hd = d // n_heads
    return {
        "norm_in": torch.ones((*lead, d), dtype=F32, device=device),
        "w_zifo": dense_init(gen, d, 4 * d, F32, device, lead),
        "r_zifo": _normal(gen, (*lead, n_heads, hd, 4 * hd), device)
        / math.sqrt(hd),
        "b_zifo": torch.zeros((*lead, 4 * d), dtype=F32, device=device),
        "norm_h": torch.ones((*lead, d), dtype=F32, device=device),
        # post-recurrence MLP (factor 4/3, GeLU — xLSTM paper)
        "w_up": dense_init(gen, d, (4 * d) // 3, dtype, device, lead),
        "w_down": dense_init(gen, (4 * d) // 3, d, dtype, device, lead),
    }


def _slstm_cell(params, pre_t, c, n, m, h_prev, n_heads: int):
    """One sLSTM step from the input pre-activations ``pre_t`` [B, 4d]
    (fp32) and the recurrent state; returns (c, n, m, h).  On
    client-stacked weights ``pre_t`` is ``[N, b, 4d]`` and the state ``[N,
    b, H, hd]``, each client's rows against its own ``r_zifo [N, H, hd,
    4hd]``."""
    hd = c.shape[-1]
    r = params["r_zifo"]
    rec = torch.einsum("bhk,hko->bho" if r.dim() == 3 else "nbhk,nhko->nbho",
                       h_prev, r)
    zifo = pre_t.reshape(*pre_t.shape[:-1], n_heads, 4 * hd) + rec
    z, i_, f_, o_ = zifo.chunk(4, dim=-1)
    z, o = torch.tanh(z), torch.sigmoid(o_)
    log_f = _softplus_log_f(f_)
    m_new = torch.maximum(log_f + m, i_)
    i = torch.exp(i_ - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    h = o * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h


def slstm_scan(params, xn, n_heads: int):
    """xn: [B, S, d] (already normed), or ``[N, b, S, d]`` on
    client-stacked weights.  Returns h of xn's shape (fp32).

    A Python loop over time on either device: a handful of small launches
    per step on the card (PERF.md: fusing it is later work)."""
    *lead, s, d = xn.shape
    hd = d // n_heads
    pre = (mm(xn.float(), params["w_zifo"])
           + per_client(params["b_zifo"], xn, 1)).to(xn.dtype)
    c = torch.zeros((*lead, n_heads, hd), dtype=F32, device=xn.device)
    n, h = torch.zeros_like(c), torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
    hs = []
    for t in range(s):
        c, n, m, h = _slstm_cell(params, pre[..., t, :].float(), c, n, m, h,
                                 n_heads)
        hs.append(h)
    return torch.stack(hs, dim=-3).reshape(*lead, s, d)


def _slstm_block(params, x, n_heads: int, eps: float):
    xn = rmsnorm(x, params["norm_in"], eps)
    h = slstm_scan(params, xn, n_heads).to(x.dtype)
    h = rmsnorm(h, params["norm_h"], eps)
    y = x + h
    return mm(gelu(mm(y, params["w_up"])), params["w_down"]) + y - x


def slstm_block(params, x, n_heads: int, eps: float = 1e-5, cell_size=None):
    """Returns the block delta; the caller adds the residual x.
    ``cell_size`` as `mlstm_block`'s.  The block uses x three times: on
    client-stacked weights its uses reach x through one node
    (`utils.cells.by_cell`), so x's gradient sums alike whether the
    client axis folds cells or not."""
    if x.dim() == 4:
        return by_cell(lambda p, xc: _slstm_block(p, xc, n_heads, eps),
                       cell_size, params, x)
    return _slstm_block(params, x, n_heads, eps)


def slstm_decode_init(batch: int, n_heads: int, hd: int, device=None,
                      lead=()) -> dict:
    z = torch.zeros((*lead, batch, n_heads, hd), dtype=F32, device=device)
    return {"c": z, "n": z.clone(), "m": torch.full_like(z, -1e30),
            "h": z.clone()}


def slstm_block_decode(params, x, state, n_heads: int, eps: float = 1e-5):
    b, _, d = x.shape
    xn = rmsnorm(x, params["norm_in"], eps)
    pre = xn[:, 0].float() @ params["w_zifo"] + params["b_zifo"]
    c, n, m, h = _slstm_cell(params, pre, state["c"], state["n"], state["m"],
                             state["h"], n_heads)
    hflat = rmsnorm(h.reshape(b, 1, d).to(x.dtype), params["norm_h"], eps)
    y = x + hflat
    out = gelu(y @ params["w_up"]) @ params["w_down"] + y - x
    return out, {"c": c, "n": n, "m": m, "h": h}
