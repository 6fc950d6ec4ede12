"""Shapes-only stand-ins for the dry-run on the ``meta`` device.

`launch/dryrun.py` runs a whole step on ``meta`` tensors at published
widths and counts its work (`launch/roofline.py`).  Most ops run their
plain forms there, which only propagate shapes.  Five do not, because
their plain forms would misstate what the card does or take hours on the
host: flash attention's plain form materialises the ``[S, S]`` scores
(kernel 4 never does), the plain decode widens the whole cache to fp32,
the mLSTM scan's plain form is a recurrence of ~60 ops a step, and the
sLSTM and mamba scans are Python loops over time (a 32k prefill is tens
of millions of host ops).  On ``meta`` each of these returns empty
outputs of the right shapes through `stand_in`, an autograd `Function`
that charges the active tallies with the work the card does for it:

- attention (kernel 4, forward and backward), decode (kernel 4's
  split-KV path), the mLSTM scan (kernel 6, forward and backward): the
  kernels' products and the bytes each reads and writes once;
- the sLSTM and mamba loops: each step's recurrent product, and the
  bytes each step reads and writes (the eager loop re-reads its weights
  and state every step).

FLOPs count products only (``2·m·n·k``), as `torch.utils.flop_counter`
does for the ops it sees; a backward's products are counted from the
forward's (2× for a recurrence's, 2.5× for attention's and the mLSTM's:
S recomputed, then dV, dP, dQ, dK).
"""
from __future__ import annotations

import math

import torch

_TALLIES: list = []   # objects with .charge(flops, bytes): active counters


def charge(flops: float, nbytes: float) -> None:
    """Add work done outside any counted op to every active tally."""
    for t in _TALLIES:
        t.charge(flops, nbytes)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class _StandIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cost, outs, *ins):
        fwd_f, fwd_b, ctx.bwd = cost[0], cost[1], cost[2:]
        charge(fwd_f, fwd_b)
        ctx.ins = [(t.shape, t.dtype) if isinstance(t, torch.Tensor) else None
                   for t in ins]
        res = tuple(torch.empty(s, dtype=d, device="meta") for s, d in outs)
        return res if len(res) > 1 else res[0]

    @staticmethod
    def backward(ctx, *grads):
        charge(*ctx.bwd)
        return (None, None, *(None if i is None else
                              torch.empty(i[0], dtype=i[1], device="meta")
                              for i in ctx.ins))


def stand_in(cost, outs, *ins):
    """Empty ``outs`` (``[(shape, dtype), ...]``) on ``meta`` whose
    gradient reaches ``ins``; ``cost`` is (forward FLOPs, forward bytes,
    backward FLOPs, backward bytes), charged when each runs."""
    return _StandIn.apply(tuple(cost), tuple(outs), *ins)


def causal_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a row block of kernel 4 scores: query i sees
    keys j <= i (causal) inside the window, as the kernel's masks."""
    if not causal:
        return sq * sk if not window else sum(
            min(sk, i + window) for i in range(sq))
    w = window if window and window < sk else sk
    n = min(sq, sk)
    full = max(0, n - w)          # rows that see a whole window
    return w * (w + 1) // 2 + full * w if n > w else n * (n + 1) // 2


def _size(t) -> int:
    return t.numel() * t.element_size()


def attention(q, k, v, causal: bool, window: int):
    """Kernel 4 (and its backward) on ``meta``: ``4·B·Hq·pairs·hd`` FLOPs;
    q, k, v read and the output written once."""
    b, sq, hq, hd = q.shape
    pairs = causal_pairs(sq, k.shape[1], causal, window)
    flops = 4.0 * b * hq * pairs * hd
    io = 2 * _size(q) + _size(k) + _size(v)
    return stand_in((flops, io, 2.5 * flops, 2 * io + _size(k) + _size(v)),
                    [(q.shape, q.dtype)], q, k, v)


def decode(q, k_cache, v_cache, k_pos):
    """Kernel 4's decode on ``meta``: every slot of the cache counted
    (``4·B·Hq·C·hd``), the cache and its positions read once."""
    b, _, hq, hd = q.shape
    flops = 4.0 * b * hq * k_cache.shape[1] * hd
    io = 2 * _size(q) + _size(k_cache) + _size(v_cache) + _size(k_pos)
    return stand_in((flops, io, 0.0, 0.0), [(q.shape, q.dtype)], q)


def mlstm_scan(q, k, v, i_gate, f_gate):
    """Kernel 6 (and its backward) on ``meta``: the parallel form's causal
    products, ``4·B·H·S(S+1)/2·hd`` FLOPs."""
    b, s, h, hd = q.shape
    flops = 4.0 * b * h * (s * (s + 1) // 2) * hd
    io = 4 * _size(q) + _size(i_gate) + _size(f_gate)
    return stand_in((flops, io, 2.5 * flops, 2 * io), [(q.shape, q.dtype)],
                    q, k, v, i_gate, f_gate)


def slstm_loop(pre, r, n_heads: int, out_shape):
    """The sLSTM loop on ``meta``: ``pre [..., S, 4d]`` against the
    recurrent weights ``r [(N,) H, hd, 4hd]``; each step's ``[rows, H, hd]
    · [H, hd, 4hd]`` product, and per step the weights read and ~8 fp32
    state tensors of ``[rows, 4d]`` read or written."""
    *lead, s, four_d = pre.shape
    rows, hd = math.prod(lead), four_d // 4 // n_heads
    flops = s * 2.0 * rows * n_heads * hd * 4 * hd
    step = _size(r) + 8 * rows * four_d * 4
    io = _size(pre) + _nbytes(out_shape, torch.float32) + s * step
    return stand_in((flops, io, 2 * flops, 2 * io),
                    [(out_shape, torch.float32)], pre, r)


def mamba_loop(dt, x1, b_mat, c_mat, a, state_dim: int):
    """The selective scan on ``meta``: per step the state's readout
    ``[R, d_in, N] · [R, N, 1]`` and its update, each step reading and
    writing the fp32 state and its two factors (``16·R·d_in·N`` bytes);
    returns ys ``[R, S, d_in]`` in the stream dtype."""
    *lead, s, d_in = dt.shape
    rows = math.prod(lead)
    flops = s * 2.0 * rows * d_in * state_dim
    step = 16 * rows * d_in * state_dim
    io = sum(_size(t) for t in (dt, x1, b_mat, c_mat)) + s * step
    return stand_in((flops, io, 2 * flops, 2 * io),
                    [((rows, s, d_in), dt.dtype)], dt, x1, b_mat, c_mat, a)
