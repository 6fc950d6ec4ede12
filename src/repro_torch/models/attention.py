"""GQA attention: naive, blockwise (online-softmax), decode.  Port of
`repro.models.attention`.

Shapes: q [B, S, Hq, hd]; k, v [B, S, Hkv, hd] with Hq % Hkv == 0.
`naive_attention`, `blockwise_attention` and `decode_attention_plain` are
the reference's jnp forms in plain PyTorch.  The model calls `attention`
(prefill / full forward) and `decode_attention` (one token against the
cache), which go through `kernels.ops.flash_attention`: the CUDA kernel on
the card, its plain version on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as KOPS

NEG_INF = -1e30
BLOCK_KV = 1024


def _expand_kv(k, n_rep: int):
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """[Sq, Sk] additive bias from causal + sliding-window constraints."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = torch.where(k_pos[None, :] > q_pos[:, None], NEG_INF, m)
    if window:
        m = torch.where(k_pos[None, :] <= q_pos[:, None] - window, NEG_INF, m)
    return m


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Reference attention; materializes the [Sq, Sk] score matrix."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    k = _expand_kv(k, hq // hkv)
    v = _expand_kv(v, hq // hkv)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)[None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def blockwise_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                        block_kv: int = BLOCK_KV):
    """Online-softmax attention, walking KV in blocks (O(Sq*block) memory)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hq, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, hd), device=q.device)
    for k0 in range(0, sk, block_kv):
        kblk = _expand_kv(k[:, k0:k0 + block_kv], n_rep).float()
        vblk = _expand_kv(v[:, k0:k0 + block_kv], n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk) * scale
        k_pos = torch.arange(k0, k0 + kblk.shape[1], device=q.device)
        s = s + _mask_bias(q_pos, k_pos, causal, window)[None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0):
    """Full-sequence attention through `kernels.ops.flash_attention`."""
    return KOPS.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention_plain(q, k_cache, v_cache, k_pos, cur_pos, *, window=0):
    """Single-token decode: q [B, 1, Hq, hd] against a (possibly ring)
    cache [B, C, Hkv, hd], masked by the positions stored in the cache.

    ``k_pos`` [B, C]: absolute position stored in each cache slot (-1 =
    empty).  ``cur_pos`` [B]: position of the query token (its k/v already
    written).  Products of the working type accumulate in fp32; the
    probabilities are rounded to the cache's type before the PV product,
    as in the reference.
    """
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    n_rep = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, 1, hkv, n_rep, hd).float()
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_cache.float()) * scale
    valid = (k_pos >= 0) & (k_pos <= cur_pos[:, None])
    if window:
        valid = valid & (k_pos > cur_pos[:, None] - window)
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype).float()
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, k_pos, cur_pos, *, window=0,
                     kv_len=None):
    """Decode attention of one token against the cache.

    On the CPU this is `decode_attention_plain`, for any cache.  On the card
    it is the flash kernel with ``sk_valid = kv_len``: that equals the
    plain form when every sequence of the batch sits at the same position
    ``kv_len - 1``, the cache was filled from slot 0 in order and has not
    wrapped (``kv_len <= C``), and there is no window — as on the serving
    path, where the cache holds prompt + generated tokens.  ``kv_len`` is
    that host-side count (None when the positions differ).  Any other
    cache on the card raises `NotImplementedError` (ROADMAP queue 2).
    """
    if not KOPS._on_card(q):
        return decode_attention_plain(q, k_cache, v_cache, k_pos, cur_pos,
                                      window=window)
    c_len = k_cache.shape[1]
    if window or kv_len is None or not 0 < kv_len <= c_len:
        raise NotImplementedError(
            "decode attention on the card takes a cache filled in order "
            "from slot 0, not wrapped, with no window and one position for "
            f"the whole batch (window={window}, kv_len={kv_len}, cache "
            f"{c_len}); ring and per-sequence caches are ROADMAP queue 2")
    return KOPS.flash_attention(q, k_cache, v_cache, causal=False,
                                sk_valid=kv_len)
