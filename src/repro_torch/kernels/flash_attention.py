"""Flash attention (forward) with GQA, causal / sliding-window and pad masks.

Port of `repro.kernels.flash_attention` (TPU kernel ``_kernel`` /
``flash_attention``).  Shapes: q ``[B, Sq, Hq, hd]``; k, v
``[B, Sk, Hkv, hd]`` with ``Hq % Hkv == 0``; out ``[B, Sq, Hq, hd]`` in q's
type.  Query row ``i`` sits at position ``i`` and key ``j`` at ``j``; a key
counts when ``j < sk_valid`` (default ``Sk``), ``j <= i`` if causal, and
``j > i - window`` if ``window``.  Scores, the online softmax and the PV
sum are fp32, and the output is ``acc / max(l, 1e-30)``, as on the TPU.

`flash_attention_kernel` is ``csrc/flash_attention.cu`` (CUDA C++ for
sm_90a).  On the TPU the KV tiles were the sequential third grid axis,
with (m, l, acc) in VMEM scratch across it; on the card blocks run in no
order, so each block owns one (batch, kv head, tile of 16 query rows) and
loops over the KV tiles itself, with (m, l, acc) in registers; the K/V
tiles move in 16-byte vectors, each thread's loads issued together.  GQA
folds the ``Hq / Hkv`` query heads of one kv head into the block's rows
(row = position · group + head-in-group), so each K/V tile is loaded once
for the whole group and no K/V is copied per head.  KV tiles wholly above
the causal diagonal, wholly below the window, or at or past ``sk_valid``
are skipped (there p = 0 and the correction is 1).

What bounds it: at prefill (Sq = Sk = 512, hd = 128) operations —
4·B·Hq·Sq·Sk·hd/2 FLOPs for the causal half, on the CUDA cores in fp32 in
this first version; at decode (Sq = 1 against the cache) memory — the
K/V cache is read once, 2·B·Sk·Hkv·hd·itemsize bytes.

`flash_attention_plain` is the plain PyTorch version (CPU tensors and
tests): the naive attention with the same masks.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          sk_valid=None):
    """Naive attention with the kernel's masks; fp32 math, out in q's type."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) \
        * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    ok = k_pos < (sk if sk_valid is None else sk_valid)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window:
        ok = ok & (k_pos > q_pos - window)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


@functools.lru_cache(maxsize=1)
def _symbol():
    fn = build.load("flash_attention").repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           sk_valid=None):
    """Attention on the card.  q ``[B, Sq, Hq, hd]``, k/v ``[B, Sk, Hkv,
    hd]``, contiguous (k, v 16-byte aligned), all fp32 or all bf16, hd in
    32/64/128; ``sk_valid`` a Python int in ``[0, Sk]``.  Returns a new
    tensor in q's type; raises on anything else and on a refused launch."""
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention_kernel takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_kernel takes q, k, v all fp32 or "
                         f"all bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} are not [B,Sq,Hq,hd] and "
                         "[B,Sk,Hkv,hd] with Hkv dividing Hq")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_kernel takes contiguous tensors")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention_kernel reads k and v in 16-byte "
                         "vectors: their data must be 16-byte aligned")
    sk_valid = sk if sk_valid is None else int(sk_valid)
    if not 0 <= sk_valid <= sk or window < 0:
        raise ValueError(f"sk_valid {sk_valid} outside [0, {sk}] or window "
                         f"{window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _symbol()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, sq, sk, hq, hkv, hd, int(causal),
                        int(window), sk_valid, 1.0 / math.sqrt(hd),
                        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {q.dtype}")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
