"""Flash attention (forward) with GQA, causal / sliding-window and pad masks.

Port of `repro.kernels.flash_attention` (TPU kernel ``_kernel`` /
``flash_attention``).  Shapes: q ``[B, Sq, Hq, hd]``; k, v
``[B, Sk, Hkv, hd]`` with ``Hq % Hkv == 0``; out ``[B, Sq, Hq, hd]`` in q's
type.  Query row ``i`` sits at position ``i`` and key ``j`` at ``j``; a key
counts when ``j < sk_valid`` (default ``Sk``), ``j <= i`` if causal, and
``j > i - window`` if ``window``.  Scores, the online softmax and the PV
sum accumulate in fp32 (the bf16 prefill rounds P to bf16 for the PV
product, below), and the output is ``acc / max(l, 1e-30)``, as on the
TPU.

`flash_attention_kernel` is ``csrc/flash_attention.cu`` (CUDA C++ for
sm_90a).  On the TPU the KV tiles were the sequential third grid axis,
with (m, l, acc) in VMEM scratch across it; on the card blocks run in no
order, so each block owns one (batch, kv head, tile of GQA-folded query
rows) and loops over the KV tiles itself.  GQA folds the ``Hq / Hkv``
query heads of one kv head into the block's rows (row = position · group
+ head-in-group), so each K/V tile is loaded once for the whole group and
no K/V is copied per head.  KV tiles wholly above the causal diagonal,
wholly below the window, or at or past ``sk_valid`` are skipped.  The
wrapper picks one of three kernels by the inputs, and counts each path:

- bf16 with ``Sq > 1`` (prefill) — the tensor-core kernel
  (``launches_tc``): 128 folded rows a block in two warpgroups, K/V tiles
  of 64 keys through a cp.async ring, ``S = QKᵀ`` and ``O += PV`` as
  ``wgmma`` with fp32 accumulators, the online softmax on the accumulator
  fragments.  P is rounded to bf16 for the PV product (about 2⁻⁹
  relative, the one departure from the TPU kernel, which kept P fp32;
  inside the bf16 bar 2e-2).  hd 32 and 96 sit zero-padded to 64 and
  128 dims in shared memory.  Bound: bytes at qwen3's prefill shape,
  operations (989 TFLOP/s) at longer ones.
- ``Sq == 1`` (decode), fp32 or bf16 — split-KV (``launches_split_kv``):
  the valid keys are cut into `decode_splits` chunks so that the grid
  fills the card; each block writes its unnormalised (m, l, acc) to an
  fp32 workspace and a combine kernel merges the chunks in a fixed order
  (bitwise repeatable).  P stays fp32.  Bound: bytes (the valid cache
  rows read once).
- fp32 with ``Sq > 1`` — the CUDA-core kernel (``launches_fp32``): fp32
  products have no tensor-core form without TF32, which the port's fp32
  parity rule excludes.

The training forward asks the prefill kernels for each row's fp32
log-sum-exp ``lse [B, Hq, Sq]`` (``m + log l`` at finalize, in both the
tensor-core and the fp32 kernel); serving does not, and its launches are
unchanged.  The backward (`flash_attention_bwd_kernel`,
``csrc/flash_attention_bwd.cu``) recomputes ``P = exp(scale·QKᵀ − lse)``
tile by tile and returns dQ, dK, dV: ``D = rowsum(dO∘O)``, a dK/dV kernel
with one block per (batch, kv head, key tile) that loops over the group's
q heads and the live Q tiles (GQA's sum inside the block), and a dQ kernel
with one block per (batch, q head, row tile); bf16 on the tensor cores
(``mma.sync``, fp32 accumulators, P and dS rounded to bf16 for the three
products), fp32 on the CUDA cores in fp32; no atomics (bitwise
repeatable).  One call
(three launches) counts one launch.  ``sk_valid`` stays decode-only: the
backward refuses it.  `FlashAttentionFn` is the autograd `Function`
(forward: the kernel with ``lse``; backward: this kernel), which
`kernels.ops.flash_attention` takes when an input requires grad.

`flash_attention_plain` is the plain PyTorch version (CPU tensors and
tests): the naive attention with the same masks; `flash_attention_bwd_plain`
the backward's formula in plain torch ops (tests).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _visible(sq: int, sk: int, causal: bool, window: int, sk_valid, device):
    """[Sq, Sk] bool: key j counts for query i."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = k_pos < (sk if sk_valid is None else sk_valid)
    if causal:
        ok = ok & (k_pos <= q_pos)
    if window:
        ok = ok & (k_pos > q_pos - window)
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          sk_valid=None, lse: bool = False):
    """Naive attention with the kernel's masks; fp32 math, out in q's type
    (and, with ``lse``, each row's fp32 log-sum-exp ``[B, Hq, Sq]``)."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) \
        * (1.0 / math.sqrt(hd))
    ok = _visible(sq, sk, causal, window, sk_valid, q.device)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    return (out, torch.logsumexp(scores, dim=-1)) if lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0):
    """The backward's formula in plain torch ops, fp32: ``P = exp(scale·
    QKᵀ − lse)`` (0 where masked), ``D = rowsum(dO∘O)``, ``dV = Pᵀ dO``,
    ``dS = P∘(dO Vᵀ − D)``, ``dQ = scale·dS K``, ``dK = scale·dSᵀ Q``, the
    GQA group summed; returns (dq, dk, dv) in the inputs' type."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qf, dof, of = q.float(), do.float(), o.float()
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    ok = _visible(sq, sk, causal, window, None, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dvec = (dof * of).sum(dim=-1).transpose(1, 2)           # [B, Hq, Sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def fold(t):   # the GQA group's heads summed onto their kv head
        return t.reshape(b, sk, hkv, g, hd).sum(dim=3)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


DECODE_TILE = 32      # keys per tile of the split-KV kernel
H100_SMS = 132


def decode_rows(group: int) -> int:
    """Query rows of one GQA group that a split-KV block takes (2 or 8)."""
    return 2 if group <= 2 else 8


def decode_splits(lanes: int, kv_end: int, sms: int = H100_SMS):
    """(splits, chunk) of the split-KV decode: the valid keys ``[0,
    kv_end)`` of each of ``lanes`` (batch × kv head × row group) are cut
    into ``splits`` chunks of ``chunk`` keys, a multiple of the 32-key
    tile, every chunk holding at least one valid key, so that
    ``lanes · splits`` fills ``sms`` SMs at least twice where the keys
    allow it."""
    if kv_end <= 0:
        return 1, DECODE_TILE
    tiles = -(-kv_end // DECODE_TILE)
    want = max(1, min(-(-2 * sms // max(lanes, 1)), tiles))
    chunk = tiles // want * DECODE_TILE      # at least `want` splits
    return -(-kv_end // chunk), chunk


@functools.lru_cache(maxsize=None)
def _decode_plan(b: int, hkv: int, group: int, kv_end: int, index: int):
    """(rows, splits, chunk) of the split-KV decode on card ``index``."""
    rows = decode_rows(group)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return (rows, *decode_splits(b * hkv * -(-group // rows), kv_end, sms))


@functools.lru_cache(maxsize=1)
def _symbols():
    lib = build.load("flash_attention")
    simt, tc, dec = (lib.repro_flash_attention, lib.repro_flash_attention_tc,
                     lib.repro_flash_decode)
    simt.argtypes = tc.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int64] * 9
                                   + [ctypes.c_float, ctypes.c_void_p,
                                      ctypes.c_void_p])
    dec.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    for fn in (simt, tc, dec):
        fn.restype = ctypes.c_int
    return simt, tc, dec


def _check(q, k, v, name: str):
    """(b, sq, hq, hd, sk, hkv) of a kernel call; raises on what the
    kernels do not take."""
    dev, dt = q.device, q.dtype
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name} takes CUDA tensors on one "
                         f"device, got {dev}, {k.device}, {v.device}")
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise ValueError(f"{name} takes q, k, v all fp32 or "
                         f"all bf16, got {dt}, {k.dtype}, {v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape or ks[0] != qs[0] \
            or ks[3] != qs[3] or qs[2] % ks[2] != 0:
        raise ValueError(f"shapes q{tuple(qs)} k{tuple(ks)} "
                         f"v{tuple(v.shape)} are not [B,Sq,Hq,hd] and "
                         "[B,Sk,Hkv,hd] with Hkv dividing Hq")
    if qs[3] not in HEAD_DIMS:
        raise ValueError(f"{name} takes hd in {HEAD_DIMS}, got {qs[3]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"{name} reads q, k and v in 16-byte vectors: "
                         "their data must be 16-byte aligned")
    return (*qs, ks[1], ks[2])


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           sk_valid=None, lse: bool = False):
    """Attention on the card.  q ``[B, Sq, Hq, hd]``, k/v ``[B, Sk, Hkv,
    hd]``, contiguous and 16-byte aligned, all fp32 or all bf16, hd in
    32/64/96/128; ``sk_valid`` a Python int in ``[0, Sk]``.  Returns a new
    tensor in q's type — with ``lse`` (prefill only), ``(out, lse)``, the
    rows' fp32 log-sum-exp ``[B, Hq, Sq]`` — and raises on anything else
    and on a refused launch.  One call is one counted launch
    (``launches``), and one of the path counts ``launches_tc``,
    ``launches_split_kv``, ``launches_fp32``."""
    b, sq, hq, hd, sk, hkv = _check(q, k, v, "flash_attention_kernel")
    dt = q.dtype
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    sk_valid = sk if sk_valid is None else int(sk_valid)
    if not 0 <= sk_valid <= sk or window < 0:
        raise ValueError(f"sk_valid {sk_valid} outside [0, {sk}] or window "
                         f"{window} < 0")
    if lse and sq == 1:
        raise ValueError("flash_attention_kernel writes lse on the prefill "
                         "paths (Sq > 1) only")
    out = torch.empty_like(q)
    lse_t = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if lse else None
    if out.numel() == 0:
        return (out, lse_t) if lse else out
    lp = lse_t.data_ptr() if lse else None
    simt, tc, dec = _symbols()
    scale = 1.0 / math.sqrt(hd)
    fn = flash_attention_kernel
    index = q.device.index
    with device_scope(index):
        stream = raw_stream(index)
        if sq == 1:
            path = "split_kv"
            kv_end = min(sk_valid, 1) if causal else sk_valid
            rows, splits, chunk = _decode_plan(b, hkv, hq // hkv, kv_end,
                                               index)
            ws = torch.empty(b * hq * splits * (hd + 2), device=q.device,
                             dtype=torch.float32)
            err = dec(qp, kp, vp, out.data_ptr(), ws.data_ptr(), b, sk, hq,
                      hkv, hd, kv_end, splits, chunk, rows, scale, _DTYPES[dt],
                      stream)
        elif dt == torch.bfloat16:
            path = "tc"
            err = tc(qp, kp, vp, out.data_ptr(), b, sq, sk, hq, hkv, hd,
                     int(causal), int(window), sk_valid, scale, lp, stream)
        else:
            path = "fp32"
            err = simt(qp, kp, vp, out.data_ptr(), b, sq, sk, hq, hkv, hd,
                       int(causal), int(window), sk_valid, scale, lp, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({path}) launch failed: "
                           f"CUDA error {err} at q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {q.dtype}")
    fn.launches += 1
    if path == "split_kv":
        fn.launches_split_kv += 1
    elif path == "tc":
        fn.launches_tc += 1
    else:
        fn.launches_fp32 += 1
    return (out, lse_t) if lse else out


@functools.lru_cache(maxsize=1)
def _bwd_symbol():
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_kernel(q, k, v, o, lse, do, *, causal: bool = True,
                               window: int = 0):
    """dQ, dK, dV on the card from the forward's ``o`` and ``lse`` and the
    output gradient ``do`` (q's shape and type).  Takes what the forward
    takes, without ``sk_valid``; raises on anything else and on a refused
    launch.  One call (three launches) is one counted launch."""
    b, sq, hq, hd, sk, hkv = _check(q, k, v, "flash_attention_bwd_kernel")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or not (o.is_contiguous()
                                           and do.is_contiguous()) \
            or (o.data_ptr() | do.data_ptr()) % 16:
        raise ValueError("o and do must be contiguous, 16-byte aligned, "
                         "of q's shape and type")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{b}, {hq}, {sq}]")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    ws = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    index = q.device.index
    with device_scope(index):
        err = _bwd_symbol()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, hd,
            int(causal), int(window), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], raw_stream(index))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err} at q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {q.dtype}")
    flash_attention_bwd_kernel.launches += 1
    return dq, dk, dv


flash_attention_bwd_kernel.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the hand-written forward (with ``lse``) and backward
    kernels; ``apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_kernel(q, k, v, causal=causal,
                                          window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_kernel(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


PATHS = ("tc", "split_kv", "fp32")


def path_launches() -> dict:
    """Launches of each of the three kernels since the last reset."""
    return {p: getattr(flash_attention_kernel, f"launches_{p}")
            for p in PATHS}


def reset_path_launches() -> None:
    for p in PATHS:
        setattr(flash_attention_kernel, f"launches_{p}", 0)


flash_attention_kernel.launches = 0
reset_path_launches()
