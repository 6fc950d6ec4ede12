"""The stabilized mLSTM recurrence (xLSTM matrix memory) over a sequence.

Port of `repro.kernels.mlstm_scan` (TPU kernel ``_kernel`` /
``mlstm_scan``).  q, k, v ``[B, S, H, hd]`` (fp32 or bf16), gate
pre-activations ``[B, S, H]`` (fp32) -> h ``[B, S, H, hd]`` in q's type;
the state C ``[hd, hd]``, n ``[hd]``, m per (b, h) starts empty (0, 0,
-1e30), and every step's math is fp32.

`mlstm_scan_kernel` is ``csrc/mlstm_scan.cu`` (CUDA C++ for sm_90a), two
kernels picked by type, each with its launch count:

- bf16 (``launches_tc``, the serving path): the xLSTM paper's parallel
  form on `wgmma`.  The stabilizer m_t of the recurrence follows from the
  gates alone (`mlstm_gate_prefix`), so h is causal attention with weights
  ``D_ts = exp(i_s + F_t − F_s − m_t)`` and denominator ``max(|Σ P|,
  exp(−m_t))``: a prefix kernel scans the gates in fp64, a tile kernel
  runs S = QKᵀ and O += PV as bf16 products with fp32 accumulators, P in
  PV as two bf16 parts (high and low, about 2⁻¹⁷ relative: P rounded once
  to bf16 misses the bar where the denominator cancels).  Bound: bytes at S = 512
  (4·hd flops per causal pair; it overtakes the recurrence's 5·hd² a step
  once S > 2.5·hd).
- fp32 (``launches_recurrent``, the fp32 parity paths): the recurrence,
  the rows of C split across warps (4 rows each, in registers); every
  warp keeps its own n and m and walks all S steps.  What bounds it is
  the sequential chain of S steps (5·hd² + 5·hd flops per step and (b,
  h) on a state that never leaves the chip), not bytes or peak flops.

The TPU kept each (b, h)'s whole state C (1 MiB of fp32 at hd = 512) in
VMEM; neither form keeps it on the card.  k is scaled by ``1/sqrt(hd)`` in
fp32, as on the TPU.  One wrapper call is one counted launch.

`mlstm_scan_plain` is the plain PyTorch version (CPU tensors, tests and
the card's checks): the sequential recurrence of the reference's
`repro.models.ssm.mlstm_scan_ref` (also
`repro_torch.kernels.ref.mlstm_scan_ref`).  `mlstm_parallel_plain` is the
parallel form in plain PyTorch, with the tensor-core kernel's roundings
(fp64 prefix, fp32 P, P as two bf16 parts in PV with bf16 inputs), held against
the reference on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream

HEAD_DIMS = (32, 64, 128, 256, 512)
_DTYPES = (torch.float32, torch.bfloat16)


def mlstm_scan_plain(q, k, v, i_gate, f_gate):
    """Sequential stabilized mLSTM recurrence, one step per time index.

    Returns h ``[B, S, H, hd]`` in q's type; ``k`` is scaled in fp32, as
    the reference's ``k / np.sqrt(hd)`` promotes a bf16 k to fp32.
    """
    b, s, h, hd = q.shape
    kf = k.float() / math.sqrt(hd)
    c = q.new_zeros((b, h, hd, hd), dtype=torch.float32)
    n = q.new_zeros((b, h, hd), dtype=torch.float32)
    m = q.new_full((b, h), -1e30, dtype=torch.float32)
    out = []
    for t in range(s):
        qt, kt, vt = q[:, t].float(), kf[:, t], v[:, t].float()
        it, ft = i_gate[:, t].float(), f_gate[:, t].float()
        log_f = -F.softplus(-ft)
        m_new = torch.maximum(log_f + m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(log_f + m - m_new)
        c = f[..., None, None] * c + i[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f[..., None] * n + i[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", c, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m_new))
        out.append((num / den[..., None]).to(q.dtype))
        m = m_new
    return torch.stack(out, dim=1)


def mlstm_gate_prefix(i_gate, f_gate, dtype=torch.float64):
    """The gates' prefix of the parallel form, per (b, h) along S.

    ``F_t = Σ_{r≤t} log σ(f_r)`` (log σ in fp32, as the recurrence takes
    it, summed in ``dtype``), ``g_s = i_s − F_s`` and ``M_t = max(−1e30,
    max_{s≤t} g_s)``, all ``[B, S, H]`` in ``dtype``, and the recurrence's
    stabilizer ``m_t = max(log σ(f_t) + m_{t−1}, i_t) = F_t + M_t`` in
    fp32.  ``D_ts = exp(i_s + F_t − F_s − m_t) = exp(g_s − M_t)``.  F runs
    into the hundreds over a few hundred steps, so ``g_s − M_t`` cancels two
    large terms: taken in fp64 and rounded after the subtraction it is
    exact to fp32; an fp32 cumsum (``dtype=torch.float32``) is off by
    several ulps of F."""
    log_f = -F.softplus(-f_gate.float())
    f_cum = torch.cumsum(log_f.to(dtype), dim=1)
    g = i_gate.to(dtype) - f_cum
    m_run = torch.clamp(torch.cummax(g, dim=1).values, min=-1e30)
    return f_cum, g, m_run, (f_cum + m_run).float()


def mlstm_parallel_plain(q, k, v, i_gate, f_gate):
    """The recurrence's function in the xLSTM paper's parallel form.

    ``h_t = Σ_{s≤t} D_ts S_ts v_s / max(|Σ_{s≤t} D_ts S_ts|, exp(−m_t))``
    with ``S_ts = q_t · k_s / sqrt(hd)`` (k scaled in fp32) and ``D_ts``
    from `mlstm_gate_prefix`; ``P = S ∘ D`` in fp32, its signed row sum the
    denominator, and for bf16 inputs P taken into the PV product as the
    tensor-core kernel takes it: two bf16 parts, ``bf16(P) + bf16(P −
    bf16(P))``.  Returns h ``[B, S, H, hd]``
    in q's type.  Memory grows as S²: for tests and checks."""
    b, s, h, hd = q.shape
    _, g, m_run, m = mlstm_gate_prefix(i_gate, f_gate)
    g, m_run, m = (t.permute(0, 2, 1) for t in (g, m_run, m))   # [B, H, S]
    e = (g[:, :, None, :] - m_run[:, :, :, None]).float()      # [B, H, t, s]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    d = torch.exp(e.masked_fill(~causal, float("-inf")))
    kf = k.float() / math.sqrt(hd)
    p = torch.einsum("bthd,bshd->bhts", q.float(), kf) * d
    den = torch.maximum(p.sum(-1).abs(), torch.exp(-m))          # [B, H, t]
    if q.dtype == torch.bfloat16:
        hi = p.to(torch.bfloat16).float()
        p = hi + (p - hi).to(torch.bfloat16).float()
    num = torch.einsum("bhts,bshd->bthd", p, v.float())
    return (num / den.permute(0, 2, 1)[..., None]).to(q.dtype)


@functools.lru_cache(maxsize=1)
def _symbols():
    lib = build.load("mlstm_scan")
    rec, par = lib.repro_mlstm_scan, lib.repro_mlstm_parallel
    rec.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    par.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    rec.restype = par.restype = ctypes.c_int
    return rec, par


TILE = 64   # keys per tile of the tensor-core kernel (its prefix's padding)


def parallel_workspace_bytes(b: int, s: int, h: int) -> int:
    """Bytes of the tensor-core path's gate prefix: F and M in fp64 and the
    tile-relative exponents in fp32, per (b, h) over S rounded up to a
    tile."""
    return b * h * -(-s // TILE) * TILE * 20


def mlstm_scan_kernel(q, k, v, i_gate, f_gate):
    """The recurrence's function on the card.  q, k, v contiguous ``[B, S,
    H, hd]``, all fp32 or all bf16 (bf16 16-byte aligned), hd in 32..512 (a
    power of two); gates contiguous fp32 ``[B, S, H]``.  bf16 takes the
    parallel form on the tensor cores, fp32 the recurrence.  Returns a new
    tensor in q's type; raises on anything else and on a refused launch."""
    ts = (q, k, v, i_gate, f_gate)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("mlstm_scan_kernel takes CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or i_gate.dtype != torch.float32 \
            or f_gate.dtype != torch.float32:
        raise ValueError("mlstm_scan_kernel takes q, k, v all fp32 or all "
                         "bf16 and fp32 gates, got "
                         f"{[str(t.dtype) for t in ts]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape \
            or i_gate.shape != q.shape[:3] or f_gate.shape != q.shape[:3]:
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} are not "
                         "[B,S,H,hd] x3 and [B,S,H] x2")
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan_kernel takes hd in {HEAD_DIMS}, got "
                         f"{hd}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm_scan_kernel takes contiguous tensors")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rec, par = _symbols()
    ptrs = [t.data_ptr() for t in ts] + [out.data_ptr()]
    scale = 1.0 / math.sqrt(hd)
    index = q.device.index
    if q.dtype == torch.bfloat16:
        if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[5]) % 16:
            raise ValueError("mlstm_scan_kernel reads bf16 q, k, v and "
                             "writes h in 16-byte vectors: their data must "
                             "be 16-byte aligned")
        path = "tc"
        ws = torch.empty(parallel_workspace_bytes(b, s, h), device=q.device,
                         dtype=torch.uint8)
        with device_scope(index):
            err = par(*ptrs, ws.data_ptr(), b, s, h, hd, scale,
                      raw_stream(index))
    else:
        path = "recurrent"
        with device_scope(index):
            err = rec(*ptrs, b, s, h, hd, scale, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"mlstm_scan kernel ({path}) launch failed: CUDA "
                           f"error {err} at q{tuple(q.shape)} {q.dtype}")
    fn = mlstm_scan_kernel
    fn.launches += 1
    setattr(fn, f"launches_{path}", getattr(fn, f"launches_{path}") + 1)
    return out


PATHS = ("tc", "recurrent")


def path_launches() -> dict:
    """Launches of each of the two kernels since the last reset."""
    return {p: getattr(mlstm_scan_kernel, f"launches_{p}") for p in PATHS}


def reset_path_launches() -> None:
    for p in PATHS:
        setattr(mlstm_scan_kernel, f"launches_{p}", 0)


mlstm_scan_kernel.launches = 0
reset_path_launches()
