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
fp32, as on the TPU.  One wrapper call is one counted launch.  With
``stats`` either kernel also writes each row's signed sum ``a_t`` (the
denominator before ``max``) and the stabilizer ``m_t`` it used; h is the
same bitwise.

`mlstm_scan_bwd_kernel` is the backward (``csrc/mlstm_scan_bwd.cu``; the
TPU kernel has none, the reference differentiates its jnp recurrence):
the parallel form's gradient with the stabilizer held constant (h does
not depend on it), from the forward's h, ``a_t`` and ``m_t``, bf16 on
`wgmma` fed by TMA (``launches_tc``, four launches a call: the scores form
P' and dS once into a workspace, split into bf16 high and low parts, and
the three products read each live workspace tile once per 64-row output
tile across all of hd; `mlstm_bwd_plan`) and fp32 on the CUDA cores
(``launches_fp32``, six), beside its plain version `mlstm_scan_bwd_plain`.
`MLSTMScanFn` joins the two kernels under autograd.

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

import numpy as np
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


def mlstm_parallel_plain(q, k, v, i_gate, f_gate, *, stats: bool = False):
    """The recurrence's function in the xLSTM paper's parallel form.

    ``h_t = Σ_{s≤t} D_ts S_ts v_s / max(|Σ_{s≤t} D_ts S_ts|, exp(−m_t))``
    with ``S_ts = q_t · k_s / sqrt(hd)`` (k scaled in fp32) and ``D_ts``
    from `mlstm_gate_prefix`; ``P = S ∘ D`` in fp32, its signed row sum the
    denominator, and for bf16 inputs P taken into the PV product as the
    tensor-core kernel takes it: two bf16 parts, ``bf16(P) + bf16(P −
    bf16(P))``.  Returns h ``[B, S, H, hd]`` in q's type, or with ``stats``
    ``(h, a, m)`` as `mlstm_scan_kernel`'s.  Memory grows as S²: for tests
    and checks."""
    b, s, h, hd = q.shape
    _, g, m_run, m = mlstm_gate_prefix(i_gate, f_gate)
    g, m_run, m = (t.permute(0, 2, 1) for t in (g, m_run, m))   # [B, H, S]
    e = (g[:, :, None, :] - m_run[:, :, :, None]).float()      # [B, H, t, s]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    d = torch.exp(e.masked_fill(~causal, float("-inf")))
    kf = k.float() / math.sqrt(hd)
    p = torch.einsum("bthd,bshd->bhts", q.float(), kf) * d
    a = p.sum(-1)                                                # [B, H, t]
    den = torch.maximum(a.abs(), torch.exp(-m))
    if q.dtype == torch.bfloat16:
        hi = p.to(torch.bfloat16).float()
        p = hi + (p - hi).to(torch.bfloat16).float()
    num = torch.einsum("bhts,bshd->bthd", p, v.float())
    out = (num / den.permute(0, 2, 1)[..., None]).to(q.dtype)
    if not stats:
        return out
    return out, a.permute(0, 2, 1).contiguous(), m.permute(0, 2, 1).contiguous()


def mlstm_scan_bwd_plain(q, k, v, i_gate, f_gate, h, a, m, dh):
    """The backward of the parallel form, as ``csrc/mlstm_scan_bwd.cu``
    computes it, in plain torch ops (S² memory): from the forward's h and
    its ``a``, ``m`` (`mlstm_scan_kernel` with ``stats``) and the output
    gradient ``dh``, with the stabilizer m held constant (h does not depend
    on it), ``den_t = max(|a_t|, exp(−m_t))``::

        dN_t = dh_t / den_t,   δ_t = −(dh_t · h_t) / den_t
        da_t = δ_t·sign(a_t) where |a_t| ≥ exp(−m_t), else 0
        dP_ts = dN_t · v_s + da_t,  dS_ts = dP_ts·D_ts,  Q_ts = dP_ts·P_ts
        dq_t = Σ_s dS_ts k̃_s,  dk_s = Σ_t dS_ts q_t / √hd,  dv_s = Σ_t P_ts dN_t
        di_s = Σ_t Q_ts,   df_r = σ(−f_r) · Σ_{s<r≤t} Q_ts

    (a forget gate moves the pairs that straddle it: ``D_ts = exp(i_s +
    F_t − F_s − m_t)``).  D from `mlstm_gate_prefix` in fp64, with M
    shifted by the forward's ``m − float(F + M)`` (0 for the parallel
    form; the fp32 recurrence's rounding otherwise) so D, ``a`` and
    ``exp(−m)`` share one scale; the rest in fp64 (a yardstick for the
    kernel's fp32 arithmetic).  Returns (dq, dk, dv) in q's type and (di,
    df) fp32 ``[B, S, H]``."""
    b, s, nh, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    _, g, m_run, m_pf = mlstm_gate_prefix(i_gate, f_gate)
    mc = m_run + (m.double() - m_pf.double())
    g, mc = (t.permute(0, 2, 1) for t in (g, mc))               # [B, H, S]
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    d = torch.where(causal, torch.exp(
        (g[:, :, None, :] - mc[:, :, :, None]).float()), 0.0).double()
    qf, kf, vf, dhf = (t.double() for t in (q, k, v, dh))
    p = torch.einsum("bthd,bshd->bhts", qf, kf) * scale * d    # [B, H, t, s]
    af = a.permute(0, 2, 1).double()
    floor = torch.exp(-m.permute(0, 2, 1).double())
    inv = 1.0 / torch.maximum(af.abs(), floor)                   # [B, H, t]
    delta = -(dhf * h.double()).sum(-1).permute(0, 2, 1) * inv
    da = torch.where(af.abs() >= floor, torch.where(af > 0, delta, -delta),
                     0.0)
    dp = torch.where(causal, torch.einsum("bthd,bshd->bhts", dhf, vf)
                     * inv[..., None] + da[..., None], 0.0)
    ds = dp * d
    dv = torch.einsum("bhts,bthd->bshd", p * inv[..., None], dhf)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    qq = dp * p
    di = qq.sum(2)                                               # [B, H, s]
    # Σ_{s<r} Q_ts for every (t, r), summed over t ≥ r
    before = torch.where(causal, qq.cumsum(-1) - qq, 0.0)
    df = before.sum(2) * torch.sigmoid(-f_gate.double()).permute(0, 2, 1)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            *(t.permute(0, 2, 1).float().contiguous() for t in (di, df)))


@functools.lru_cache(maxsize=1)
def _symbols():
    lib = build.load("mlstm_scan")
    rec, par = lib.repro_mlstm_scan, lib.repro_mlstm_parallel
    rec.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    par.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    rec.restype = par.restype = ctypes.c_int
    return rec, par


TILE = 64   # keys per tile of the tensor-core kernel (its prefix's padding)


def parallel_workspace_bytes(b: int, s: int, h: int) -> int:
    """Bytes of the tensor-core path's gate prefix: F and M in fp64 and the
    tile-relative exponents in fp32, per (b, h) over S rounded up to a
    tile."""
    return b * h * -(-s // TILE) * TILE * 20


def mlstm_scan_kernel(q, k, v, i_gate, f_gate, *, stats: bool = False):
    """The recurrence's function on the card.  q, k, v contiguous ``[B, S,
    H, hd]``, all fp32 or all bf16 (bf16 16-byte aligned), hd in 32..512 (a
    power of two); gates contiguous fp32 ``[B, S, H]``.  bf16 takes the
    parallel form on the tensor cores, fp32 the recurrence.  Returns a new
    tensor h in q's type, or with ``stats`` ``(h, a, m)``: each row's
    signed sum ``a_t`` (the denominator before ``max``) and the stabilizer
    ``m_t`` it used, fp32 ``[B, S, H]``, for the backward; h is the same
    either way.  Raises on anything else and on a refused launch."""
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
    a = m = None
    if stats:
        a, m = (torch.empty(q.shape[:3], dtype=torch.float32,
                            device=q.device) for _ in range(2))
    if out.numel() == 0:
        return (out, a, m) if stats else out
    rec, par = _symbols()
    ptrs = [t.data_ptr() for t in ts] + [out.data_ptr()]
    extra = [None, None] if a is None else [a.data_ptr(), m.data_ptr()]
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
            err = par(*ptrs, *extra, ws.data_ptr(), b, s, h, hd, scale,
                      raw_stream(index))
    else:
        path = "recurrent"
        with device_scope(index):
            err = rec(*ptrs, *extra, b, s, h, hd, scale, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"mlstm_scan kernel ({path}) launch failed: CUDA "
                           f"error {err} at q{tuple(q.shape)} {q.dtype}")
    fn = mlstm_scan_kernel
    fn.launches += 1
    setattr(fn, f"launches_{path}", getattr(fn, f"launches_{path}") + 1)
    return (out, a, m) if stats else out


@functools.lru_cache(maxsize=1)
def _bwd_symbol():
    fn = build.load("mlstm_scan_bwd").repro_mlstm_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int64] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _bwd_launches_symbol():
    fn = build.load("mlstm_scan_bwd").repro_mlstm_scan_bwd_launches
    fn.argtypes = []
    fn.restype = ctypes.c_int64
    return fn


def bwd_kernel_launches() -> int:
    """The kernel launches ``repro_mlstm_scan_bwd`` has made in this
    process, as its library counts them (each counted once its error
    check passed): the difference across one call is the launches a
    call."""
    return _bwd_launches_symbol()()


def bwd_workspace_bytes(b: int, s: int, h: int) -> int:
    """Bytes of the backward's workspace, per (b, h) over S rounded up to
    64 (sp): fp64 g and M, fp32 1/den, da and the diagonal tiles' sums,
    the tiles' column and row sums of Q (``[sp/64, sp]`` each), then P'
    and dS, 4 bytes an element each: ``[sp, sp]`` fp32 on the fp32 path,
    on the bf16 path its bf16 high part ``[sp, sp]`` followed by its bf16
    low part (what the products' TMA reads)."""
    sp = -(-s // TILE) * TILE
    return b * h * (sp * 28 + 2 * (sp // TILE) * sp * 4 + 2 * sp * sp * 4)


# the bf16 backward's constants (``csrc/mlstm_scan_bwd.cu``), which
# tests/test_torch_mlstm_bwd_plan.py reads back from the source
BWD_WG = 128             # threads a warpgroup
BWD_SC_STAGES = 3        # the scores' ring of 64-dim chunks
BWD_PR_STAGES = 2        # the products' ring of 64-position steps
BWD_GATE_THREADS = 64    # a gates block: one tile's positions
BWD_GATE_STAGE = 8192    # floats of a gates block's stage
BWD_LAUNCHES = {"tc": 4, "fp32": 6}   # launches a call on each path


def mlstm_bwd_plan(b: int, s: int, h: int, hd: int) -> dict:
    """The bf16 backward's launch plan: hd as held in shared memory
    (``hdp``), the products' consumer warpgroups and their N, each
    kernel's threads, shared-memory bytes and grid, and the launches of a
    call."""
    tiles = -(-s // TILE)
    hdp = max(64, hd)
    consumers = 2 if hdp > 256 else 1
    return dict(
        hdp=hdp, consumers=consumers, n=hdp // consumers, tiles=tiles,
        launches=BWD_LAUNCHES["tc"],
        prep_grid=(b * h + -(-(b * s * h) // 8),),
        scores_threads=BWD_WG + 32,
        scores_smem=1024 + BWD_SC_STAGES * (4 * TILE * 128 + 16),
        scores_grid=(tiles * (tiles + 1) // 2, b * h),
        products_threads=consumers * BWD_WG + 32,
        products_smem=1024 + BWD_PR_STAGES * (2 * TILE * 128
                                              + TILE * hdp * 2 + 16),
        products_grid=(3 * b * h, tiles),
        gates_threads=BWD_GATE_THREADS, gates_grid=(tiles, b * h))


def bwd_score_tile(idx: int):
    """The (query tile, key tile) of scores block ``idx``: the kernel's
    ``tri`` (an fp32 square root, then exact integer corrections)."""
    tt = int((float(np.sqrt(np.float32(8 * idx + 1), dtype=np.float32))
              - 1.0) * 0.5)
    while (tt + 1) * (tt + 2) // 2 <= idx:
        tt += 1
    while tt * (tt + 1) // 2 > idx:
        tt -= 1
    return tt, idx - tt * (tt + 1) // 2


def bwd_product_steps(prod: int, rank: int, tiles: int):
    """(output tile, the 64-position steps it walks) of products block
    (``prod``: 0 dV, 1 dK, 2 dQ; ``rank``: 0 the heaviest)."""
    rt = rank if prod < 2 else tiles - 1 - rank
    steps = range(rt, tiles) if prod < 2 else range(0, rt + 1)
    return rt, list(steps)


def mlstm_scan_bwd_kernel(q, k, v, i_gate, f_gate, h, a, m, dh):
    """Kernel 6's backward on the card (``csrc/mlstm_scan_bwd.cu``): what
    `mlstm_scan_bwd_plain` computes, from the forward's inputs, its h and
    its ``a``, ``m`` (`mlstm_scan_kernel` with ``stats``) and ``dh`` (h's
    shape and type, contiguous).  bf16 takes the tensor cores
    (``launches_tc``), fp32 the CUDA cores (``launches_fp32``).  Returns
    (dq, dk, dv, di, df); raises on anything else and on a refused launch.
    One call (`BWD_LAUNCHES` kernel launches) is one counted launch."""
    ts = (q, k, v, i_gate, f_gate, h, a, m, dh)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("mlstm_scan_bwd_kernel takes CUDA tensors on one "
                         "device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, h, dh)) \
            or any(t.dtype != torch.float32 for t in (i_gate, f_gate, a, m)):
        raise ValueError("mlstm_scan_bwd_kernel takes q, k, v, h, dh all "
                         "fp32 or all bf16 and fp32 gates, a and m, got "
                         f"{[str(t.dtype) for t in ts]}")
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, h, dh)) \
            or any(t.shape != q.shape[:3] for t in (i_gate, f_gate, a, m)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} are not "
                         "[B,S,H,hd] x3, [B,S,H] x2, [B,S,H,hd], [B,S,H] x2, "
                         "[B,S,H,hd]")
    b, s, nh, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan_bwd_kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm_scan_bwd_kernel takes contiguous tensors")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, dh)):
        raise ValueError("mlstm_scan_bwd_kernel reads bf16 q, k, v, dh in "
                         "16-byte vectors: their data must be 16-byte "
                         "aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    di, df = (torch.empty_like(i_gate) for _ in range(2))
    if q.numel() == 0:
        return dq, dk, dv, di.zero_(), df.zero_()
    fn = _bwd_symbol()
    ws = torch.empty(bwd_workspace_bytes(b, s, nh), device=q.device,
                     dtype=torch.uint8)
    index = q.device.index
    path = "tc" if q.dtype == torch.bfloat16 else "fp32"
    with device_scope(index):
        err = fn(*(t.data_ptr() for t in ts),
                 *(t.data_ptr() for t in (dq, dk, dv, di, df)),
                 ws.data_ptr(), b, s, nh, hd, 1.0 / math.sqrt(hd),
                 int(path == "tc"), raw_stream(index))
    if err != 0:
        raise RuntimeError(f"mlstm_scan backward ({path}) launch failed: "
                           f"CUDA error {err} at q{tuple(q.shape)} {q.dtype}")
    fn_ = mlstm_scan_bwd_kernel
    fn_.launches += 1
    setattr(fn_, f"launches_{path}", getattr(fn_, f"launches_{path}") + 1)
    return dq, dk, dv, di, df


class MLSTMScanFn(torch.autograd.Function):
    """The mLSTM scan with the hand-written forward (with ``a``, ``m``)
    and backward kernels; ``apply(q, k, v, i_gate, f_gate)``."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate):
        ins = tuple(t.contiguous() for t in (q, k, v, i_gate, f_gate))
        h, a, m = mlstm_scan_kernel(*ins, stats=True)
        ctx.save_for_backward(*ins, h, a, m)
        return h

    @staticmethod
    def backward(ctx, dh):
        return mlstm_scan_bwd_kernel(*ctx.saved_tensors, dh.contiguous())


PATHS = ("tc", "recurrent")
BWD_PATHS = ("tc", "fp32")


def path_launches() -> dict:
    """Launches of each of the two forward kernels since the last reset."""
    return {p: getattr(mlstm_scan_kernel, f"launches_{p}") for p in PATHS}


def bwd_path_launches() -> dict:
    """Backward launches of each instantiation since the last reset."""
    return {p: getattr(mlstm_scan_bwd_kernel, f"launches_{p}")
            for p in BWD_PATHS}


def reset_path_launches() -> None:
    for p in PATHS:
        setattr(mlstm_scan_kernel, f"launches_{p}", 0)
    for p in BWD_PATHS:
        setattr(mlstm_scan_bwd_kernel, f"launches_{p}", 0)


mlstm_scan_kernel.launches = 0
mlstm_scan_bwd_kernel.launches = 0
reset_path_launches()
