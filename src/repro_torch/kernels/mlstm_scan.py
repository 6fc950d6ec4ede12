"""The stabilized mLSTM recurrence (xLSTM matrix memory) over a sequence.

Port of `repro.kernels.mlstm_scan` (TPU kernel ``_kernel`` /
``mlstm_scan``).  q, k, v ``[B, S, H, hd]`` (fp32 or bf16), gate
pre-activations ``[B, S, H]`` (fp32) -> h ``[B, S, H, hd]`` in q's type;
the state C ``[hd, hd]``, n ``[hd]``, m per (b, h) starts empty (0, 0,
-1e30), and every step's math is fp32.

`mlstm_scan_kernel` is ``csrc/mlstm_scan.cu`` (CUDA C++ for sm_90a).  The
TPU kept each (b, h)'s whole state in VMEM; at xlstm-350m's hd = 512, C is
1 MiB of fp32, more than one SM holds.  The rows of C are independent and
only ``den = max(|n · q_t|, exp(-m))`` is shared, so the kernel splits the
rows of C across warps (4 rows each, in registers), and every warp keeps
its own n and m and walks all S steps; k is scaled by ``1/sqrt(hd)`` in
fp32 after the load, as on the TPU.  What bounds it is the sequential
chain of S steps (per step 5·hd² + 5·hd flops per (b, h) on a state that
never leaves the chip: a multiply and an FMA per element of C, with
``i·v`` taken once per row, and an FMA per element for ``C·q``), not bytes
or peak flops.

`mlstm_scan_plain` is the plain PyTorch version (CPU tensors and tests):
the sequential recurrence of the reference's `repro.models.ssm.mlstm_scan_ref`
(also `repro_torch.kernels.ref.mlstm_scan_ref`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128, 256, 512)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=1)
def _symbol():
    fn = build.load("mlstm_scan").repro_mlstm_scan
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def mlstm_scan_kernel(q, k, v, i_gate, f_gate):
    """The recurrence on the card.  q, k, v contiguous ``[B, S, H, hd]``,
    all fp32 or all bf16, hd in 32..512 (a power of two); gates contiguous
    fp32 ``[B, S, H]``.  Returns a new tensor in q's type; raises on
    anything else and on a refused launch."""
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _symbol()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        i_gate.data_ptr(), f_gate.data_ptr(), out.data_ptr(),
                        b, s, h, hd, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
                        stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err} at q{tuple(q.shape)} {q.dtype}")
    mlstm_scan_kernel.launches += 1
    return out


mlstm_scan_kernel.launches = 0
