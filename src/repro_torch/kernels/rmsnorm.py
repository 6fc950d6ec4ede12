"""Fused RMSNorm: ``x · rsqrt(mean(x²) + eps) · scale`` per row.

Port of `repro.kernels.rmsnorm` (TPU kernel ``_kernel`` / ``rmsnorm``).
`rmsnorm_kernel` is ``csrc/rmsnorm.cu`` (CUDA C++ for sm_90a): one warp
per row, eight rows per block; each lane walks the row at a stride of 32
(coalesced, with a masked tail for any ``d``), the sum of squares is
taken in fp32 and reduced with warp shuffles, and the row is written as
``x · rsqrt(var + eps)`` times the fp32 scale, cast last — the
reference's order (`repro.models.layers.rmsnorm`).  The TPU kernel held a
256-row block in VMEM; on the card a row of up to a few thousand values
fits one warp's registers and L1, and a row needs no cross-warp state.

What bounds it on the card: memory.  It reads x once and writes it once
(the second pass over the row is served by L1), 2·rows·d·itemsize +
4·d bytes.  At the serving shapes (d = 2048 or 1024 at a few thousand
rows; the qk-norm rows of 128) each call moves a few MB or less, so the
launch itself is a large part of a call; the launch is a plain
``ctypes`` call for that reason (a Triton launch costs ~0.1 ms of host
time and the qwen3 forward runs 113 norms).

`rmsnorm_plain` is the plain PyTorch version (CPU tensors and tests).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x, scale, eps: float = 1e-5):
    """``x: [..., d]``, ``scale: [d]`` -> ``[..., d]`` in x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=1)
def _symbol():
    fn = build.load("rmsnorm").repro_rmsnorm
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_kernel(x, scale, eps: float = 1e-5):
    """RMSNorm on the card.  ``x``: contiguous ``[..., d]`` fp32 or bf16;
    ``scale``: contiguous fp32 ``[d]`` on the same device.  Returns a new
    tensor in x's type; raises on anything else and on a refused launch."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm_kernel takes CUDA tensors on one device, "
                         f"got {x.device} and {scale.device}")
    if x.dtype not in _DTYPES or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm_kernel takes fp32/bf16 x and an fp32 "
                         f"scale, got {x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"last axis of x {tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_kernel takes contiguous tensors")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _symbol()(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        rows, d, eps, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"at x{tuple(x.shape)} {x.dtype}")
    rmsnorm_kernel.launches += 1
    return out


rmsnorm_kernel.launches = 0
