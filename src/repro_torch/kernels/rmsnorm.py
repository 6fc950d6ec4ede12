"""Fused RMSNorm: ``x · rsqrt(mean(x²) + eps) · scale`` per row.

Port of `repro.kernels.rmsnorm` (TPU kernel ``_kernel`` / ``rmsnorm``).
`rmsnorm_kernel` is ``csrc/rmsnorm.cu`` (CUDA C++ for sm_90a).  Each row
is read from device memory once: a thread holds its part of the row in
registers from the sum of squares (fp32, reduced by warp shuffles and,
for a row spread over several warps, once through shared memory) to the
write of ``x · rsqrt(var + eps)`` times the fp32 scale, cast last — the
reference's order (`repro.models.layers.rmsnorm`).  Loads and stores are
16-byte vectors where ``d`` and the pointers allow it, single elements
otherwise (``d = 50``).  `rmsnorm_plan` picks the threads a row and the
rows a block from the row count and ``d``: two vectors a thread where rows
are thousands (prefill's rows of 2048: 4 warps a row; the qk-norms' rows
of 128: 8 threads a row), one vector a thread where they are few
(decode's 8 rows of 2048: 8 warps a row), so that the rows reach more
SMs.  The TPU kernel held a 256-row block in
VMEM; on the card a row needs no state beyond its block.

What bounds it on the card: memory, 2·rows·d·itemsize + 4·d bytes.  At
the serving shapes a call moves a few MB or less, so the host's launch
path is as long as the kernel: the wrapper checks only what the kernel
needs, allocates once, caches the plan and the ``ctypes`` symbol, reads
the raw stream handle and enters no device context when the card is
current (`launch`).  One call is one launch; the qwen3 forward runs 113.

`rmsnorm_plain` is the plain PyTorch version (CPU tensors and tests).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x, scale, eps: float = 1e-5):
    """``x: [..., d]``, ``scale: [d]`` -> ``[..., d]`` in x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


THREADS_TO_FILL = 132 * 128   # a quarter of the H100's resident threads
MAX_VECS = 8                  # vectors a thread holds in registers


@functools.lru_cache(maxsize=None)
def rmsnorm_plan(rows: int, d: int, itemsize: int, aligned: bool = True):
    """(vec, tpr, nv, rpb) of the kernel for ``rows`` rows of ``d``
    elements of ``itemsize`` bytes: elements a load (a 16-byte vector
    where ``d · itemsize % 16 == 0`` and the pointers are ``aligned``, else
    1), threads a row (a power of two, 1..1024), vectors a thread holds
    (1, 2, 4, 8, or 0 where the row is too wide and is read twice) and rows
    a block (one row, or one warp of rows).

    A row takes a thread for every two vectors (up to 1024 threads); while
    the rows together take fewer than `THREADS_TO_FILL` threads, a row is
    spread over twice as many, up to one vector a thread.  Two vectors a
    thread and small blocks are what the card measured fastest at the
    serving shapes (`repro_torch.rmsnorm_ablation`: a warp holding a row
    of 2048 bf16 in 8 vectors a thread took 1.8x as long)."""
    vec = 16 // itemsize if aligned and d * itemsize % 16 == 0 else 1
    nvec = d // vec
    tpr = min(1024, 1 << (-(-nvec // 2) - 1).bit_length())
    while rows * tpr < THREADS_TO_FILL and tpr < min(nvec, 1024):
        tpr *= 2
    per = -(-nvec // tpr)
    nv = 0 if per > MAX_VECS else 1 << (per - 1).bit_length()
    return vec, tpr, nv, max(1, 32 // tpr)


def plan_code(dtype: int, vec: int, tpr: int, nv: int, rpb: int) -> int:
    """The type (0 fp32, 1 bf16) and a plan packed into the one int the
    kernel's entry point takes (``csrc/rmsnorm.cu``)."""
    return dtype | vec << 2 | nv << 6 | tpr << 10 | rpb << 21


@functools.lru_cache(maxsize=None)
def _code(rows: int, d: int, dtype: int, itemsize: int, aligned: bool):
    return plan_code(dtype, *rmsnorm_plan(rows, d, itemsize, aligned))


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
    dev = x.device
    if dev.type != "cuda" or scale.device != dev:
        raise ValueError("rmsnorm_kernel takes CUDA tensors on one device, "
                         f"got {dev} and {scale.device}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm_kernel takes fp32/bf16 x and an fp32 "
                         f"scale, got {x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the "
                         f"last axis of x {tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm_kernel takes contiguous tensors")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    rows = n // d
    code = _code(rows, d, dtype, x.element_size(), not (xp | sp | op) & 15)
    index = dev.index
    with device_scope(index):
        err = _symbol()(xp, sp, op, rows, d, eps, code, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"at x{tuple(x.shape)} {x.dtype} plan {code:#x}")
    rmsnorm_kernel.launches += 1
    return out


rmsnorm_kernel.launches = 0
