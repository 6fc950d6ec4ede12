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

The scale is ``[d]`` (serving) or ``[G, d]``: the rows then fall into G
contiguous groups, each taking its own scale row — the client-stacked
training forward, where every client has its own norm (``[N, b, S, d]``
rows against an ``[N, d]`` scale; qwen3's qk-norm over ``[N, b, S, H,
hd]``).
The plan follows the row count, and with it the order in which a row's
squares are summed; ``cells=C`` (the grid runner's C cells folded into
the rows) plans on one cell's ``rows / C``, so each cell's rows are
normed, forward and backward, as by its own call.

The backward (`rmsnorm_bwd_kernel`, ``csrc/rmsnorm.cu``'s
``repro_rmsnorm_bwd``) computes in fp32, as the reference's jnp
``rmsnorm`` is differentiated: with ``r = 1/sqrt(mean(x²) + eps)``,
``dx = r·(dy∘s) − x·r³·mean(dy∘s∘x)`` in x's type and ``dscale`` the
per-group sum of ``dy∘x·r`` in fp32.  Two launches a call: a block per
chunk of `BWD_CHUNK` rows of one group reads x and dy once (by TMA bulk
copies a few steps ahead, where a chunk takes several steps), on the
forward's plan, several rows at a step, and writes dx and the chunk's
column sums (row by row); then each group's chunk sums are added in chunk
order.  No atomics in any sum: repeated calls are bitwise equal, and a
folded cell's dscale is that of its own call.  `RMSNormFn` is the
autograd `Function` whose forward is the kernel and whose backward is
this one; `kernels.ops.rmsnorm` takes it when an input requires grad.

`rmsnorm_plain` and `rmsnorm_bwd_plain` are the plain PyTorch versions
(CPU tensors and tests).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _grouped(t, scale):
    """``t [..., d]`` as ``[G, rows/G, d]`` and the scale as ``[G, 1, d]``
    (G = 1 for a ``[d]`` scale)."""
    s = scale.float().reshape(-1, 1, scale.shape[-1])
    return t.reshape(s.shape[0], -1, t.shape[-1]), s


def rmsnorm_plain(x, scale, eps: float = 1e-5):
    """``x: [..., d]``, ``scale: [d]`` or ``[G, d]`` (rows grouped
    contiguously) -> ``[..., d]`` in x's type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y, s = _grouped(xf * torch.rsqrt(var + eps), scale)
    return (y * s).reshape(x.shape).to(x.dtype)


def rmsnorm_bwd_plain(x, scale, dy, eps: float = 1e-5):
    """The backward's formula in plain torch ops (tests): ``(dx in x's
    type, dscale fp32 in scale's shape)``."""
    xf, gf = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    g3, s = _grouped(gf, scale)
    gs = (g3 * s).reshape(x.shape)
    dx = r * gs - xf * r ** 3 * (gs * xf).mean(dim=-1, keepdim=True)
    n3, _ = _grouped(xf * r, scale)
    dscale = (g3 * n3).sum(dim=1).reshape(scale.shape)
    return dx.to(x.dtype), dscale


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
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _checked(x, scale, name: str):
    """(type code, d, rows, rows a scale row) of a kernel call; raises on
    what the kernels do not take."""
    dev = x.device
    if dev.type != "cuda" or scale.device != dev:
        raise ValueError(f"{name} takes CUDA tensors on one device, "
                         f"got {dev} and {scale.device}")
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or scale.dtype != torch.float32:
        raise ValueError(f"{name} takes fp32/bf16 x and an fp32 "
                         f"scale, got {x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    groups = scale.shape[0] if scale.dim() == 2 else 1
    if scale.shape[-1] != d or scale.dim() not in (1, 2) \
            or (rows and rows % groups):
        raise ValueError(f"scale {tuple(scale.shape)} is not [d] or [G, d] "
                         f"with G dividing the rows of x {tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    return dtype, d, rows, max(rows // groups, 1)


def _plan_rows(rows: int, cells: int) -> int:
    if cells < 1 or rows % cells:
        raise ValueError(f"{rows} rows do not fold {cells} cells")
    return rows // cells


def rmsnorm_kernel(x, scale, eps: float = 1e-5, cells: int = 1):
    """RMSNorm on the card.  ``x``: contiguous ``[..., d]`` fp32 or bf16;
    ``scale``: contiguous fp32 ``[d]`` or ``[G, d]`` (x's rows grouped
    contiguously by G) on the same device; ``cells``: the plan's row count
    is ``rows / cells``.  Returns a new tensor in x's type; raises on
    anything else and on a refused launch."""
    dtype, d, rows, group_rows = _checked(x, scale, "rmsnorm_kernel")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    xp, sp, op = x.data_ptr(), scale.data_ptr(), out.data_ptr()
    code = _code(_plan_rows(rows, cells), d, dtype, x.element_size(),
                 not (xp | sp | op) & 15)
    index = x.device.index
    with device_scope(index):
        err = _symbol()(xp, sp, op, rows, d, group_rows, eps, code,
                        raw_stream(index))
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err} "
                           f"at x{tuple(x.shape)} {x.dtype} plan {code:#x}")
    rmsnorm_kernel.launches += 1
    return out


rmsnorm_kernel.launches = 0

BWD_CHUNK = 64    # rows a block of the backward covers (one group's)
BWD_LAUNCHES = 2  # kernel launches a backward call makes


@functools.lru_cache(maxsize=1)
def _bwd_symbol():
    fn = build.load("rmsnorm").repro_rmsnorm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _bwd_launches_symbol():
    fn = build.load("rmsnorm").repro_rmsnorm_bwd_launches
    fn.argtypes = []
    fn.restype = ctypes.c_int64
    return fn


def bwd_kernel_launches() -> int:
    """The kernel launches ``repro_rmsnorm_bwd`` has made in this process,
    as its library counts them (each counted once its error check
    passed): the difference across one call is the launches a call."""
    return _bwd_launches_symbol()()


def bwd_chunks(rows: int, group_rows: int) -> int:
    """Blocks of the backward (chunks of `BWD_CHUNK` rows, none straddling
    a group), and the rows of its partial-sum workspace."""
    return rows // group_rows * -(-group_rows // BWD_CHUNK)


def rmsnorm_bwd_kernel(x, scale, dy, eps: float = 1e-5, cells: int = 1):
    """The backward on the card: ``(dx, dscale)`` of `rmsnorm_kernel`'s
    output against ``dy`` (x's shape and type; contiguous), on the
    forward's plan (``cells`` as there).  ``dx`` is in x's type,
    ``dscale`` fp32 in scale's shape.  Two launches, counted as one."""
    dtype, d, rows, group_rows = _checked(x, scale, "rmsnorm_bwd_kernel")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}, contiguous")
    dx = torch.empty_like(x)
    dscale = torch.empty(scale.shape, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    part = torch.empty(bwd_chunks(rows, group_rows) * d, dtype=torch.float32,
                       device=x.device)
    ptrs = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr())
    aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15
    code = _code(_plan_rows(rows, cells), d, dtype, x.element_size(),
                 aligned)
    index = x.device.index
    with device_scope(index):
        err = _bwd_symbol()(*ptrs, dscale.data_ptr(), part.data_ptr(), rows,
                            d, group_rows, eps, code, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error "
                           f"{err} at x{tuple(x.shape)} {x.dtype} plan "
                           f"{code:#x}")
    rmsnorm_bwd_kernel.launches += 1
    return dx, dscale


rmsnorm_bwd_kernel.launches = 0


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with the hand-written forward and backward kernels;
    ``apply(x, scale, eps[, cells])``."""

    @staticmethod
    def forward(ctx, x, scale, eps, cells=1):
        x, scale = x.contiguous(), scale.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.cells = eps, cells
        return rmsnorm_kernel(x, scale, eps, cells)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_kernel(x, scale, dy.contiguous(), ctx.eps,
                                        ctx.cells)
        return dx, dscale, None, None
