"""Per-client batched 3x3 convolution as im2col + one client-batched GEMM.

Port of `repro.kernels.batched_conv`.  Every client's conv weights sit on
a leading ``N`` axis (NHWC activations ``[N, B, H, W, C]``, HWIO filters
``[N, 3, 3, Cin, Cout]``, as in the reference), and each conv is one
client-batched matmul of im2col patches with the reshaped filter.
`BatchedConv` mirrors the reference's ``conv_vjp``: the backward pass
routes through the same matmul, ``dW = patchesᵀ @ dy`` and ``dx`` as
im2col of the stride-dilated, re-padded ``dy`` times the flipped,
in/out-transposed filter — three GEMMs per conv, db = Σdy.  Padding,
dilation, im2col, the flip and the bias are plain torch, as they are jnp
outside the kernel in the reference.

The GEMM itself is ``csrc/batched_matmul.cu`` (`batched_matmul_kernel`,
CUDA C++ for sm_90a, replacing the TPU kernel ``_bmm_kernel`` /
``batched_matmul_pallas``).  It is fp32 on the CUDA cores (no TF32, so
the bound is operations at the fp32 rate): 128×128 block tiles (128×64
where C <= 64) of 8×8 outputs a thread, K in slabs of 16 through a
3-stage cp.async ring, and split-K (`gemm_splits`) where the output tiles
alone leave the card under-filled — the long-K dW shapes — with the
partial sums reduced in a fixed order by a second launch of the same
call.  `batched_matmul_plain` is its plain PyTorch version (CPU tensors
and tests).  `repro_torch.kernels.ops.batched_conv` picks between them by
the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.launch import device_scope, raw_stream
from repro_torch.utils.cells import by_cell


def same_geometry(h: int, w: int, kh: int, kw: int, stride: int):
    """(ho, wo, pad_h_lo, pad_h_hi, pad_w_lo, pad_w_hi) for SAME padding.

    ``lo = pad // 2`` exactly as ``lax.conv``: stride 2 on an even input
    pads (0, 1), which torch's symmetric ``padding=1`` would get wrong.
    """
    ho, wo = -(-h // stride), -(-w // stride)
    pad_h = max((ho - 1) * stride + kh - h, 0)
    pad_w = max((wo - 1) * stride + kw - w, 0)
    return ho, wo, pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2


def pad_hw(x, h_lo: int, h_hi: int, w_lo: int, w_hi: int):
    """Zero-pad the H and W axes of ``[N, B, H, W, C]``."""
    return F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))


def extract_patches(xp, kh: int, kw: int, ho: int, wo: int, stride: int):
    """Pre-padded ``xp [N,B,Hp,Wp,C]`` -> patches ``[N,B,ho,wo,kh*kw*C]``.

    Patch order is (di, dj, channel) — the flattening
    ``w.reshape(N, kh*kw*C, Cout)`` produces for HWIO filters.
    """
    cols = [
        xp[:, :, di:di + (ho - 1) * stride + 1:stride,
           dj:dj + (wo - 1) * stride + 1:stride, :]
        for di in range(kh) for dj in range(kw)
    ]
    pat = torch.stack(cols, dim=-2)           # [N,B,ho,wo,kh*kw,C]
    return pat.reshape(pat.shape[:4] + (-1,))


# ---------------------------------------------------------------------------
# The client-batched GEMM: kernel and plain version
# ---------------------------------------------------------------------------

def batched_matmul_plain(a, b):
    """``a [N,M,K] @ b [N,K,C] -> [N,M,C]`` in plain PyTorch."""
    return torch.einsum("nmk,nkc->nmc", a, b)


GEMM_BM, GEMM_BK = 128, 16   # the kernel's block rows and K slab
SPLIT_MIN_CHUNK = 512         # least K a split of split-K takes
H100_SMS = 132


def gemm_tile_c(c: int) -> int:
    """Block columns of the kernel: 64 where C <= 64, else 128."""
    return 64 if c <= 64 else 128


def gemm_splits(n: int, m: int, k: int, c: int, sms: int = H100_SMS,
                plan_n=None):
    """(splits, chunk) of split-K for ``[n, m, k] @ [n, k, c]``.

    Where the output tiles fill ``sms`` SMs at least twice, or K is short
    (under two chunks of `SPLIT_MIN_CHUNK`), one split takes all of K.
    Otherwise K is cut into chunks of ``chunk`` (a multiple of the
    16-deep slab, at least `SPLIT_MIN_CHUNK`) so that ``tiles · splits``
    reaches that target; every chunk is non-empty and together they cover
    K once.  ``plan_n`` (one cell of a call that folds ``n / plan_n``
    cells) counts the tiles of ``plan_n`` batches instead of ``n``: a
    batch's outputs are summed in an order that depends only on (splits,
    chunk), so the folded call sums each output as the one-cell call does.
    """
    tiles = (plan_n or n) * -(-m // GEMM_BM) * -(-c // gemm_tile_c(c))
    target = 2 * sms
    if tiles >= target or k < 2 * SPLIT_MIN_CHUNK:
        return 1, k
    want = -(-target // tiles)
    chunk = max(SPLIT_MIN_CHUNK, -(-k // (want * GEMM_BK)) * GEMM_BK)
    return -(-k // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1)
def _bmm_symbol():
    fn = build.load("batched_matmul").repro_bmm_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def batched_matmul_kernel(a, b, *, plan_n=None):
    """``a [N,M,K] @ b [N,K,C] -> [N,M,C]`` on the card (fp32, no TF32).

    Any strides are accepted (dW passes patchesᵀ as a transposed view);
    the output is a fresh contiguous tensor.  Split-K (`gemm_splits`, at
    ``plan_n`` batches where given) adds an fp32 workspace ``[S, N, M,
    C]`` and a fixed-order reduction, so repeated calls are bitwise equal;
    one call is one counted launch.
    Raises on anything the kernel does not take, and on a refused launch.
    """
    if a.device.type != "cuda" or b.device.type != "cuda" \
            or a.device != b.device:
        raise ValueError("batched_matmul_kernel takes CUDA tensors on one "
                         f"device, got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"batched_matmul_kernel is fp32, got {a.dtype}, "
                         f"{b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    n, m, k = a.shape
    c = b.shape[2]
    out = torch.empty((n, m, c), device=a.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    splits, chunk = gemm_splits(n, m, k, c, _sm_count(a.device.index),
                                plan_n)
    ws = (torch.empty((splits, n, m, c), device=a.device,
                      dtype=torch.float32) if splits > 1 else None)
    index = a.device.index
    with device_scope(index):
        stream = raw_stream(index)
        err = _bmm_symbol()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            None if ws is None else ws.data_ptr(),
                            n, m, k, c, *a.stride(), *b.stride(), splits,
                            chunk, stream)
    if err != 0:
        raise RuntimeError(f"batched_matmul kernel launch failed: CUDA "
                           f"error {err} at a{tuple(a.shape)} "
                           f"b{tuple(b.shape)}")
    batched_matmul_kernel.launches += 1
    return out


batched_matmul_kernel.launches = 0


# ---------------------------------------------------------------------------
# Forward / backward through the GEMM
# ---------------------------------------------------------------------------

def conv_fwd(x, w, b, stride: int, mm):
    n, bsz, h, wd, _ = x.shape
    kh, kw, cout = w.shape[1], w.shape[2], w.shape[4]
    ho, wo, plo_h, phi_h, plo_w, phi_w = same_geometry(h, wd, kh, kw, stride)
    pat = extract_patches(pad_hw(x, plo_h, phi_h, plo_w, phi_w),
                          kh, kw, ho, wo, stride)
    out = mm(pat.reshape(n, bsz * ho * wo, -1),
             w.reshape(n, -1, cout)).reshape(n, bsz, ho, wo, cout)
    return out + b[:, None, None, None, :]


def conv_bwd(x, w, dy, stride: int, mm, need_dx: bool = True,
             cell_size=None):
    """(dx, dw, db), the matmuls through ``mm``; dx is None unless
    ``need_dx``.  ``cell_size`` (a grid's N) sums db cell by cell
    (`utils.cells.by_cell`).

    dW: patches(x)ᵀ @ dy.  dx: dilate dy by the stride, re-pad so the
    VALID correlation with the 180°-rotated in/out-transposed filter
    lands on the input geometry, then im2col(dy) @ w_rot.
    """
    n, bsz, h, wd, cin = x.shape
    kh, kw, cout = w.shape[1], w.shape[2], w.shape[4]
    ho, wo, plo_h, phi_h, plo_w, phi_w = same_geometry(h, wd, kh, kw, stride)

    db = by_cell(lambda t: t.sum(dim=(1, 2, 3)), cell_size, dy)

    pat = extract_patches(pad_hw(x, plo_h, phi_h, plo_w, phi_w),
                          kh, kw, ho, wo, stride)
    dw = mm(pat.reshape(n, bsz * ho * wo, -1).transpose(1, 2),
            dy.reshape(n, bsz * ho * wo, cout)).reshape(w.shape)
    if not need_dx:
        return None, dw, db

    hd, wdl = (ho - 1) * stride + 1, (wo - 1) * stride + 1
    if stride > 1:
        dyd = dy.new_zeros((n, bsz, hd, wdl, cout))
        dyd[:, :, ::stride, ::stride, :] = dy
    else:
        dyd = dy
    dyp = pad_hw(dyd, kh - 1 - plo_h, h + plo_h - hd,
                 kw - 1 - plo_w, wd + plo_w - wdl)
    dpat = extract_patches(dyp, kh, kw, h, wd, 1)
    w_rot = w.flip(1, 2).transpose(3, 4)
    dx = mm(dpat.reshape(n, bsz * h * wd, -1),
            w_rot.reshape(n, -1, cin)).reshape(x.shape)
    return dx, dw, db


class BatchedConv(torch.autograd.Function):
    """Stacked SAME conv whose forward and backward both run through the
    client-batched GEMM ``mm`` (the reference's ``conv_vjp``).  Saves
    only (x, w); the backward rebuilds the patches, and skips dx when the
    input needs no gradient (the images).  ``cell_size`` is a grid's N
    (`conv_bwd`), or None."""

    @staticmethod
    def forward(ctx, x, w, b, stride, mm, cell_size=None):
        ctx.stride, ctx.mm, ctx.cell_size = stride, mm, cell_size
        ctx.save_for_backward(x, w)
        return conv_fwd(x, w, b, stride, mm)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = conv_bwd(x, w, dy, ctx.stride, ctx.mm,
                              need_dx=ctx.needs_input_grad[0],
                              cell_size=ctx.cell_size)
        return dx, dw, db, None, None, None


def batched_conv_plain(x, w, b, stride: int = 1):
    """The plain autograd path: the same forward algebra with the plain
    matmul, differentiated by torch's own autograd (no custom backward) —
    the independent yardstick for `BatchedConv`'s hand-written VJP."""
    return conv_fwd(x, w, b, stride, batched_matmul_plain)
