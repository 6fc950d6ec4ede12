"""Fused per-client clip-factor + SGD + aggregation-select update.

Port of `repro.kernels.clip_sgd` (TPU kernel ``_kernel`` /
``clip_sgd_update``).  Per ``[N, D]`` parameter leaf of the HASFL round
(`core.split.hasfl_round_update`): scale the raw gradient by the
per-client clip factor, one SGD step (Eq. 5-6), the survivor-weighted
Eq. 4/7 client mean, and the membership/aggregation select —

    spec   = p - gamma * g * scale
    common = sum(w * spec) / where(cnt > 0, cnt, 1),  cnt = sum(w)
    out    = keep ? spec : (not any(keep) and cnt > 0 ? common : p)

`clip_sgd_kernel` is a Triton kernel: one program owns a
``[next_pow2(N), BLOCK_D]`` tile (the whole client axis, so the mean is a
``tl.sum`` over axis 0 in registers), masked loads replace the
reference's D-padding copies, and the result is written back into ``p``
in place (the analogue of the reference's donated leaf).  What bounds it
on the card is memory: it reads p and g and writes p once, 12·N·D bytes.
`clip_sgd_plain` is the plain PyTorch version (the reference's
``clip_sgd_ref`` algebra), used for CPU tensors and in tests.

`clip_sgd_ext_kernel` ports the external-mean variant (TPU kernel
``_kernel_ext``, mesh mode): the Eq. 4/7 mean ``common`` ([D]) arrives
precomputed by the two-tier combine (`core.split.two_tier_common`, whose
all-reduce a kernel tile cannot issue), with the caller's global flag
``use_common``, so only the shard-local clip + SGD + keep-flag select
runs in the kernel:

    spec = p - gamma * g * scale
    out  = keep ? spec : (use_common ? common : p)

It reads no reduction, so one program per ``BLOCK_D`` columns covers
all ``N_local`` rows with no cross-program state; masked loads replace
the D padding and the store is in place.  It is bound by memory:
12·N·D + 4·D bytes (p and g read, p written, the mean row read once).
`clip_sgd_ext_plain` is its plain PyTorch version.
"""
from __future__ import annotations

import functools

import torch


def clip_sgd_plain(p, g, scale, keep_spec, participation=None, *,
                   gamma: float):
    """``p, g: [N, D]``; ``scale``: [N]; ``keep_spec``: per-client keep
    vector [N]; ``participation``: [N] survivor weights or None (full
    cohort: the plain client mean).  Returns the updated leaf (new
    tensor); the same op sequence as the reference's ``clip_sgd_ref``."""
    g = g * scale.reshape(-1, 1)
    spec = p - gamma * g.to(p.dtype)
    keep = keep_spec.reshape(-1, 1).to(torch.bool)
    if participation is None:
        common = spec.mean(dim=0)
        return torch.where(keep, spec, common[None].expand_as(p))
    w = participation.to(spec.dtype).reshape(-1, 1)
    cnt = participation.to(spec.dtype).sum()
    # where, not maximum: fractional weights may sum below 1
    common = (spec * w).sum(dim=0) / torch.where(cnt > 0, cnt, 1.0)
    use_common = torch.logical_and(torch.logical_not(keep.any()), cnt > 0)
    fallback = torch.where(use_common, common[None].expand_as(p), p)
    return torch.where(keep, spec, fallback)


@functools.lru_cache(maxsize=1)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def _clip_sgd(p_ptr, g_ptr, s_ptr, k_ptr, w_ptr, n, d, gamma,
                  BLOCK_N: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.arange(0, BLOCK_N)
        cols = tl.program_id(0).to(tl.int64) * BLOCK_D + tl.arange(0, BLOCK_D)
        rmask = rows < n
        tile = rmask[:, None] & (cols < d)[None, :]
        offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
        p = tl.load(p_ptr + offs, mask=tile, other=0.0)
        g = tl.load(g_ptr + offs, mask=tile, other=0.0)
        s = tl.load(s_ptr + rows, mask=rmask, other=0.0)
        kf = tl.load(k_ptr + rows, mask=rmask, other=0.0)
        w = tl.load(w_ptr + rows, mask=rmask, other=0.0)
        spec = p - gamma * (g * s[:, None])
        cnt = tl.sum(w, axis=0)
        common = tl.sum(spec * w[:, None], axis=0) / tl.where(cnt > 0, cnt, 1.0)
        keep = kf > 0
        n_keep = tl.sum(keep.to(tl.int32), axis=0)
        use_common = (n_keep == 0) & (cnt > 0)
        fallback = tl.where(use_common, common[None, :], p)
        tl.store(p_ptr + offs, tl.where(keep[:, None], spec, fallback),
                 mask=tile)

    return triton, _clip_sgd


def clip_sgd_kernel(p, g, scale, keep_spec, participation=None, *,
                    gamma: float):
    """The Triton launch: updates the contiguous fp32 CUDA leaf ``p``
    ``[N, D]`` in place and returns it.  ``participation=None`` runs with
    all-ones weights."""
    n, d = p.shape
    if p.device.type != "cuda" or g.device != p.device:
        raise ValueError(f"clip_sgd_kernel takes CUDA tensors on one "
                         f"device, got {p.device} and {g.device}")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError("clip_sgd_kernel is fp32")
    if g.shape != p.shape or not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError("clip_sgd_kernel needs contiguous [N, D] p and g "
                         "of one shape")
    cols = [scale, keep_spec,
            torch.ones(n, device=p.device) if participation is None
            else participation]
    s_col, k_col, w_col = (
        c.to(device=p.device, dtype=torch.float32).reshape(n).contiguous()
        for c in cols)
    if d == 0:
        return p
    triton, kernel = _triton_kernel()
    block_n = max(2, triton.next_power_of_2(n))
    block_d = max(128, min(2048, 16384 // block_n))
    with torch.cuda.device(p.device):
        kernel[(triton.cdiv(d, block_d),)](
            p, g, s_col, k_col, w_col, n, d, float(gamma),
            BLOCK_N=block_n, BLOCK_D=block_d, num_warps=8)
    clip_sgd_kernel.launches += 1
    return p


clip_sgd_kernel.launches = 0


def clip_sgd_ext_plain(p, g, scale, keep, common, use_common, *,
                       gamma: float):
    """``p, g: [N, D]``; ``scale``, ``keep``: [N]; ``common``: the [D]
    precomputed Eq. 4/7 mean (participation already folded in);
    ``use_common``: the global scalar flag.  Returns the updated leaf (a
    new tensor); the reference's ``clip_sgd_ref(..., common=)`` algebra."""
    g = g * scale.reshape(-1, 1)
    spec = p - gamma * g.to(p.dtype)
    keep = keep.reshape(-1, 1).to(torch.bool)
    use = torch.as_tensor(use_common, device=p.device).to(torch.bool)
    fallback = torch.where(use, common.reshape(1, -1).to(p.dtype)
                           .expand_as(p), p)
    return torch.where(keep, spec, fallback)


@functools.lru_cache(maxsize=1)
def _triton_ext_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def clip_sgd_ext_kernel(p_ptr, g_ptr, s_ptr, k_ptr, c_ptr, u_ptr, n, d,
                            gamma, BLOCK_N: tl.constexpr,
                            BLOCK_D: tl.constexpr):
        rows = tl.arange(0, BLOCK_N)
        cols = tl.program_id(0).to(tl.int64) * BLOCK_D + tl.arange(0, BLOCK_D)
        rmask = rows < n
        cmask = cols < d
        tile = rmask[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
        p = tl.load(p_ptr + offs, mask=tile, other=0.0)
        g = tl.load(g_ptr + offs, mask=tile, other=0.0)
        s = tl.load(s_ptr + rows, mask=rmask, other=0.0)
        kf = tl.load(k_ptr + rows, mask=rmask, other=0.0)
        c = tl.load(c_ptr + cols, mask=cmask, other=0.0)
        u = tl.load(u_ptr)
        spec = p - gamma * (g * s[:, None])
        fallback = tl.where(u > 0, c[None, :], p)
        tl.store(p_ptr + offs, tl.where(kf[:, None] > 0, spec, fallback),
                 mask=tile)

    return triton, clip_sgd_ext_kernel


def clip_sgd_ext_kernel(p, g, scale, keep, common, use_common, *,
                        gamma: float):
    """The Triton launch of the external-mean update: updates the
    contiguous fp32 CUDA leaf ``p`` ``[N, D]`` in place and returns it.
    ``common`` holds D values, ``use_common`` is a bool or a one-element
    tensor (kept on the device: no host sync)."""
    n, d = p.shape
    if p.device.type != "cuda" or g.device != p.device:
        raise ValueError(f"clip_sgd_ext_kernel takes CUDA tensors on one "
                         f"device, got {p.device} and {g.device}")
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError("clip_sgd_ext_kernel is fp32")
    if g.shape != p.shape or not (p.is_contiguous() and g.is_contiguous()):
        raise ValueError("clip_sgd_ext_kernel needs contiguous [N, D] p "
                         "and g of one shape")
    if common.numel() != d:
        raise ValueError(f"common has {common.numel()} values, the leaf "
                         f"has D={d}")
    s_col, k_col = (c.to(device=p.device, dtype=torch.float32)
                    .reshape(n).contiguous() for c in (scale, keep))
    c_row = common.to(device=p.device, dtype=torch.float32).reshape(d) \
        .contiguous()
    u = torch.as_tensor(use_common, device=p.device).to(torch.float32) \
        .reshape(1)
    if d == 0:
        return p
    triton, kernel = _triton_ext_kernel()
    block_n = max(2, triton.next_power_of_2(n))
    block_d = max(128, min(2048, 16384 // block_n))
    with torch.cuda.device(p.device):
        kernel[(triton.cdiv(d, block_d),)](
            p, g, s_col, k_col, c_row, u, n, d, float(gamma),
            BLOCK_N=block_n, BLOCK_D=block_d, num_warps=8)
    clip_sgd_ext_kernel.launches += 1
    return p


clip_sgd_ext_kernel.launches = 0
