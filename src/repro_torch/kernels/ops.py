"""Device dispatch for the port's kernels.

Counterpart of `repro.kernels.ops`.  Each op goes by the device of the
tensors it is given: a CUDA tensor launches the hand-written kernel (or
the launch raises), a CPU tensor runs the kernel's plain PyTorch version.
A ``meta`` tensor (the dry-run, `launch/dryrun.py`) runs the plain
version too, which only propagates shapes there — except flash attention,
its decode and the mLSTM scan, whose shapes-only stand-ins charge the
kernels' work (`kernels.meta`).  There is no impl knob and no fallback on
the card.

Gradients: on the CPU the plain versions carry autograd.  On the card,
when grad mode is on and an input requires grad, flash attention, RMSNorm
and the mLSTM scan go through their autograd `Function`s (the
hand-written forward and backward kernels).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import batched_conv as BC
from repro_torch.kernels import clip_sgd as CS
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import grad_moments as GM
from repro_torch.kernels import meta as META
from repro_torch.kernels import mlstm_scan as MS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.utils.cells import apart, by_cell


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _on_card(t) -> bool:
    """True for a CUDA tensor; False on the CPU and on the ``meta`` device
    (the dry-run's shapes-only tensors), where the plain versions run and
    no kernel does."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"unsupported device {t.device}")


def batched_conv(x, w, b, *, stride: int = 1, cell_size=None):
    """Per-client stacked SAME conv, forward and backward through the
    client-batched GEMM.  x: [N, B, H, W, Cin]; w: [N, kh, kw, Cin, Cout];
    b: [N, Cout].  ``cell_size`` (a grid's N, where the leading axis folds
    cells of N clients) plans the GEMM's split-K per cell and sums the
    bias gradient per cell, so each cell is computed as alone."""
    mm = (functools.partial(BC.batched_matmul_kernel, plan_n=cell_size)
          if _on_card(x) else BC.batched_matmul_plain)
    return BC.BatchedConv.apply(x, w, b, stride, mm, cell_size)


def clip_sgd(p, g, scale, keep_spec, participation=None, *, gamma: float,
             common=None, use_common=None):
    """Fused clip + SGD + aggregation select over one ``[N, D]`` leaf.

    ``common`` ([D], mesh mode) hands in the Eq. 4/7 mean precomputed by
    `core.split.two_tier_common`, gated by the global flag
    ``use_common``; the participation weights are then already folded
    into it, and the external-mean kernel runs.  On the card ``p`` is
    updated in place and returned; on the CPU a new tensor is returned.
    """
    if common is not None:
        fn = CS.clip_sgd_ext_kernel if _on_card(p) else CS.clip_sgd_ext_plain
        return fn(p, g, scale, keep_spec, common, use_common, gamma=gamma)
    fn = CS.clip_sgd_kernel if _on_card(p) else CS.clip_sgd_plain
    return fn(p, g, scale, keep_spec, participation, gamma=gamma)


def clip_sgd_leaves(ps, gs, scale, keep_specs, participation=None, *,
                    gamma: float, commons=None, count=None, cells=1):
    """One round's fused update over every ``[N, D_i]`` leaf: the leaf
    i's keep vector is ``keep_specs[i]`` for the survivors.  ``commons``
    (mesh mode) hands in each leaf's precomputed Eq. 4/7 mean and
    ``count`` the global survivor count; the external-mean form then runs.
    ``cells=G`` folds G cells of N clients (``[G·N, D_i]`` leaves, one
    ``keep_specs`` list a cell), each updated as by its own call.  On the
    card the leaves are updated in place in one launch (per 64 (cell,
    leaf) entries) and returned; on the CPU new tensors are returned."""
    fn = CS.clip_sgd_leaves_kernel if _on_card(ps[0]) \
        else CS.clip_sgd_leaves_plain
    return fn(ps, gs, scale, keep_specs, participation, gamma=gamma,
              commons=commons, count=count, cells=cells)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    sk_valid=None):
    """GQA attention, q ``[B, Sq, Hq, hd]`` against k, v ``[B, Sk, Hkv,
    hd]``; keys at or past ``sk_valid`` (default ``Sk``) are masked."""
    if q.is_meta:
        return META.attention(q, k, v, causal, window)
    if not _on_card(q):
        return FA.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, sk_valid=sk_valid)
    if _needs_grad(q, k, v):
        if sk_valid is not None:
            raise NotImplementedError(
                "flash attention's backward takes no sk_valid (decode "
                "only); a grad-requiring decode call is not supported")
        return FA.FlashAttentionFn.apply(q, k, v, causal, window)
    return FA.flash_attention_kernel(q, k, v, causal=causal, window=window,
                                     sk_valid=sk_valid)


def flash_decode(q, k_cache, v_cache, k_pos, cur_pos, *, window: int = 0):
    """One query token ``q [B, 1, Hq, hd]`` against the cache ``[B, C, Hkv,
    hd]``, each slot masked by the position it holds (``k_pos [B, C]``, -1
    = empty) against ``cur_pos [B]`` and ``window``: any cache the
    reference's ``decode_attention`` takes (ring, windowed, per-sequence).
    On the card the positions stay there."""
    if q.is_meta:
        return META.decode(q, k_cache, v_cache, k_pos)
    if not _on_card(q):
        return FA.flash_decode_plain(q, k_cache, v_cache, k_pos, cur_pos,
                                     window=window)
    return FA.flash_decode_kernel(q, k_cache, v_cache, k_pos, cur_pos,
                                  window=window)


def rmsnorm(x, scale, eps: float = 1e-5, *, cell_size=None):
    """``x · rsqrt(mean(x²) + eps) · scale`` over the last axis; ``scale``
    ``[d]``, or ``[G, d]`` over G contiguous groups of x's rows.
    ``cell_size`` (a grid's N, where x's and the ``[G·N, d]`` scale's
    leading axis folds cells of N clients) plans the kernel on one cell's
    rows, so each cell's rows are summed as alone (one launch still); the
    plain version runs cell by cell."""
    if not _on_card(x):
        return by_cell(lambda a, s: RN.rmsnorm_plain(a, s, eps), cell_size,
                       x, scale)
    cells = x.shape[0] // cell_size if apart(x, cell_size) else 1
    if _needs_grad(x, scale):
        return RN.RMSNormFn.apply(x, scale, eps, cells)
    return RN.rmsnorm_kernel(x, scale, eps, cells=cells)


def mlstm_scan(q, k, v, i_gate, f_gate):
    """The mLSTM recurrence from an empty state; q, k, v ``[B, S, H, hd]``,
    gate pre-activations ``[B, S, H]``.  On the card a grad-requiring
    input goes through `MLSTMScanFn` (the forward kernel, which also keeps
    each row's ``a_t`` and ``m_t``, and the backward kernel)."""
    if q.is_meta:
        return META.mlstm_scan(q, k, v, i_gate, f_gate)
    if not _on_card(q):
        return MS.mlstm_scan_plain(q, k, v, i_gate, f_gate)
    if _needs_grad(q, k, v, i_gate, f_gate):
        return MS.MLSTMScanFn.apply(q, k, v, i_gate, f_gate)
    return MS.mlstm_scan_kernel(q, k, v, i_gate, f_gate)


KERNELS = {
    "batched_matmul": BC.batched_matmul_kernel,
    "clip_sgd": CS.clip_sgd_kernel,
    "clip_sgd_ext": CS.clip_sgd_ext_kernel,
    "flash_attention": FA.flash_attention_kernel,
    "flash_attention_bwd": FA.flash_attention_bwd_kernel,
    "rmsnorm": RN.rmsnorm_kernel,
    "rmsnorm_bwd": RN.rmsnorm_bwd_kernel,
    "mlstm_scan": MS.mlstm_scan_kernel,
    "mlstm_scan_bwd": MS.mlstm_scan_bwd_kernel,
    "grad_moments": GM.grad_moments_kernel,
}


def launch_counts() -> dict:
    """Launches of each kernel since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every kernel's count, and the per-path counts of flash
    attention and the mLSTM scan (forward and backward)."""
    for fn in KERNELS.values():
        fn.launches = 0
    FA.reset_path_launches()
    MS.reset_path_launches()
