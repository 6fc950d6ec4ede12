"""Kernel 4 (flash attention, forward and backward) against its
roofline: over every call the window's rounds make, the larger of its
products at the bf16 peak and its bytes at the HBM rate, for the useful
sequences only, over kernel 4's device time in the rounds, in percent."""
from simbench import peaks

KERNELS = {"flash_fwd_kernel", "flash_tc_kernel", "bwd_d_kernel",
           "bwd_dkdv_kernel", "bwd_dq_kernel", "d_kernel", "dkdv_kernel",
           "dq_kernel"}


def call_costs(arch, rows: int, seq: int, causal_half: bool = True,
               itemsize: int = 2) -> tuple:
    """((forward ops, bytes), (backward ops, bytes)) of one layer's
    attention over ``rows`` sequences.  The forward reads q, k, v and
    writes o and the fp32 log-sum-exp; the backward reads q, k, v, o, dO
    and the log-sum-exp and writes dq, dk, dv, and does twice the
    forward's products (no recomputation counted)."""
    hq = arch.n_heads * arch.resolved_head_dim
    hkv = arch.n_kv_heads * arch.resolved_head_dim
    tok = rows * seq
    lse = tok * arch.n_heads * 4
    fwd_ops = 4 * rows * seq * seq * hq * (0.5 if causal_half else 1.0)
    fwd_bytes = tok * itemsize * (2 * hq + 2 * hkv) + lse
    bwd_bytes = tok * itemsize * (3 * hq + 2 * hkv) + lse \
        + tok * itemsize * (hq + 2 * hkv)
    return (fwd_ops, fwd_bytes), (2 * fwd_ops, bwd_bytes)


def bound_seconds(arch, rows: int, seq: int) -> float:
    peak = peaks.flops(arch.dtype)
    return arch.n_layers * sum(
        max(ops / peak, nbytes / peaks.HBM_BYTES_PER_S)
        for ops, nbytes in call_costs(arch, rows, seq))


def read(ctx):
    if ctx.trace is None or ctx.arch.is_cnn:
        return None
    seconds = ctx.trace.seconds(KERNELS, within="segment")
    if seconds <= 0:
        return None
    seq = ctx.traffic["seq_len"]
    bound = sum(seg["rounds"] * bound_seconds(ctx.arch, sum(seg["counts"]),
                                              seq) for seg in ctx.segments)
    return 100.0 * bound / seconds
