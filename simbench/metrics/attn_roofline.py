"""Kernel 4 (flash attention, forward and backward) against its
roofline: over every call the window's rounds make, the larger of its
products at the bf16 peak and its bytes at the HBM rate, for the useful
sequences only, over kernel 4's device time in the rounds, in percent.
The calls of a forward and each call's operations and bytes are the
configuration's reference module's (``attention_calls``,
``attention_call_costs``)."""
from simbench import peaks

KERNELS = {"flash_fwd_kernel", "flash_tc_kernel", "bwd_d_kernel",
           "bwd_dkdv_kernel", "bwd_dq_kernel", "d_kernel", "dkdv_kernel",
           "dq_kernel"}


def bound_seconds(ref, arch, rows: int, seq: int) -> float:
    peak = peaks.flops(arch.dtype)
    return ref.attention_calls(arch) * sum(
        max(ops / peak, nbytes / peaks.HBM_BYTES_PER_S)
        for ops, nbytes in ref.attention_call_costs(arch, rows, seq))


def read(ctx):
    if ctx.trace is None or ctx.ref.attention_calls(ctx.arch) is None:
        return None
    seconds = ctx.trace.seconds(KERNELS, within="segment")
    if seconds <= 0:
        return None
    seq = ctx.traffic["seq_len"]
    bound = sum(seg["rounds"] * bound_seconds(ctx.ref, ctx.arch,
                                              sum(seg["counts"]), seq)
                for seg in ctx.segments)
    return 100.0 * bound / seconds
