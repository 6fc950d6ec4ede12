"""Kernel 5 (RMSNorm, forward and backward) against its roofline: the
bytes every norm of the window's rounds must move for the useful tokens,
at the HBM rate, over kernel 5's device time in the rounds, in percent.
The norms of a forward and each norm's bytes are the configuration's
reference module's (``norms_per_step``, ``norm_call_bytes``)."""
from simbench import peaks

KERNELS = {"rmsnorm_kernel", "rmsnorm_bwd_rows_kernel",
           "rmsnorm_bwd_sum_kernel", "rmsnorm_bwd_walk_kernel"}


def read(ctx):
    norms = ctx.ref.norms_per_step(ctx.arch)
    if ctx.trace is None or norms is None:
        return None
    seconds = ctx.trace.seconds(KERNELS, within="segment")
    if seconds <= 0:
        return None
    seq = ctx.traffic["seq_len"]
    moved = sum(seg["rounds"] * norms
                * sum(ctx.ref.norm_call_bytes(ctx.arch,
                                              sum(seg["counts"]) * seq,
                                              len(seg["counts"])))
                for seg in ctx.segments)
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / seconds
