"""Kernel 5 (RMSNorm, forward and backward) against its roofline: the
bytes every norm of the window's rounds must move for the useful tokens,
at the HBM rate, over kernel 5's device time in the rounds, in percent.
A forward reads x and the client's scale and writes y; a backward reads
x, dy and the scale and writes dx and the scale's gradient."""
from simbench import peaks

KERNELS = {"rmsnorm_kernel", "rmsnorm_bwd_rows_kernel",
           "rmsnorm_bwd_sum_kernel", "rmsnorm_bwd_walk_kernel"}


def norms_per_step(arch) -> int:
    """Norms of one forward: two a layer and the final one."""
    return 2 * arch.n_layers + 1


def call_bytes(arch, tokens: int, clients: int, itemsize: int = 2) -> tuple:
    """(forward bytes, backward bytes) of one norm over ``tokens`` rows of
    ``d`` with ``clients`` fp32 scales."""
    d = arch.d_model
    scale = clients * d * 4
    return (2 * tokens * d * itemsize + scale,
            3 * tokens * d * itemsize + 2 * scale)


def read(ctx):
    if ctx.trace is None or ctx.arch.is_cnn:
        return None
    seconds = ctx.trace.seconds(KERNELS, within="segment")
    if seconds <= 0:
        return None
    seq = ctx.traffic["seq_len"]
    moved = sum(seg["rounds"] * norms_per_step(ctx.arch)
                * sum(call_bytes(ctx.arch, sum(seg["counts"]) * seq,
                                 len(seg["counts"])))
                for seg in ctx.segments)
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / seconds
