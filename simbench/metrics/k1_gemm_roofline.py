"""Kernel 1 (the client-batched GEMM that computes every convolution's
forward, weight gradient and input gradient) against its roofline: the
products that the window's rounds' convolutions need for their useful
samples (``conv_gemm_flops`` of the configuration's reference module, a
sample's), at the fp32 peak, over kernel 1's device time in the rounds,
in percent.  The GEMMs are compute-bound at these shapes."""
from simbench import peaks

KERNELS = {"bmm_f32_kernel", "splitk_reduce_kernel"}


def read(ctx):
    flops = ctx.ref.conv_gemm_flops(ctx.arch)
    if ctx.trace is None or flops is None:
        return None
    seconds = ctx.trace.seconds(KERNELS, within="segment")
    if seconds <= 0:
        return None
    work = sum(seg["rounds"] * sum(seg["counts"]) for seg in ctx.segments) \
        * flops
    return 100.0 * work / peaks.flops("float32") / seconds
