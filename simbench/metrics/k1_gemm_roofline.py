"""Kernel 1 (the client-batched GEMM that computes every convolution's
forward, weight gradient and input gradient) against its roofline: the
products that the window's rounds' convolutions need for their useful
samples, at the fp32 peak, over kernel 1's device time in the rounds, in
percent.  The GEMMs are compute-bound at these shapes."""
from simbench import peaks
from simbench.metrics.mfu import cnn_layer_flops

KERNELS = {"bmm_f32_kernel", "splitk_reduce_kernel"}


def conv_gemm_flops(arch) -> float:
    """A sample's conv GEMM FLOPs: forward, weight and input gradients of
    every conv, less the first conv's input gradient."""
    convs = cnn_layer_flops(arch)[:len(arch.conv_channels)]
    return 3 * sum(convs) - convs[0]


def read(ctx):
    if ctx.trace is None or not ctx.arch.is_cnn:
        return None
    seconds = ctx.trace.seconds(KERNELS, within="segment")
    if seconds <= 0:
        return None
    work = sum(seg["rounds"] * sum(seg["counts"]) for seg in ctx.segments) \
        * conv_gemm_flops(ctx.arch)
    return 100.0 * work / peaks.flops("float32") / seconds
