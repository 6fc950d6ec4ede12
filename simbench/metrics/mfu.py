"""Model FLOP utilization of the window: the products that the window's
training rounds need for their useful samples (forward, and the backward
without recomputation; the configuration's reference module counts them,
``train_flops``), over the window's wall seconds, over the card's peak in
the configuration's type, in percent.  Padding rows, the estimate's
gradient batches, the evals and the policy count against it."""
import math

from simbench import peaks


def read(ctx):
    seq = ctx.traffic.get("seq_len", 0)
    work = sum(seg["rounds"] * ctx.ref.train_flops(ctx.arch,
                                                   sum(seg["counts"]), seq)
               for seg in ctx.segments)
    share = 100.0 * work / ctx.window_s / peaks.flops(ctx.arch.dtype)
    return share if math.isfinite(share) else None
