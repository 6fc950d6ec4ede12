"""Model FLOP utilization of the window: the products that the window's
training rounds need for their useful samples (forward, and the backward
without recomputation), over the window's wall seconds, over the card's
peak in the configuration's type, in percent.  Padding rows, the
estimate's gradient batches, the evals and the policy count against it."""
import math

from simbench import peaks


def cnn_layer_flops(arch) -> list:
    """Forward FLOPs of each conv and FC layer, per sample."""
    from simbench.reference.params import pools_after

    out, cin, hw = [], 3, arch.image_size
    pools = set(pools_after(arch))
    for i, c in enumerate(arch.conv_channels):
        out.append(2 * hw * hw * 9 * cin * c)
        cin = c
        if i + 1 in pools:
            hw //= 2
    prev = cin * hw * hw
    for f in list(arch.fc_dims) + [arch.n_classes]:
        out.append(2 * prev * f)
        prev = f
    return out


def decoder_forward_flops(arch, seq: int, causal_half: bool = True) -> float:
    """Forward FLOPs of one sequence: every product of every layer and
    the tied head, and attention's two products over the causal half of
    the score matrix (the whole of it with ``causal_half`` off)."""
    d, hd, ff = arch.d_model, arch.resolved_head_dim, arch.d_ff
    hq, hkv = arch.n_heads * hd, arch.n_kv_heads * hd
    proj = 2 * seq * (d * hq + 2 * d * hkv + hq * d + 3 * d * ff)
    attn = 4 * seq * seq * hq * (0.5 if causal_half else 1.0)
    head = 2 * seq * d * arch.vocab_size
    return arch.n_layers * (proj + attn) + head


def train_flops(arch, samples: int, seq: int = 0,
                causal_half: bool = True) -> float:
    """FLOPs of one training step over ``samples`` useful samples: the
    forward, and twice it for the backward, less the first conv's input
    gradient, which nothing needs."""
    if arch.is_cnn:
        layers = cnn_layer_flops(arch)
        return samples * (3 * sum(layers) - layers[0])
    return samples * 3 * decoder_forward_flops(arch, seq, causal_half)


def read(ctx):
    seq = ctx.traffic.get("seq_len", 0)
    work = sum(seg["rounds"] * train_flops(ctx.arch, sum(seg["counts"]), seq)
               for seg in ctx.segments)
    share = 100.0 * work / ctx.window_s / peaks.flops(ctx.arch.dtype)
    return share if math.isfinite(share) else None
