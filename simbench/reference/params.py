"""The initial parameters a run starts from, made by the benchmark.

``make_units(arch, seed, device)`` draws one model's cuttable units — the
unit list layout the simulator trains (a CNN: one ``{"w", "b"}`` a
conv/fc layer, HWIO filters and ``[in, out]`` FC weights; a dense decoder:
``[{"embed"}, {"l0": {"b0": attention, "b1": SwiGLU}} x R,
{"final_norm"}]``) — from ``seed`` on ``device`` in one call of a
generator on that device, in the type each leaf is trained in.  The
distributions are the usual ones: He normal convs, ``N(0, 1/fan_in)``
dense weights, ``N(0, 0.02²)`` embeddings, zero biases, unit norm
scales.  The program and the reference are both handed these units.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def pools_after(arch) -> list:
    """1-based conv indices followed by a 2x2 max-pool."""
    n = len(arch.conv_channels)
    return [i for i in range(1, n + 1)
            if (i in (2, 4, 7, 10, 13) if n == 13 else i % 2 == 0)]


def leaf_specs(arch) -> list:
    """``[(unit, path, shape, dtype, init)]`` with ``init`` a normal's
    standard deviation, ``"zeros"`` or ``"ones"``."""
    if arch.is_cnn:
        return _cnn_specs(arch)
    return _decoder_specs(arch)


def _cnn_specs(arch) -> list:
    out, cin = [], 3
    for u, c in enumerate(arch.conv_channels):
        out.append((u, ("w",), (3, 3, cin, c), "float32",
                    math.sqrt(2.0 / (9 * cin))))
        out.append((u, ("b",), (c,), "float32", "zeros"))
        cin = c
    spatial = max(1, arch.image_size // 2 ** len(pools_after(arch)))
    prev = cin * spatial * spatial
    for f in list(arch.fc_dims) + [arch.n_classes]:
        u = out[-1][0] + 1
        out.append((u, ("w",), (prev, f), "float32", 1 / math.sqrt(prev)))
        out.append((u, ("b",), (f,), "float32", "zeros"))
        prev = f
    return out


def _decoder_specs(arch) -> list:
    d, hd, ff = arch.d_model, arch.resolved_head_dim, arch.d_ff
    hq, hkv, dt = arch.n_heads * hd, arch.n_kv_heads * hd, arch.dtype
    out = [(0, ("embed",), (arch.vocab_size, d), dt, 0.02)]
    for r in range(arch.n_layers):
        u = r + 1
        attn, ffn = ("l0", "b0"), ("l0", "b1")
        out += [(u, attn + ("norm",), (d,), "float32", "ones"),
                (u, attn + ("wq",), (d, hq), dt, 1 / math.sqrt(d)),
                (u, attn + ("wk",), (d, hkv), dt, 1 / math.sqrt(d)),
                (u, attn + ("wv",), (d, hkv), dt, 1 / math.sqrt(d)),
                (u, attn + ("wo",), (hq, d), dt, 1 / math.sqrt(hq)),
                (u, ffn + ("w_gate",), (d, ff), dt, 1 / math.sqrt(d)),
                (u, ffn + ("w_up",), (d, ff), dt, 1 / math.sqrt(d)),
                (u, ffn + ("w_down",), (ff, d), dt, 1 / math.sqrt(ff)),
                (u, ffn + ("norm",), (d,), "float32", "ones")]
    if not arch.tie_embeddings:
        raise NotImplementedError("untied heads are not in this benchmark")
    out.append((arch.n_layers + 1, ("final_norm",), (d,), "float32", "ones"))
    return out


def make_units(arch, seed: int, device) -> list:
    """The unit list of one model, drawn from ``seed`` on ``device``."""
    specs = leaf_specs(arch)
    drawn = [s for s in specs if not isinstance(s[4], str)]
    total = sum(math.prod(s[2]) for s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    units = [{} for _ in range(specs[-1][0] + 1)]
    off = 0
    for u, path, shape, dtype, init in specs:
        if init == "zeros":
            leaf = torch.zeros(shape, dtype=DTYPES[dtype], device=device)
        elif init == "ones":
            leaf = torch.ones(shape, dtype=DTYPES[dtype], device=device)
        else:
            n = math.prod(shape)
            leaf = (flat[off:off + n].view(shape) * init).to(DTYPES[dtype])
            off += n
        node = units[u]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    del flat
    return units


def leaves(tree) -> list:
    """A unit tree's leaves in sorted-key order (the simulator's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of `leaves`, in the same order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]
