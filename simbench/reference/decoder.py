"""A plain dense decoder in PyTorch (the SmolLM / Llama block): one
client's model, one batch, in the configuration's type.

Per layer: ``x += Wo·attn(rope(Wq·n(x)), rope(Wk·n(x)), Wv·n(x))`` with
grouped-query heads (query head h reads key/value head ``h // (H/Hkv)``),
causal softmax attention computed in fp32 from the stored q, k, v, and
``x += Wdown·(silu(Wgate·n(x)) * Wup·n(x))``, where ``n`` is RMSNorm in
fp32 (``x·rsqrt(mean(x²) + eps)·scale``, rounded to x's type).  RoPE
rotates the two halves of each head by ``pos · theta^(-2i/hd)`` in fp32.
The head is the embedding transposed (tied), the logits fp32, the loss
the mean cross-entropy over the batch's tokens.  SiLU is taken op by op,
``x · 1/(1 + exp(-x))``, each op in x's type.

The reference of a configuration whose ``"reference"`` is ``"decoder"``:
the module supplies `reference.contract`'s names.  Units
``[{"embed"}, {"l0": {"b0": attention, "b1": SwiGLU}} x L,
{"final_norm"}]``, ``N(0, 0.02²)`` embeddings, ``N(0, 1/fan_in)`` dense
weights, unit norm scales; a cut ``c`` (clamped to 1..L) keeps the
embedding and layers ``1..c`` on the clients.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from simbench.reference.contract import frozen_arch
from simbench.reference.hasfl.config import ModelConfig
from simbench.reference.host import SEQ_LEN, make_lm_data

READS = ("arch_id", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
         "d_ff", "vocab_size", "head_dim", "tie_embeddings", "rope_theta",
         "norm_eps", "dtype")
SMALL = {"program_arch": "smollm-tiny",
         "model": {"arch_id": "smollm-tiny-f32", "n_layers": 2,
                   "d_model": 64, "n_heads": 2, "n_kv_heads": 1, "d_ff": 256,
                   "vocab_size": 256, "head_dim": 32, "dtype": "float32"},
         "traffic": {"n_clients": 2, "n_train": 64, "n_test": 8,
                     "seq_len": 16, "policy": "fixed(b=4,cut=1)"},
         "counts": {"n_layers": 2, "vocab_size": 512, "dtype": "float32"}}


def make_arch(model: dict) -> ModelConfig:
    arch = frozen_arch(ModelConfig, model, READS, __file__)
    if arch.family != "dense":
        raise ValueError(f"{arch.arch_id}: decoder.py runs a dense decoder, "
                         f"not family {arch.family!r}")
    return arch


def leaf_specs(arch) -> list:
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


def rmsnorm(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rope(x, theta: float):
    """``x [b, S, H, hd]`` rotated by position."""
    hd = x.shape[-1]
    freqs = torch.tensor(1.0 / (theta ** (np.arange(0, hd, 2) / hd)),
                         dtype=torch.float32, device=x.device)
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    ang = pos[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def attention(q, k, v):
    """Causal GQA attention, ``[b, S, H, hd]`` against ``[b, S, Hkv, hd]``."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def hidden(units: list, tokens, arch, quant=None):
    """The final-normed hidden states ``[b, S, d]``."""
    q8 = quant or (lambda t: t)

    def mm(a, w):
        return q8(a) @ q8(w)

    b, s = tokens.shape
    h, hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    eps = arch.norm_eps
    x = units[0]["embed"][tokens.long()]
    for rep in units[1:-1]:
        a, f = rep["l0"]["b0"], rep["l0"]["b1"]
        n = rmsnorm(x, a["norm"], eps)
        q = rope(mm(n, a["wq"]).view(b, s, h, hd), arch.rope_theta)
        k = rope(mm(n, a["wk"]).view(b, s, hkv, hd), arch.rope_theta)
        v = mm(n, a["wv"]).view(b, s, hkv, hd)
        x = x + mm(attention(q, k, v).reshape(b, s, h * hd), a["wo"])
        n = rmsnorm(x, f["norm"], eps)
        g = mm(n, f["w_gate"])
        g = g * (1 / (1 + torch.exp(-g)))
        x = x + mm(g * mm(n, f["w_up"]), f["w_down"])
    return rmsnorm(x, units[-1]["final_norm"], eps), q8


def loss(units: list, batch: dict, arch, quant=None):
    """Mean cross-entropy over every token of ``batch`` (``tokens``,
    ``labels`` ``[b, S]``)."""
    x, q8 = hidden(units, batch["tokens"], arch, quant)
    logits = (q8(x) @ q8(units[0]["embed"]).T).float()
    labels = batch["labels"].long()
    nll = torch.logsumexp(logits, dim=-1) \
        - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll.mean()


def train_data(arch, traffic: dict, seed: int):
    n_train = traffic["n_train"]
    tokens, labels = make_lm_data(arch.vocab_size, n_train + traffic["n_test"],
                                  traffic.get("seq_len", SEQ_LEN), seed=seed)
    return {"tokens": tokens[:n_train], "labels": labels[:n_train]}, labels


def n_labels(arch) -> int:
    return arch.vocab_size


def client_specific(arch, cuts, n_units: int) -> list:
    """The embedding and the layers before the deepest cut."""
    l_c = max(min(arch.n_layers, max(1, int(c))) for c in cuts)
    return [u < l_c + 1 for u in range(n_units)]


def unit_layer_spans(arch, n_units: int, n_layers: int) -> list:
    """The embedding on the profile's first layer, the ``n_units - 2``
    layer units over equal periods of it, the final norm on its last."""
    reps = n_units - 2
    period = max(1, n_layers // max(reps, 1))
    spans = [(0, 1)]
    for r in range(reps):
        lo = min(r * period, n_layers - 1)
        hi = n_layers if r == reps - 1 else min((r + 1) * period, n_layers)
        spans.append((lo, max(hi, lo + 1)))
    spans.append((n_layers - 1, n_layers))
    return spans


def forward_flops(arch, seq: int, causal_half: bool = True) -> float:
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
    """The forward, and twice it for the backward."""
    return samples * 3 * forward_flops(arch, seq, causal_half)


def conv_gemm_flops(arch):
    return None


def attention_calls(arch) -> int:
    """One attention a layer."""
    return arch.n_layers


def attention_call_costs(arch, rows: int, seq: int, causal_half: bool = True,
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


def norms_per_step(arch) -> int:
    """Norms of one forward: two a layer and the final one."""
    return 2 * arch.n_layers + 1


def norm_call_bytes(arch, tokens: int, clients: int,
                    itemsize: int = 2) -> tuple:
    """(forward bytes, backward bytes) of one norm over ``tokens`` rows of
    ``d`` with ``clients`` fp32 scales: a forward reads x and the client's
    scale and writes y; a backward reads x, dy and the scale and writes dx
    and the scale's gradient."""
    d = arch.d_model
    scale = clients * d * 4
    return (2 * tokens * d * itemsize + scale,
            3 * tokens * d * itemsize + 2 * scale)


def example_batch(arch, rows: int, seq: int, generator) -> dict:
    tok = torch.randint(0, arch.vocab_size, (rows, seq), generator=generator)
    return {"tokens": tok, "labels": tok}
