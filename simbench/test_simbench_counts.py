"""Each metric's operation or byte count against an independent count:
`torch.utils.flop_counter.FlopCounterMode` over the plain reference's
forward and backward at a small batch, or the tensors' own sizes."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from simbench import cell as C
from simbench.harness import reader
from simbench.reference import decoder, vgg
from simbench.reference.params import leaves, make_units

BENCH = C.load_benchmark()
mfu = reader("mfu").__globals__
k1 = reader("k1_gemm_roofline").__globals__
attn = reader("attn_roofline").__globals__
norm = reader("rmsnorm_roofline").__globals__


def _small(name):
    arch = C.find_cell(BENCH, name).arch
    if arch.is_cnn:
        return arch
    return dataclasses.replace(arch, n_layers=2, vocab_size=512,
                               dtype="float32")


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_flop_counts()["Global"]


def _train_step(arch, units, batch):
    ws = [p.requires_grad_() for p in leaves(units)]
    model = vgg if arch.is_cnn else decoder
    model.loss(units, batch, arch).backward()
    return ws


def _batch(arch, rows, seq=8):
    g = torch.Generator().manual_seed(0)
    if arch.is_cnn:
        return {"images": torch.randn(rows, 32, 32, 3, generator=g),
                "labels": torch.randint(0, arch.n_classes, (rows,),
                                        generator=g)}
    tok = torch.randint(0, arch.vocab_size, (rows, seq), generator=g)
    return {"tokens": tok, "labels": tok}


@pytest.mark.parametrize("name", ["vgg16-hasfl-n20", "smollm-fixed-n8"])
def test_train_flops_equal_the_flop_counter(name):
    arch = _small(name)
    rows, seq = 2, 8
    units = make_units(arch, 0, "cpu")
    counts = _counted(lambda: _train_step(arch, units, _batch(arch, rows, seq)))
    want = mfu["train_flops"](arch, rows, seq, causal_half=False)
    assert sum(counts.values()) == want


def test_conv_gemm_flops_equal_the_flop_counter():
    arch = _small("vgg16-hasfl-n20")
    units = make_units(arch, 0, "cpu")
    counts = _counted(lambda: _train_step(arch, units, _batch(arch, 2)))
    conv = sum(v for op, v in counts.items() if "convolution" in str(op))
    assert conv == 2 * k1["conv_gemm_flops"](arch)


def test_attention_flops_equal_the_flop_counter():
    arch = _small("smollm-fixed-n8")
    rows, seq = 3, 16
    hd = arch.resolved_head_dim
    q = torch.randn(rows, seq, arch.n_heads, hd, requires_grad=True)
    k = torch.randn(rows, seq, arch.n_kv_heads, hd, requires_grad=True)
    v = torch.randn(rows, seq, arch.n_kv_heads, hd, requires_grad=True)
    counts = _counted(lambda: decoder.attention(q, k, v).sum().backward())
    (fo, _), (bo, _) = attn["call_costs"](arch, rows, seq, causal_half=False)
    assert sum(counts.values()) == fo + bo


def test_attention_bytes_equal_the_tensors():
    arch = _small("smollm-fixed-n8")
    rows, seq = 3, 16
    hd = arch.resolved_head_dim
    q = torch.empty(rows, seq, arch.n_heads, hd, dtype=torch.bfloat16)
    kv = torch.empty(rows, seq, arch.n_kv_heads, hd, dtype=torch.bfloat16)
    lse = torch.empty(rows, arch.n_heads, seq, dtype=torch.float32)
    size = {"q": q.numel() * 2, "kv": kv.numel() * 2, "lse": lse.numel() * 4}
    (_, fb), (_, bb) = attn["call_costs"](arch, rows, seq)
    # forward: q, k, v read, o and lse written
    assert fb == 2 * size["q"] + 2 * size["kv"] + size["lse"]
    # backward: q, o, dO, k, v, lse read, dq, dk, dv written
    assert bb == 4 * size["q"] + 4 * size["kv"] + size["lse"]


def test_rmsnorm_bytes_equal_the_tensors():
    arch = _small("smollm-fixed-n8")
    clients, tokens = 4, 96
    x = torch.empty(tokens, arch.d_model, dtype=torch.bfloat16)
    scale = torch.empty(clients, arch.d_model, dtype=torch.float32)
    xb, sb = x.numel() * 2, scale.numel() * 4
    fwd, bwd = norm["call_bytes"](arch, tokens, clients)
    assert fwd == 2 * xb + sb           # x read, y written, scale read
    assert bwd == 3 * xb + 2 * sb       # x, dy read, dx written; dscale
    assert norm["norms_per_step"](arch) == 2 * arch.n_layers + 1
