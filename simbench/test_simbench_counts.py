"""Each metric's operation or byte count against an independent count, for
every configuration's reference module that has the layer counted:
`torch.utils.flop_counter.FlopCounterMode` over the plain reference's
forward and backward at a small batch, the layer calls a forward makes,
or the tensors' own sizes."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from simbench import cell as C
from simbench.reference.params import leaves, make_units

BENCH = C.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _cell(config: str):
    return C.find_cell(BENCH, next(w["name"] for w in BENCH["workloads"]
                                   if w["config"] == config))


def _small(config: str):
    """(module, arch) at the module's count size."""
    cell = _cell(config)
    return cell.ref, dataclasses.replace(cell.arch,
                                         **cell.ref.SMALL["counts"])


def _with(count: str) -> list:
    """The configurations whose module has ``count`` (not None)."""
    return [c for c, (ref, arch) in zip(CONFIGS, map(_small, CONFIGS))
            if getattr(ref, count)(arch) is not None]


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_flop_counts()["Global"]


def _train_step(ref, arch, units, batch):
    ws = [p.requires_grad_() for p in leaves(units)]
    ref.loss(units, batch, arch).backward()
    return ws


def _batch(ref, arch, rows, seq=8):
    return ref.example_batch(arch, rows, seq,
                             torch.Generator().manual_seed(0))


@pytest.mark.parametrize("config", CONFIGS)
def test_train_flops_equal_the_flop_counter(config):
    ref, arch = _small(config)
    rows, seq = 2, 8
    units = make_units(ref, arch, 0, "cpu")
    counts = _counted(lambda: _train_step(ref, arch, units,
                                          _batch(ref, arch, rows, seq)))
    want = ref.train_flops(arch, rows, seq, causal_half=False)
    assert sum(counts.values()) == want


@pytest.mark.parametrize("config", _with("conv_gemm_flops"))
def test_conv_gemm_flops_equal_the_flop_counter(config):
    ref, arch = _small(config)
    units = make_units(ref, arch, 0, "cpu")
    counts = _counted(lambda: _train_step(ref, arch, units,
                                          _batch(ref, arch, 2)))
    conv = sum(v for op, v in counts.items() if "convolution" in str(op))
    assert conv == 2 * ref.conv_gemm_flops(arch)


@pytest.mark.parametrize("config", _with("attention_calls"))
def test_attention_flops_equal_the_flop_counter(config):
    ref, arch = _small(config)
    rows, seq = 3, 16
    hd = arch.resolved_head_dim
    q = torch.randn(rows, seq, arch.n_heads, hd, requires_grad=True)
    k = torch.randn(rows, seq, arch.n_kv_heads, hd, requires_grad=True)
    v = torch.randn(rows, seq, arch.n_kv_heads, hd, requires_grad=True)
    counts = _counted(lambda: ref.attention(q, k, v).sum().backward())
    (fo, _), (bo, _) = ref.attention_call_costs(arch, rows, seq,
                                                causal_half=False)
    assert sum(counts.values()) == fo + bo


@pytest.mark.parametrize("config", _with("attention_calls"))
def test_attention_bytes_equal_the_tensors(config):
    ref, arch = _small(config)
    rows, seq = 3, 16
    hd = arch.resolved_head_dim
    q = torch.empty(rows, seq, arch.n_heads, hd, dtype=torch.bfloat16)
    kv = torch.empty(rows, seq, arch.n_kv_heads, hd, dtype=torch.bfloat16)
    lse = torch.empty(rows, arch.n_heads, seq, dtype=torch.float32)
    size = {"q": q.numel() * 2, "kv": kv.numel() * 2, "lse": lse.numel() * 4}
    (_, fb), (_, bb) = ref.attention_call_costs(arch, rows, seq)
    # forward: q, k, v read, o and lse written
    assert fb == 2 * size["q"] + 2 * size["kv"] + size["lse"]
    # backward: q, o, dO, k, v, lse read, dq, dk, dv written
    assert bb == 4 * size["q"] + 4 * size["kv"] + size["lse"]


@pytest.mark.parametrize("config", _with("norms_per_step"))
def test_rmsnorm_bytes_equal_the_tensors(config):
    ref, arch = _small(config)
    clients, tokens = 4, 96
    x = torch.empty(tokens, arch.d_model, dtype=torch.bfloat16)
    scale = torch.empty(clients, arch.d_model, dtype=torch.float32)
    xb, sb = x.numel() * 2, scale.numel() * 4
    fwd, bwd = ref.norm_call_bytes(arch, tokens, clients)
    assert fwd == 2 * xb + sb           # x read, y written, scale read
    assert bwd == 3 * xb + 2 * sb       # x, dy read, dx written; dscale


@pytest.mark.parametrize("layer,count", [("attention", "attention_calls"),
                                         ("rmsnorm", "norms_per_step")])
@pytest.mark.parametrize("config", CONFIGS)
def test_layer_calls_equal_a_forward(config, layer, count, monkeypatch):
    """The calls a forward makes of the module's layer function are its
    count; a module whose count is None has no such layer."""
    ref, arch = _small(config)
    want = getattr(ref, count)(arch)
    if want is None:
        assert getattr(ref, layer, None) is None
        return
    calls = []
    real = getattr(ref, layer)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ref, layer, counted)
    units = make_units(ref, arch, 0, "cpu")
    with torch.no_grad():
        ref.loss(units, _batch(ref, arch, 2), arch)
    assert len(calls) == want
