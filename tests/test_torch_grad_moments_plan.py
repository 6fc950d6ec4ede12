"""The gradient moments' plan (every element read once) and order, on CPU.

``csrc/grad_moments.cu`` takes the per-unit moments of the HASFL
controller's gradient samples in two launches: a block per chunk of
`CHUNK` elements of one leaf sums its elements thread by thread, then warp
by warp, and a block per unit adds its chunks' sums in chunk order.  Here:
the constants, the table entry's layout and the launch sites are read back
from the source; the wrapper's table and chunk plan walk every element of
every leaf exactly once, each unit's chunks in order, for VGG-16's 16 units
and SmolLM-135M's bf16 units (and under hypothesis); and an emulation of
the kernel's order in fp64 (`grad_moments_plain`) lies within 1e-12
relative of `convergence.estimate_constants`, the host path's numpy: the
same fp64 sums, taken in another order.
"""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.config as TC
from repro_torch.core.convergence import estimate_constants
from repro_torch.core.split import to_units
from repro_torch.kernels import build
from repro_torch.kernels import grad_moments as GM
from repro_torch.models.factory import build_model
from repro_torch.scenarios.controller import _flat_grad

SOURCE = (build.CSRC / "grad_moments.cu").read_text()


def _c_value(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in grad_moments.cu"
    return int(m.group(1))


def _body(signature: str) -> str:
    start = SOURCE.index(signature)
    return SOURCE[start:SOURCE.index("\n}\n", start)]


def test_constants_entry_and_launches_match_the_source():
    assert _c_value("THREADS") == GM.THREADS == 256
    assert _c_value("CHUNK") == GM.CHUNK
    assert _c_value("MAX_SAMPLES") == GM.MAX_SAMPLES
    # a chunk is whole steps of a block's threads, in vectors of either type
    assert GM.CHUNK % (GM.THREADS * GM.vector_width(2)) == 0
    entry = _body("struct Entry {")
    fields = re.findall(r"^\s+(const void\*|int64_t) (\w+)(\[MAX_SAMPLES\])?;",
                        entry, re.M)
    assert fields == [("const void*", "x", "[MAX_SAMPLES]"),
                      ("int64_t", "n", ""), ("int64_t", "start", ""),
                      ("int64_t", "flags", "")]
    assert GM.ENTRY_WORDS == GM.MAX_SAMPLES + 3
    # two launches a call, chunks then units; no atomics anywhere
    assert "<<<" not in _body('extern "C" int repro_grad_moments(')
    launch = _body("void launch(")
    assert launch.count("<<<") == 2 == SOURCE.count("<<<") == GM.LAUNCHES
    assert launch.index("grad_moments_chunks_kernel<K><<<") \
        < launch.index("grad_moments_units_kernel<K><<<")
    assert not re.search(r"atomic\w*\s*[(<]", SOURCE)
    # each element's operations rounded one at a time (no contraction)
    body = _body("__device__ __forceinline__ void add_element(")
    assert "__dadd_rn" in body and "__dmul_rn" in body \
        and "__dsub_rn" in body and "__ddiv_rn" in body
    assert not re.search(r"[^_]fma", SOURCE)


def _chunk_walk(length: int, width: int) -> np.ndarray:
    """The offsets a chunk of ``length`` elements hands its threads, in
    the kernel's loop: thread t takes steps t, t + THREADS, ... of
    ``width`` elements each, while a step starts inside the chunk."""
    steps = -(-length // (GM.THREADS * width))
    first = (np.arange(steps)[:, None] * GM.THREADS
             + np.arange(GM.THREADS)[None]) * width
    first = first[first < length]
    return (first[:, None] + np.arange(width)[None]).ravel()


def _check_walk(units_sizes, widths):
    """Every element of every leaf once, each unit's chunks consecutive,
    each block's binary search landing on its own leaf."""
    starts, bounds = GM.grad_moments_plan(units_sizes)
    assert bounds[0] == 0 and len(bounds) == len(units_sizes) + 1
    leaf = 0
    owner = []
    for u, unit in enumerate(units_sizes):
        at = bounds[u]
        for n in unit:
            assert starts[leaf] == at
            chunks = -(-n // GM.CHUNK)
            width = widths[leaf]
            assert n % width == 0
            for c in {0, chunks - 1} - {-1}:
                # every full chunk walks as chunk 0 does, offset by c·CHUNK
                length = min(GM.CHUNK, n - c * GM.CHUNK)
                walk = _chunk_walk(length, width)
                assert np.array_equal(np.sort(walk), np.arange(length))
            if n:
                owner += [leaf] * chunks
            at += chunks
            leaf += 1
        assert at == bounds[u + 1]
    assert len(owner) == bounds[-1]
    # the kernel's search over the non-empty leaves' first chunks
    live = [i for i, n in enumerate(x for u in units_sizes for x in u) if n]
    firsts = [starts[i] for i in live]
    for b in range(bounds[-1]):
        lo, hi = 0, len(firsts) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if firsts[mid] <= b:
                lo = mid
            else:
                hi = mid - 1
        assert live[lo] == owner[b]


@settings(max_examples=150, deadline=None)
@given(units=st.lists(st.lists(st.integers(0, 40000), max_size=5),
                      min_size=1, max_size=6),
       itemsize=st.sampled_from([2, 4]), data=st.data())
def test_every_plan_walks_each_element_once(units, itemsize, data):
    widths = []
    for unit in units:
        for n in unit:
            vec = data.draw(st.booleans())
            w = GM.vector_width(itemsize)
            widths.append(w if vec and n % w == 0 else 1)
    _check_walk(units, widths)


def _meta_units(arch: str):
    cfg = TC.get_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    return to_units(cfg, params)[0]


@pytest.mark.parametrize("arch,units,leaves,params", [
    ("vgg16-cifar", 16, 32, 15_245_130),
    ("smollm-135m", 32, 272, 134_515_008)])
def test_table_covers_the_models_units(arch, units, leaves, params):
    """The wrapper's table over three samples of the model's units (on the
    ``meta`` device: shapes and types only): an entry a non-empty leaf,
    unit after unit, its count, first chunk and flags under the plan."""
    us = _meta_units(arch)
    per = GM.unit_leaves([us, us, us])
    assert len(per) == units and sum(map(len, per)) == leaves
    words, entries, chunks = GM.table(per)
    sizes = [[xs[0].numel() for xs in unit] for unit in per]
    assert sum(map(sum, sizes)) == params
    starts, bounds = GM.grad_moments_plan(sizes)
    assert entries == leaves and chunks == bounds[-1]
    rows = words[:entries * GM.ENTRY_WORDS].reshape(entries, GM.ENTRY_WORDS)
    flat = [xs for unit in per for xs in unit]
    bf16 = [xs[0].dtype is torch.bfloat16 for xs in flat]
    assert np.array_equal(rows[:, GM.MAX_SAMPLES], [xs[0].numel()
                                                    for xs in flat])
    assert np.array_equal(rows[:, GM.MAX_SAMPLES + 1], starts)
    assert np.array_equal(rows[:, GM.MAX_SAMPLES + 2] >> 1, bf16)
    assert not rows[:, 3].any()                        # the fourth sample
    assert np.array_equal(words[entries * GM.ENTRY_WORDS:], bounds)
    widths = [GM.vector_width(2 if b else 4) if f & 1 else 1
              for b, f in zip(bf16, rows[:, GM.MAX_SAMPLES + 2])]
    _check_walk(sizes, widths)
    if arch == "smollm-135m":
        assert any(bf16) and not all(bf16)   # bf16 weights, fp32 norms


def _samples(spec, k, seed, zero=False):
    """K samples of units of leaves ``spec`` [[(n, dtype, offset), ...],
    ...]: normal values at a few scales, a leaf ``offset`` elements into
    its buffer (misaligned for the kernel's vectors)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(k):
        units = []
        for u, unit in enumerate(spec):
            leaves = []
            for i, (n, dtype, offset) in enumerate(unit):
                x = torch.randn(n + offset, generator=gen) \
                    * 10.0 ** ((u + i) % 5 - 2)
                x = torch.zeros_like(x) if zero else x
                leaves.append(x.to(dtype)[offset:])
            units.append(leaves)
        out.append(units)
    return out


F32, BF16 = torch.float32, torch.bfloat16
CASES = {
    "fp32": [[(4096, F32, 0), (64, F32, 0)], [(20000, F32, 0)]],
    "bf16": [[(9000 * 8, BF16, 0), (576, F32, 0)], [(576, BF16, 0)],
             [(24576, BF16, 0)]],
    "ragged": [[(10, F32, 0), (8195, F32, 0)], [(8199, BF16, 0),
                                                (7, BF16, 0)]],
    "misaligned": [[(4096, F32, 1), (16384, BF16, 3)], [(1, F32, 0)]],
    "one_element": [[(1, F32, 0)], [(1, BF16, 0)]],
    "empty_leaf": [[(0, F32, 0), (300, F32, 0)], [(0, BF16, 0)]],
}


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_order_within_the_bar(case, k):
    samples = _samples(CASES[case], k, seed=len(case) + k)
    got = GM.grad_moments_plain(samples)
    est = estimate_constants([[_flat_grad(g) for g in s] for s in samples])
    want = np.stack([est["g_sq"], est["sigma_sq"]], axis=1)
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want))


def test_emulated_order_of_a_zero_gradient_is_zero():
    samples = _samples(CASES["bf16"], 3, seed=0, zero=True)
    assert not GM.grad_moments_plain(samples).any()


def test_kernel_refuses_what_it_does_not_take():
    x = [[torch.zeros(4)]]
    with pytest.raises(ValueError, match="CUDA"):
        GM.grad_moments_kernel([x, x, x])
    with pytest.raises(ValueError, match="1 to 4 samples"):
        GM.grad_moments_kernel([x] * 5)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        GM.table(GM.unit_leaves([[[torch.zeros(4, dtype=torch.float64)]]]))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        GM.table(GM.unit_leaves([x, [[torch.zeros(5)]]]))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        GM.table(GM.unit_leaves([[[torch.zeros(4, 2).T]]]))
    with pytest.raises(ValueError, match="leaves"):
        GM.unit_leaves([x, [[torch.zeros(4), torch.zeros(1)]]])
