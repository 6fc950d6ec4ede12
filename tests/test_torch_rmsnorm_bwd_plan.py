"""The RMSNorm backward's plan (x and dy read once) and dscale order, on CPU.

``csrc/rmsnorm.cu``'s backward is two launches: a block per chunk of
`BWD_CHUNK` rows of one scale group, on the forward's plan, sums each
column's dy·(x·r) row by row, and then each group's chunk sums are added
in chunk order.  Here: the constants and the launch sites are read back
from the source; every plan the wrapper picks makes a block the kernel
takes; and an emulation of that order (fp32, each product and sum rounded
as the kernel rounds it) stays within 1e-4 of `rmsnorm_bwd_plain` and
gives each cell folded into a call (the grid runner's ``cells``) bitwise
the dscale of that cell's own call.
"""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as RN

SOURCE = (build.CSRC / "rmsnorm.cu").read_text()


def _c_value(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, f"{name} not found in rmsnorm.cu"
    return int(m.group(1))


def _body(signature: str) -> str:
    """The source text from ``signature`` to the next closing brace at
    column 0."""
    start = SOURCE.index(signature)
    return SOURCE[start:SOURCE.index("\n}\n", start)]


def test_chunk_and_launches_match_the_source():
    assert _c_value("BWD_CHUNK") == RN.BWD_CHUNK == 64
    # two launches a call: the rows' kernel that `launch_bwd_nv` picks (a
    # branch each; the card's test counts the launches), then the chunk
    # sums' sum (a programmatic dependent launch that waits on the rows)
    outer = _body("int launch_bwd(")
    assert "<<<" not in outer and outer.count("cudaLaunchKernelEx(") == 1
    assert outer.index("launch_bwd_nv<") < outer.index("cudaLaunchKernelEx(")
    assert "&cfg, rmsnorm_bwd_sum_kernel," in outer
    assert "griddepcontrol.wait" in _body("rmsnorm_bwd_sum_kernel(")
    assert RN.BWD_LAUNCHES == 2


@settings(max_examples=200, deadline=None)
@given(rows=st.integers(1, 1 << 17), d=st.integers(1, 1 << 17),
       itemsize=st.sampled_from([2, 4]), aligned=st.booleans())
def test_every_plan_makes_a_launch_the_kernel_takes(rows, d, itemsize,
                                                    aligned):
    """Up to tpr = BWD_THREADS a block holds 256, 512 or 1024 threads, at
    least two rows a step (nv 1 or 2): the columns' sums, two stages of
    the rows' products and, in blocks of up to 512 threads on 16-byte
    vectors where a chunk takes 4 steps or more, the ring of BWD_AHEAD
    steps' x and dy fit BWD_SMEM bytes, at most 8192 elements a row (32-bit
    offsets in a chunk); wider rows (tpr 1024) take the walking kernel."""
    threads, ahead = _c_value("BWD_THREADS"), _c_value("BWD_AHEAD")
    assert re.search(r"constexpr int BWD_SMEM = 200 \* 1024;", SOURCE)
    vec, tpr, nv, _ = RN.rmsnorm_plan(rows, d, itemsize, aligned)
    if tpr <= threads:
        assert nv in (1, 2) and d <= 8192
        for block in (threads // 2, threads, 2 * threads):
            block = max(block, 2 * tpr)
            at_once = block // tpr
            assert block % tpr == 0 and block <= 1024 and at_once >= 2
            ring = block <= threads and vec > 1 and at_once <= RN.BWD_CHUNK // 4
            ring_bytes = (ahead * at_once * 2 * d * itemsize + 8 * ahead
                          if ring else 0)
            assert 4 * (-(-d // 4) * 4 + 2 * at_once * d) + ring_bytes \
                <= 200 * 1024
    else:
        assert tpr == 2 * threads


def _dscale_emulated(x, scale, dy, eps):
    """dscale in the kernel's order: r per row, each element's
    dy·(x·r) rounded to fp32; each chunk of `BWD_CHUNK` rows of a group
    summed row by row from 0, then the group's chunks in chunk order."""
    d = x.shape[-1]
    xf, gf = x.float().reshape(-1, d), dy.float().reshape(-1, d)
    rows = xf.shape[0]
    groups = scale.shape[0] if scale.dim() == 2 else 1
    gr = rows // groups
    r = 1.0 / torch.sqrt((xf * xf).sum(-1, keepdim=True) / d + eps)
    prod = gf * (xf * r)                       # fp32, each op rounded
    out = torch.empty((groups, d), dtype=torch.float32)
    for g in range(groups):
        parts = []
        for c0 in range(g * gr, (g + 1) * gr, RN.BWD_CHUNK):
            acc = torch.zeros(d, dtype=torch.float32)
            for row in range(c0, min(c0 + RN.BWD_CHUNK, (g + 1) * gr)):
                acc = acc + prod[row]
            parts.append(acc)
        assert len(parts) == RN.bwd_chunks(gr, gr)
        acc = torch.zeros(d, dtype=torch.float32)
        for part in parts:
            acc = acc + part
        out[g] = acc
    return out.reshape(scale.shape)


@pytest.mark.parametrize("shape,groups,dtype", [
    ((8, 32, 20, 48), 8, torch.bfloat16),    # train_lm's round, cut
    ((300, 64), 1, torch.float32),           # a ragged last chunk
    ((3, 100, 24), 3, torch.bfloat16)])      # groups of 100 rows
def test_emulated_order_within_the_bar(shape, groups, dtype):
    rng = np.random.default_rng(5)
    x, dy = (torch.from_numpy(rng.standard_normal(shape)
                              .astype(np.float32)).to(dtype)
             for _ in range(2))
    d = shape[-1]
    sc = torch.from_numpy(rng.random((groups, d) if groups > 1 else (d,))
                          .astype(np.float32))
    got = _dscale_emulated(x, sc, dy, 1e-5)
    _, want = RN.rmsnorm_bwd_plain(x, sc, dy, 1e-5)
    assert got.shape == want.shape
    assert not bool(((got - want).abs() > 1e-4 * (1 + want.abs())).any())
    assert RN.bwd_chunks(x.numel() // d, x.numel() // d // groups) \
        == groups * -(-(x.numel() // d // groups) // RN.BWD_CHUNK)


@pytest.mark.parametrize("cells", [2, 4])
def test_folded_cells_get_their_own_dscale(cells):
    """A call over ``cells`` cells (each N clients' rows, a scale row per
    client) gives each cell bitwise the dscale of that cell's own call:
    no chunk straddles a group."""
    rng = np.random.default_rng(6)
    n, b, s, d = 2, 3, 50, 40                # 150 rows a client
    x, dy = (torch.from_numpy(rng.standard_normal((cells * n, b, s, d))
                              .astype(np.float32)).bfloat16()
             for _ in range(2))
    sc = torch.from_numpy(rng.random((cells * n, d)).astype(np.float32))
    folded = _dscale_emulated(x, sc, dy, 1e-5)
    for c in range(cells):
        cut = slice(c * n, (c + 1) * n)
        assert torch.equal(folded[cut],
                           _dscale_emulated(x[cut], sc[cut], dy[cut], 1e-5))
