"""The bf16 mLSTM scan backward's launch plan and arithmetic, on the CPU.

`mlstm_bwd_plan`, `bwd_score_tile` and `bwd_product_steps` mirror the
constants, shared-memory formulas and block walks of
``csrc/mlstm_scan_bwd.cu``, which only the card runs.  Here: the
constants, the formulas and the launch sites are read back from the
source and agree with the plan; every head dim fits the H100's shared
memory; the scores' blocks visit every causal tile once and the products'
blocks walk exactly the live tiles, heaviest first; and an emulation of
the bf16 path's arithmetic (P' and dS split into bf16 high and low parts,
every product from bf16 operands into fp32) stays within the bf16 bar
(3e-2·max|plain|) of `mlstm_scan_bwd_plain` at normal and extreme gates.
"""
import math
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import build
from repro_torch.kernels import mlstm_scan as MS

SMEM_PER_BLOCK = 232_448    # the H100's shared memory for one block
SMEM_PER_SM = 233_472       # ... for all blocks of one SM (1 KB a block
                            # reserved)
SOURCE = (build.CSRC / "mlstm_scan_bwd.cu").read_text()
CONSTANTS = {"T": MS.TILE, "WG": MS.BWD_WG, "SC_STAGES": MS.BWD_SC_STAGES,
             "PR_STAGES": MS.BWD_PR_STAGES,
             "GATE_THREADS": MS.BWD_GATE_THREADS,
             "GATE_STAGE": MS.BWD_GATE_STAGE}


def _c_value(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m, f"{name} not found in mlstm_scan_bwd.cu"
    return int(eval(m.group(1), {}, {}))


def _c_function(fn: str):
    """``constexpr int fn(...) { return ...; }`` of the source as a Python
    function of the same parameters (one ``a ? b : c`` read as ``(b if a
    else c)``), the source's constants bound."""
    m = re.search(rf"constexpr int {fn}\(([^)]*)\) {{\s*return ([^;]+);",
                  SOURCE)
    assert m, f"{fn} not found in mlstm_scan_bwd.cu"
    params = [p.split()[-1] for p in m.group(1).split(",") if p.strip()]
    expr = " ".join(m.group(2).split())
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.split(":", 1)
        expr = f"({a.strip()} if {cond.strip()} else {b.strip()})"
    return lambda *args: eval(expr, {}, dict(CONSTANTS,
                                             **dict(zip(params, args))))


def _body(signature: str) -> str:
    """The source text of the function that starts with ``signature``, up
    to its closing brace at column 0."""
    start = SOURCE.index(signature)
    return SOURCE[start:SOURCE.index("\n}\n", start)]


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_plan_constants_match_the_source(name):
    assert _c_value(name) == CONSTANTS[name]


@pytest.mark.parametrize("hd", MS.HEAD_DIMS)
def test_plan_shared_memory_matches_the_source_and_fits(hd):
    plan = MS.mlstm_bwd_plan(8, 512, 4, hd)
    hdp = _c_function("hdp")(hd)
    consumers = _c_function("consumers")(hdp)
    assert (plan["hdp"], plan["consumers"]) == (hdp, consumers)
    # one or two warpgroups of wgmma m64nNk16: N a multiple of 64 up to 256
    assert plan["n"] * consumers == hdp and plan["n"] in (64, 128, 256)
    assert plan["scores_smem"] == _c_function("scores_smem")()
    assert plan["products_smem"] == _c_function("products_smem")(hdp)
    assert max(plan["scores_smem"], plan["products_smem"]) <= SMEM_PER_BLOCK
    # the scores run two blocks an SM (their static scalars beside)
    assert 2 * (plan["scores_smem"] + 64 * 24 + 1024) <= SMEM_PER_SM
    assert plan["products_threads"] == consumers * 128 + 32 <= 1024
    assert plan["scores_threads"] == 160


def test_launch_sites_match_the_plan():
    """Four launches a bf16 call, six an fp32 one (the three products of
    the fp32 path are one site in a loop of three)."""
    tc = _body("int launch_tc(")
    f32 = _body("int launch_f32(")
    assert len(re.findall(r"<<<", tc)) == MS.BWD_LAUNCHES["tc"] == 4
    assert len(re.findall(r"<<<", f32)) == 4
    assert "for (int i = 0; i < 3; ++i) {\n    gemm_f32<HD><<<" in f32
    assert MS.BWD_LAUNCHES["fp32"] == 6
    # the bf16 path has no mma.sync left
    assert "mma.sync" not in SOURCE and "gemm_tc" not in SOURCE


def test_plan_at_the_training_shapes():
    # xlstm-350m's train_xlstm step and xlstm_session round
    plan = MS.mlstm_bwd_plan(8, 512, 4, 512)
    assert plan["scores_grid"] == (36, 32)
    assert plan["products_grid"] == (96, 8)
    assert plan["gates_grid"] == (8, 32)
    assert plan["prep_grid"] == (32 + 8 * 512 * 4 // 8,)
    assert MS.mlstm_bwd_plan(64, 64, 4, 512)["products_grid"] == (768, 1)


@settings(max_examples=60, deadline=None)
@given(s=st.integers(1, 2048))
def test_walks_visit_the_causal_tiles(s):
    tiles = -(-s // MS.TILE)
    plan = MS.mlstm_bwd_plan(1, s, 1, 64)
    pairs = plan["scores_grid"][0]
    seen = [MS.bwd_score_tile(i) for i in range(pairs)]
    causal = {(tt, st_) for tt in range(tiles) for st_ in range(tt + 1)}
    assert len(seen) == len(set(seen)) and set(seen) == causal
    for prod in range(3):
        owned, work = [], []
        for rank in range(plan["products_grid"][1]):
            rt, steps = MS.bwd_product_steps(prod, rank, tiles)
            owned.append(rt)
            work.append(len(steps))
            # the (query tile, key tile) of each step is live and every
            # live tile of the output tile is a step
            tiles_read = {(j, rt) if prod < 2 else (rt, j) for j in steps}
            live = {p for p in causal if p[1 if prod < 2 else 0] == rt}
            assert tiles_read == live and len(steps) == len(live)
        assert sorted(owned) == list(range(tiles))
        assert work == sorted(work, reverse=True)   # heaviest first


def _split(x):
    """``x`` (fp32) as its bf16 high part and the bf16 rounding of the
    rest, each back in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulated_bwd(q, k, v, ig, fg, h, a, m, dh):
    """The bf16 path's arithmetic on the CPU: S and E from the bf16
    operands in fp32, D from the fp64 prefix rounded once, P' and dS in
    fp32 and then each split into bf16 high and low parts, the three
    products as high and low parts against the bf16 dH, Q and K into fp32,
    di and df from dP·P as the plain version sums them."""
    b, s, nh, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    _, g, m_run, m_pf = MS.mlstm_gate_prefix(ig, fg)
    mc = m_run + (m.double() - m_pf.double())
    g, mc = (t.permute(0, 2, 1) for t in (g, mc))
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    d = torch.where(causal, torch.exp((g[:, :, None, :]
                                       - mc[:, :, :, None]).float()), 0.0)
    qf, kf, vf, dhf = (t.float() for t in (q, k, v, dh))
    sv = torch.einsum("bthd,bshd->bhts", qf, kf)
    ev = torch.einsum("bthd,bshd->bhts", dhf, vf)
    af = a.permute(0, 2, 1)
    floor = torch.exp(-m.permute(0, 2, 1))
    inv = 1.0 / torch.maximum(af.abs(), floor)
    delta = -(dhf * h.float()).sum(-1).permute(0, 2, 1) * inv
    da = torch.where(af.abs() >= floor, torch.where(af > 0, delta, -delta),
                     0.0)
    pr = torch.where(causal, sv * scale * d, 0.0)
    dp = torch.where(causal, ev * inv[..., None] + da[..., None], 0.0)
    p_hi, p_lo = _split(pr * inv[..., None])
    s_hi, s_lo = _split(dp * d)
    dv = sum(torch.einsum("bhts,bthd->bshd", x, dhf) for x in (p_hi, p_lo))
    dk = sum(torch.einsum("bhts,bthd->bshd", x, qf) for x in (s_hi, s_lo))
    dq = sum(torch.einsum("bhts,bshd->bthd", x, kf) for x in (s_hi, s_lo))
    qq = (dp * pr).double()
    di = qq.sum(2)
    before = torch.where(causal, qq.cumsum(-1) - qq, 0.0)
    df = before.sum(2) * torch.sigmoid(-fg.double()).permute(0, 2, 1)
    return (dq * scale, dk * scale, dv,
            *(t.permute(0, 2, 1).float() for t in (di, df)))


@pytest.mark.parametrize("gates", ["normal", "extreme"])
@pytest.mark.parametrize("b,s,h,hd", [(1, 96, 2, 64), (2, 70, 2, 32)])
def test_bf16_arithmetic_within_the_bar(b, s, h, hd, gates):
    rng = np.random.default_rng(17)
    q, k, v, dh = (torch.from_numpy(rng.standard_normal((b, s, h, hd))
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    ig, fg = (torch.from_numpy(rng.standard_normal((b, s, h))
                               .astype(np.float32)) for _ in range(2))
    if gates == "extreme":
        fg = torch.from_numpy(rng.choice([-30.0, 30.0], (b, s, h))
                              .astype(np.float32))
        ig = torch.where(torch.from_numpy(rng.random((b, s, h)) < 0.3),
                         -1e30, ig * 5)
        ig[:, :3] = -1e30
    hh, a, m = MS.mlstm_parallel_plain(q, k, v, ig, fg, stats=True)
    ins = (q, k, v, ig, fg, hh, a, m, dh)
    got = _emulated_bwd(*ins)
    want = MS.mlstm_scan_bwd_plain(*ins)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - w.float()).abs().max()) \
            <= 3e-2 * float(w.float().abs().max())
