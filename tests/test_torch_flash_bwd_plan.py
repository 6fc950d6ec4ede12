"""The bf16 flash-attention backward's launch plan, on the CPU.

`flash_bwd_plan` and the live-tile ranges (`bwd_q_range`, `bwd_k_range`)
mirror the constants and loop bounds of ``csrc/flash_attention_bwd.cu``
(namespace ``tcb``), which only the card runs.  Here: the constants and
the shared-memory formulas are read back from the source and agree with
the plan; every instance fits the H100's shared memory; the plan reads no
batch; and the live ranges walk exactly the tiles that hold a visible
(q, k) pair under `_visible`'s masks (causal, window, ``sq != sk``).
"""
import inspect
import re

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA

SMEM_PER_BLOCK = 232_448    # the H100's shared memory for one block
SMEM_PER_SM = 233_472       # ... for all blocks of one SM (1 KB a block
                            # reserved)
SOURCE = (build.CSRC / "flash_attention_bwd.cu").read_text()
TCB = SOURCE[SOURCE.index("namespace tcb {"):]
CONSTANTS = {"THREADS": FA.BWD_THREADS, "BLOCKS": FA.BWD_BLOCKS_PER_SM,
             "BKV": FA.BWD_KEYS, "BQQ": FA.BWD_ROWS, "STAGES": FA.BWD_STAGES}


def _c_value(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", TCB)
    assert m, f"tcb::{name} not found in flash_attention_bwd.cu"
    return int(eval(m.group(1), {}, dict(CONSTANTS)))


def _c_function(fn: str):
    """``constexpr int fn(...) { return ...; }`` of the source as a Python
    function of the same parameters (one ``a ? b : c`` read as ``(b if a
    else c)``), the source's constants bound."""
    m = re.search(rf"constexpr int {fn}\(([^)]*)\) {{\s*return ([^;]+);",
                  TCB)
    assert m, f"tcb::{fn} not found in flash_attention_bwd.cu"
    params = [p.split()[-1] for p in m.group(1).split(",")]
    expr = " ".join(m.group(2).split()).replace("&&", "and")
    if "?" in expr:
        cond, rest = expr.split("?", 1)
        a, b = rest.split(":", 1)
        expr = f"({a.strip()} if {cond.strip()} else {b.strip()})"
    env = dict(CONSTANTS, LONG=FA.BWD_LONG)
    return lambda *args: eval(expr, {}, dict(env, **dict(zip(params, args))))


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_plan_constants_match_the_source(name):
    assert _c_value(name) == CONSTANTS[name]


@pytest.mark.parametrize("length", [64, 128, 129, 1500])
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_plan_shared_memory_matches_the_source_and_fits(hd, length):
    plan = FA.flash_bwd_plan(length, length, 16, 8, hd, True, 0)
    hdp = 64 if hd <= 64 else 128
    assert plan["hdp"] == hdp
    step = _c_function("tc_step")(hdp, length)
    assert plan["dkdv_step"] == plan["dq_step"] == step \
        == FA.bwd_step(hd, length) == (128 if hdp == 64 and length > 128
                                       else 64)
    assert _c_value("LONG") == FA.BWD_LONG
    assert plan["stages"] >= 2     # a copy lands while products run
    for kernel in ("dkdv", "dq"):
        c_bytes = _c_function(f"{kernel}_smem")(hdp, step)
        assert plan[f"{kernel}_smem"] == c_bytes
        # two blocks an SM, each with its 1 KB reserve
        assert plan["blocks_per_sm"] * (c_bytes + 1024) <= SMEM_PER_SM
        assert c_bytes <= SMEM_PER_BLOCK
    assert plan["threads"] == _c_value("THREADS") == 128


def test_plan_reads_no_batch():
    params = list(inspect.signature(FA.flash_bwd_plan).parameters)
    assert params == ["sq", "sk", "hq", "hkv", "hd", "causal", "window"]
    # the batch is the grids' last axis alone, in both launches
    launch = TCB[TCB.index("int launch_steps("):]
    grids = re.findall(r"const dim3 (g\d)\(([^;]+)\);", launch)
    assert [g for g, _ in grids] == ["g1", "g2"]
    for _, dims in grids:
        dims = [d.strip() for d in dims.split(",")]
        assert dims[-1] == "static_cast<unsigned>(b)"
        assert all("(b)" not in d for d in dims[:-1])


@pytest.mark.parametrize("shape", [
    # (sq, sk, hq, hkv, hd, causal, window): the recorded training shapes
    (512, 512, 16, 8, 128, True, 0), (1500, 1500, 16, 16, 64, False, 0),
    (128, 1500, 16, 16, 64, False, 0), (512, 512, 14, 2, 64, True, 0),
    (512, 512, 48, 8, 128, True, 0), (128, 128, 9, 3, 64, True, 0),
    (256, 256, 32, 8, 128, True, 0), (70, 70, 4, 4, 96, True, 0)])
def test_plan_at_the_training_shapes(shape):
    sq, sk, hq, hkv, hd, causal, window = shape
    plan = FA.flash_bwd_plan(*shape)
    assert (plan["dkdv_step"], plan["dq_step"]) == (FA.bwd_step(hd, sq),
                                                    FA.bwd_step(hd, sk))
    assert plan["dkdv_grid"] == (-(-sk // FA.BWD_KEYS), hkv)
    assert plan["dq_grid"] == (-(-sq // FA.BWD_ROWS), hq)
    assert max(plan["dkdv_smem"], plan["dq_smem"]) <= SMEM_PER_BLOCK
    # causal: the first key block walks every row step of every q head,
    # the last row block every key step
    if causal and sq == sk:
        step = FA.bwd_step(hd, sq)
        assert plan["dkdv_steps"] == -(-sq // step) * (hq // hkv)
        assert plan["dq_steps"] == -(-sq // step)


def _walked(begin: int, end: int, step: int):
    return [(t, t + step) for t in range(begin, end, step)]


def _check_walk(vis, walked, what):
    """``vis`` [rows, keys] of one block: the walked slices of its rows
    cover every row with a visible pair, and each holds one."""
    live = vis.any(dim=1)
    covered = torch.zeros_like(live)
    for lo, hi in walked:
        assert bool(live[lo:hi].any()), (what, lo, hi)
        covered[lo:hi] = True
    assert not bool((live & ~covered).any()), what


@settings(max_examples=150, deadline=None)
@given(sq=st.integers(1, 400), sk=st.integers(1, 400), causal=st.booleans(),
       window=st.one_of(st.just(0), st.integers(1, 300)),
       step=st.sampled_from([64, 128]))
def test_live_ranges_cover_every_visible_pair_and_no_empty_step(
        sq, sk, causal, window, step):
    vis = FA._visible(sq, sk, causal, window, None, "cpu").expand(sq, sk)
    # dK/dV: each key block walks the row steps that see one of its keys
    for k0 in range(0, sk, FA.BWD_KEYS):
        begin, end = FA.bwd_q_range(k0, sq, sk, causal, window)
        _check_walk(vis[:, k0:k0 + FA.BWD_KEYS], _walked(begin, end, step),
                    ("dkdv", k0))
    # dQ: each row block walks the key steps that one of its rows sees
    for q0 in range(0, sq, FA.BWD_ROWS):
        begin, end = FA.bwd_k_range(q0, sq, sk, causal, window, step)
        assert begin % step == 0
        _check_walk(vis[q0:q0 + FA.BWD_ROWS].t(), _walked(begin, end, step),
                    ("dq", q0))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48), (False, 200)])
def test_rows_that_see_no_key_walk_no_step(causal, window):
    # sq > sk: under a causal window the rows past the last key + window
    # see nothing; their dQ block walks no key step (and writes zeros)
    sq, sk = 400, 100
    vis = FA._visible(sq, sk, causal, window, None, "cpu").expand(sq, sk)
    for q0 in range(0, sq, FA.BWD_ROWS):
        begin, end = FA.bwd_k_range(q0, sq, sk, causal, window, 64)
        assert (end > begin) == bool(vis[q0:q0 + FA.BWD_ROWS].any())


def test_ablation_variants_apply_to_the_sources():
    # flash_ablation builds its variants by exact substitution; each must
    # still find its text (it raises if not)
    from repro_torch import flash_ablation as AB

    for subs in AB.VARIANTS_BWD.values():
        src = AB._variant_source(subs, "flash_attention_bwd.cu")
        assert all(new in src for _, new in subs)
    for subs in AB.VARIANTS.values():
        AB._variant_source(subs)
