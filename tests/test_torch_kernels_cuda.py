"""The port's kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips itself without a card (it
decides inside the test, never at import).  The file imports no JAX and
nothing of the reference package, so it runs where only the port's
dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the GEMM matches `torch.einsum` within fp32 rounding of sums
taken in another order (1e-5 relative); the conv and both updates take
the reference's own bars (2e-5 forward, 2e-4 gradients, 2e-6 update), as
do the token-model kernels (flash attention 2e-5 fp32 / 2e-2 bf16,
RMSNorm 2e-2, mLSTM scan 2e-4 fp32 / 3e-2 bf16).  The case lists are
shared with the CPU parity tests in `test_torch_kernels.py`.  The HASFL
estimate's gradient moments are bitwise their emulated order
(`grad_moments_plain`) and within 1e-12 of the host path's numpy
(`estimate_constants`): the same fp64 sums taken in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.clip_sgd_ablation import vgg16_leaf_sizes
from repro_torch.kernels import batched_conv as TBC
from repro_torch.kernels import clip_sgd as TCS
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import grad_moments as TGM
from repro_torch.kernels import mlstm_scan as TMS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import rmsnorm as TRN

CONV_CASES = [
    # (n, b, h, w, cin, cout, stride) — the reference's CONV_CASES: N=1,
    # non-pow2 channels, odd spatial dims, stride 2
    (1, 2, 8, 8, 3, 5, 1),
    (3, 4, 16, 16, 3, 16, 1),
    (2, 4, 9, 9, 7, 11, 2),
    (4, 3, 8, 8, 4, 8, 2),
]
GAMMA = 0.05
GEMM_CASES = [
    # (n, m, k, c, transposed A) — ragged edges on every axis, K = 27 as
    # the first VGG conv, and the dW layout (A as a transposed view)
    (1, 5, 3, 7, False), (8, 1000, 27, 64, False), (3, 130, 577, 65, True),
    (2, 64, 4096, 64, True), (4, 257, 100, 129, False),
]


# the reference's own kernel cases (tests/test_kernels.py), dtypes by name
FLASH_CASES = [
    # (b, sq, sk, hq, hkv, hd, causal, window, dtype)
    (1, 128, 128, 4, 2, 64, True, 0, "float32"),
    (2, 64, 256, 8, 8, 32, True, 0, "float32"),
    (1, 96, 96, 4, 1, 128, True, 32, "float32"),
    (1, 128, 128, 2, 2, 64, False, 0, "float32"),
    (1, 200, 200, 3, 1, 64, True, 0, "float32"),     # ragged tiles
    (1, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (2, 32, 512, 4, 4, 64, True, 128, "bfloat16"),
]
MLSTM_CASES = [
    # (b, s, h, hd, dtype)
    (1, 64, 2, 32, "float32"),
    (2, 100, 2, 32, "float32"),
    (1, 96, 4, 64, "float32"),
    (1, 64, 2, 32, "bfloat16"),
]
RMSNORM_CASES = [
    ((4, 128), "float32"), ((3, 50, 96), "float32"),
    ((2, 17, 256), "bfloat16"), ((1, 1, 512), "bfloat16"),
]
# the decode form: (b, cache, hq, hkv, hd, pos) — one query token at
# position ``pos`` against a cache whose slots past ``pos`` are empty
DECODE_CASES = [(2, 16, 4, 2, 32, 9), (3, 40, 6, 3, 64, 0),
                (1, 33, 2, 1, 128, 32), (2, 20, 4, 4, 96, 13)]
# the shapes the last serving slice added, small: hd 96 (phi3), a
# non-causal encoder, a cross-attention with Sk != Sq, GQA groups 7
# (internvl2) and 16 (glm4): (b, sq, sk, hq, hkv, hd, causal, window,
# dtype)
FLASH_FAMILY_CASES = [
    (1, 128, 128, 4, 2, 96, True, 0, "float32"),
    (2, 70, 70, 4, 4, 96, True, 0, "bfloat16"),
    (1, 150, 150, 4, 4, 64, False, 0, "float32"),
    (2, 48, 150, 4, 4, 64, False, 0, "bfloat16"),
    (1, 64, 64, 14, 2, 64, True, 0, "float32"),
    (1, 64, 64, 32, 2, 128, True, 0, "bfloat16"),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
RMSNORM_TOL = 2e-2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def clip_cases():
    """Every participation vector of N=4 on both keep sides, the
    fractional lone survivor, and the full cohort (``None``)."""
    cases = [pytest.param(None, keep, id=f"full-keep{int(keep)}")
             for keep in (True, False)]
    for bits in range(16):
        part = [float((bits >> i) & 1) for i in range(4)]
        cases += [pytest.param(part, keep, id=f"part{bits:04b}-keep{int(keep)}")
                  for keep in (True, False)]
    cases += [pytest.param([0.0, 0.3, 0.0, 0.0], keep,
                           id=f"lone-fractional-keep{int(keep)}")
              for keep in (True, False)]
    return cases


CLIP_TOL = dict(rtol=2e-6, atol=2e-6)
# a round's leaves at a small size: the fc head (D = 10, no 16-byte
# vectors), a bias, a ragged width and a conv; per-leaf keep_spec mixed
LEAF_DS = (10, 64, 300, 1728)
LEAF_KEEPS = (True, False, False, True)


def leaf_cases():
    """(n, participation) of the round-update cases: every participation
    vector of N=4 (cnt == 0 among them), the fractional lone survivor, the
    full cohort, and N = 1, 3, 30 with the full cohort and with seeded
    fractional weights ("random", `leaf_weights`)."""
    cases = [pytest.param(4, None, id="n4-full")]
    cases += [pytest.param(4, [float((bits >> i) & 1) for i in range(4)],
                           id=f"n4-part{bits:04b}") for bits in range(16)]
    cases += [pytest.param(4, [0.0, 0.3, 0.0, 0.0], id="n4-lone-fractional")]
    cases += [pytest.param(n, w, id=f"n{n}-{w or 'full'}")
              for n in (1, 3, 30) for w in (None, "random")]
    return cases


def leaf_weights(rng, n, part):
    """The participation vector of a `leaf_cases` case (None, a list, or
    "random": fractional weights, every second client dropped)."""
    if part is None:
        return None
    if part == "random":
        w = rng.uniform(0.2, 1.0, (n,)).astype(np.float32)
        w[1::2] = 0.0
        return w
    return np.asarray(part, np.float32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels only run there")
    from repro_torch.device import disable_tf32

    disable_tf32()


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,c,transposed", GEMM_CASES)
def test_batched_matmul_kernel_matches_plain(n, m, k, c, transposed):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if transposed:
        a = torch.randn((n, k, m), device="cuda", generator=gen).transpose(1, 2)
    else:
        a = torch.randn((n, m, k), device="cuda", generator=gen)
    b = torch.randn((n, k, c), device="cuda", generator=gen)
    before = TBC.batched_matmul_kernel.launches
    out = TBC.batched_matmul_kernel(a, b)
    want = TBC.batched_matmul_plain(a, b)
    assert TBC.batched_matmul_kernel.launches == before + 1
    scale = float(want.abs().max())
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_batched_conv_kernel_matches_plain(case):
    _need_card()
    n, b, h, w, cin, cout, stride = case
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((n, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal((n, cout)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal(
        (n, b, -(-h // stride), -(-w // stride), cout)).astype(
            np.float32)).cuda()
    dy[0, -1] = 0.0                       # a masked/padded batch row
    results = []
    for fn in (lambda *a: TOPS.batched_conv(*a, stride=stride),
               lambda *a: TBC.batched_conv_plain(*a, stride=stride)):
        args = [torch.from_numpy(t).cuda().requires_grad_()
                for t in (x, wt, bias)]
        out = fn(*args)
        results.append((out.detach(), torch.autograd.grad(out, args, dy)))
    (out_k, g_k), (out_p, g_p) = results
    np.testing.assert_allclose(out_k.cpu().numpy(), out_p.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    for a, b_, name in zip(g_k, g_p, ("dx", "dw", "db")):
        np.testing.assert_allclose(a.cpu().numpy(), b_.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("part,keep_spec", clip_cases())
def test_clip_sgd_kernel_matches_plain(part, keep_spec):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, d = 4, 300
    p = torch.randn((n, d), device="cuda", generator=gen)
    g = torch.randn((n, d), device="cuda", generator=gen)
    scale = torch.rand(n, device="cuda", generator=gen)
    w = None if part is None else torch.tensor(part, device="cuda")
    keep = torch.full((n,), keep_spec, device="cuda") if w is None \
        else (w > 0) & keep_spec
    want = TCS.clip_sgd_plain(p, g, scale, keep, w, gamma=GAMMA)
    got = TCS.clip_sgd_kernel(p.clone(), g, scale, keep, w, gamma=GAMMA)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-6, atol=2e-6)


EXT_KEEPS = ("all", "none", "mixed")


@pytest.mark.cuda
@pytest.mark.parametrize("use_common", [True, False], ids=["u1", "u0"])
@pytest.mark.parametrize("keep", EXT_KEEPS)
@pytest.mark.parametrize("d", [1, 300, 4099])
@pytest.mark.parametrize("n", [1, 3, 16])
def test_clip_sgd_ext_kernel_matches_plain(n, d, keep, use_common):
    """Kernel 3 (the external-mean update of mesh mode) against its plain
    version: N_local 1, 3, 16; D = 1 and ragged D; every (u, keep)
    combination; updated in place with one counted launch."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n * 7919 + d)
    p = torch.randn((n, d), device="cuda", generator=gen)
    g = torch.randn((n, d), device="cuda", generator=gen)
    scale = torch.rand(n, device="cuda", generator=gen)
    common = torch.randn(d, device="cuda", generator=gen)
    keep_vec = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
                "none": torch.zeros(n, dtype=torch.bool, device="cuda"),
                "mixed": torch.arange(n, device="cuda") % 2 == 0}[keep]
    u = torch.tensor(use_common, device="cuda")
    want = TCS.clip_sgd_ext_plain(p, g, scale, keep_vec, common, u,
                                  gamma=GAMMA)
    target = p.clone()
    before = TCS.clip_sgd_ext_kernel.launches
    got = TOPS.clip_sgd(target, g, scale, keep_vec, None, gamma=GAMMA,
                        common=common, use_common=u)
    torch.cuda.synchronize()
    assert TCS.clip_sgd_ext_kernel.launches == before + 1
    assert got.data_ptr() == target.data_ptr()          # in place
    np.testing.assert_allclose(target.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-6, atol=2e-6)
    if keep == "none" and not use_common:
        np.testing.assert_array_equal(target.cpu().numpy(),
                                      p.cpu().numpy())   # holds params


@pytest.mark.cuda
@pytest.mark.parametrize("use_common", [True, False], ids=["u1", "u0"])
@pytest.mark.parametrize("keep", EXT_KEEPS)
@pytest.mark.parametrize("d", [1, 300, 4099])
def test_clip_sgd_ext_kernel_bf16_matches_plain(d, keep, use_common):
    """Kernel 3 on bf16 leaves with a bf16 mean (mesh mode on a token
    model: the two-tier combine runs in the leaf's type; the wrapper
    widens the mean): against the plain version in fp32 rounded once to
    bf16 (the kernel's arithmetic), within one bf16 ulp; aligned and
    ragged D."""
    _need_card()
    n = 8
    gen = torch.Generator(device="cuda").manual_seed(d)
    bf = torch.bfloat16
    p = torch.randn((n, d), device="cuda", generator=gen).to(bf)
    g = torch.randn((n, d), device="cuda", generator=gen).to(bf)
    scale = torch.rand(n, device="cuda", generator=gen)
    common = torch.randn(d, device="cuda", generator=gen).to(bf)
    keep_vec = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
                "none": torch.zeros(n, dtype=torch.bool, device="cuda"),
                "mixed": torch.arange(n, device="cuda") % 2 == 0}[keep]
    u = torch.tensor(use_common, device="cuda")
    want = TCS.clip_sgd_ext_plain(p.float(), g.float(), scale, keep_vec,
                                  common.float(), u, gamma=GAMMA).to(bf)
    target = p.clone()
    got = TOPS.clip_sgd(target, g, scale, keep_vec, None, gamma=GAMMA,
                        common=common, use_common=u)
    torch.cuda.synchronize()
    assert got.data_ptr() == target.data_ptr() and got.dtype == bf
    diff = (target.float() - want.float()).abs()
    assert bool((diff <= 2 ** -7 * want.float().abs()).all())


def _round_case(seed, n, ds, part, ext, keeps=None):
    """Card inputs of one round's update over leaves of ``ds`` columns:
    (ps, gs, scale, keep_specs, participation, commons, count)."""
    rng = np.random.default_rng(seed)
    w = leaf_weights(rng, n, part)
    ps = [torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
          .cuda() for d in ds]
    gs = [torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
          .cuda() for d in ds]
    scale = torch.from_numpy(rng.uniform(0.1, 1.0, (n,)).astype(np.float32))
    scale = scale.cuda()
    keeps = keeps or [bool(k) for k in rng.integers(0, 2, len(ds))]
    w = None if w is None else torch.from_numpy(w).cuda()
    commons = count = None
    if ext:
        w_eff = torch.ones(n, device="cuda") if w is None else w
        count = w_eff.sum()
        commons = [((p - GAMMA * (g * scale[:, None])) * w_eff[:, None]).sum(0)
                   / torch.where(count > 0, count, 1.0)
                   for p, g in zip(ps, gs)]
    return ps, gs, scale, keeps, w, commons, count


def _shifted(p):
    """A copy of ``p`` that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(p.numel() + 1, device=p.device)
    buf[1:] = p.reshape(-1)
    return buf[1:].view(p.shape)


def _check_round(case, launches, clone=torch.clone):
    """The one-launch update against the plain loop: in place (on copies
    made by ``clone``), within the reference's bar, ``launches`` counted
    launches."""
    ps, gs, scale, keeps, w, commons, count = case
    want = TCS.clip_sgd_leaves_plain(ps, gs, scale, keeps, w, gamma=GAMMA,
                                     commons=commons, count=count)
    targets = [clone(p) for p in ps]
    kernel = TCS.clip_sgd_kernel if commons is None \
        else TCS.clip_sgd_ext_kernel
    before = kernel.launches
    got = TOPS.clip_sgd_leaves(targets, gs, scale, keeps, w, gamma=GAMMA,
                               commons=commons, count=count)
    torch.cuda.synchronize()
    assert kernel.launches == before + launches
    for i, (t, o, x) in enumerate(zip(targets, got, want)):
        assert o.data_ptr() == t.data_ptr()                 # in place
        np.testing.assert_allclose(t.cpu().numpy(), x.cpu().numpy(),
                                   err_msg=f"leaf {i}", **CLIP_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True], ids=["flat", "ext"])
@pytest.mark.parametrize("n", [8, 16])
def test_clip_sgd_leaves_kernel_matches_plain_on_vgg16(n, ext):
    """A VGG-16 round's 32 leaves in one launch, mixed keeps, with
    participation weights (every second client dropped)."""
    _need_card()
    _check_round(_round_case(n, n, vgg16_leaf_sizes(), "random", ext), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True], ids=["flat", "ext"])
@pytest.mark.parametrize("n,part", leaf_cases())
def test_clip_sgd_leaves_kernel_matches_plain(n, part, ext):
    """The CPU parity cases (N = 1, 3, 4, 30; cnt == 0; fractional lone
    survivor) on the card, in one launch."""
    _need_card()
    _check_round(_round_case(7 + n, n, LEAF_DS, part, ext,
                             keeps=list(LEAF_KEEPS)), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True], ids=["flat", "ext"])
def test_clip_sgd_leaves_kernel_takes_misaligned_leaves(ext):
    """``[N, D]`` leaves 4 bytes off a 16-byte boundary take single
    elements, as does D % 4 != 0; aligned ones take vectors."""
    _need_card()
    n, ds = 3, (64, 1728, 300, 10)
    ps, gs, scale, keeps, w, commons, count = _round_case(
        5, n, ds, "random", ext)
    shifted = [_shifted(p) for p in ps]
    tabs, _ = TCS.tables(shifted, gs, scale, keeps, w, gamma=GAMMA,
                         commons=commons, use=count, use_is_count=True)
    assert [tabs[0].leaf[i].flags >> 1 for i in range(len(ds))] == [0] * 4
    tabs, _ = TCS.tables(ps, gs, scale, keeps, w, gamma=GAMMA,
                         commons=commons, use=count, use_is_count=True)
    assert [tabs[0].leaf[i].flags >> 1 for i in range(len(ds))] == \
        [1, 1, 1, 0]
    _check_round((ps, gs, scale, keeps, w, commons, count), 1,
                 clone=_shifted)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True], ids=["flat", "ext"])
def test_clip_sgd_leaves_kernel_past_its_capacity(ext):
    """More leaves than a launch's table holds: ceil(L / capacity)
    launches, every leaf updated."""
    _need_card()
    rng = np.random.default_rng(3)
    ds = [int(d) for d in rng.integers(1, 3000, 2 * TCS.CAPACITY + 5)]
    _check_round(_round_case(9, 3, ds, None, ext),
                 -(-len(ds) // TCS.CAPACITY))


# (M, K, C) of VGG-16's split-K dW shapes at b = 64 (32x32 images)
SPLIT_K_DW = {"conv1.dW": (27, 65536, 64), "conv2.dW": (576, 65536, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPLIT_K_DW))
def test_folded_gemm_planned_per_cell_is_bitwise_per_cell(name,
                                                          record_property):
    """G=4 cells of N=8 folded into one call planned at ``plan_n=8`` equal
    the four one-cell calls to the bit.  Planned at n=32 (no ``plan_n``)
    the call takes fewer splits; whether that moves a bit is recorded
    (``unplanned_*``), not asserted."""
    _need_card()
    cells, n = 4, 8
    m, k, c = SPLIT_K_DW[name]
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn((cells * n, k, m), device="cuda",
                    generator=gen).transpose(1, 2)
    b = torch.randn((cells * n, k, c), device="cuda", generator=gen)
    before = TBC.batched_matmul_kernel.launches
    folded = TBC.batched_matmul_kernel(a, b, plan_n=n)
    assert TBC.batched_matmul_kernel.launches == before + 1
    alone = torch.cat([TBC.batched_matmul_kernel(a[i * n:(i + 1) * n],
                                                 b[i * n:(i + 1) * n])
                       for i in range(cells)])
    assert torch.equal(folded, alone)
    unplanned = TBC.batched_matmul_kernel(a, b)
    torch.cuda.synchronize()
    record_property("unplanned_splits",
                    TBC.gemm_splits(cells * n, m, k, c)[0])
    record_property("planned_splits",
                    TBC.gemm_splits(cells * n, m, k, c, plan_n=n)[0])
    record_property("unplanned_bitwise", bool(torch.equal(unplanned, alone)))
    record_property("unplanned_max_abs_diff",
                    float((unplanned - alone).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("part", [None, "random"], ids=["full", "partial"])
def test_folded_clip_sgd_round_is_bitwise_per_cell(part):
    """One folded round of G=4 cells of N=8 over the 32 VGG-16 leaves, a
    keep list a cell: ⌈G·32/64⌉ = 2 launches, each cell bitwise equal to
    its own one-cell launch, and within the bar of the plain cells."""
    _need_card()
    cells, n = 4, 8
    ds = vgg16_leaf_sizes()
    ps, gs, scale, _, w, _, _ = _round_case(11, cells * n, ds, part, False)
    rng = np.random.default_rng(12)
    keeps = [[bool(x) for x in rng.integers(0, 2, len(ds))]
             for _ in range(cells)]
    folded = [p.clone() for p in ps]
    before = TCS.clip_sgd_kernel.launches
    TOPS.clip_sgd_leaves(folded, gs, scale, keeps, w, gamma=GAMMA,
                         cells=cells)
    torch.cuda.synchronize()
    assert TCS.clip_sgd_kernel.launches == \
        before + -(-cells * len(ds) // TCS.CAPACITY)
    want = TCS.clip_sgd_leaves_plain(ps, gs, scale, keeps, w, gamma=GAMMA,
                                     cells=cells)
    for c in range(cells):
        rows = slice(c * n, (c + 1) * n)
        alone = [p[rows].clone() for p in ps]
        TOPS.clip_sgd_leaves(alone, [g[rows] for g in gs], scale[rows],
                             keeps[c], None if w is None else w[rows],
                             gamma=GAMMA)
        torch.cuda.synchronize()
        for i, (f, a) in enumerate(zip(folded, alone)):
            assert torch.equal(f[rows], a), (c, i)
    for f, x in zip(folded, want):
        np.testing.assert_allclose(f.cpu().numpy(), x.cpu().numpy(),
                                   **CLIP_TOL)


def _randn(gen, shape, dtype, device="cuda"):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,dtype",
                         FLASH_CASES + FLASH_FAMILY_CASES + [
                             # qwen3-1.7b prefill at full width
                             (8, 512, 512, 16, 8, 128, True, 0, "bfloat16")])
def test_flash_attention_kernel_matches_plain(b, sq, sk, hq, hkv, hd, causal,
                                              window, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = DTYPES[dtype]
    q = _randn(gen, (b, sq, hq, hd), dt)
    k, v = (_randn(gen, (b, sk, hkv, hd), dt) for _ in range(2))
    before = TFA.flash_attention_kernel.launches
    got = TOPS.flash_attention(q, k, v, causal=causal, window=window)
    want = TFA.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert TFA.flash_attention_kernel.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,hq,hkv,hd,pos", DECODE_CASES + [
    (8, 544, 16, 8, 128, 512)])   # qwen3-1.7b's first decode step
def test_flash_attention_decode_form_matches_plain(b, c, hq, hkv, hd, pos,
                                                   dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = DTYPES[dtype]
    q = _randn(gen, (b, 1, hq, hd), dt)
    k, v = (_randn(gen, (b, c, hkv, hd), dt) for _ in range(2))
    got = TFA.flash_attention_kernel(q, k, v, causal=False, sk_valid=pos + 1)
    want = TFA.flash_attention_plain(q, k, v, causal=False, sk_valid=pos + 1)
    _close(got, want, FLASH_TOL[dtype])


def _decode_positions(layout, b, c, rng):
    """(k_pos [B, C], cur_pos [B], window) of a stored-position decode
    case: ``ring`` a ring of C slots wrapped past its end (slot p % C holds
    p), ``empty`` a cache filled at its start (the rest -1), ``window`` a
    wrapped ring under a window shorter than C, ``per_seq`` each row at
    its own position (row 0 with one valid key), ``middle`` valid keys
    only in the cache's middle tiles (the first and last tiles empty)."""
    k_pos = np.full((b, c), -1, np.int64)
    cur = np.zeros(b, np.int64)
    window = 0
    for i in range(b):
        if layout in ("ring", "window"):
            end = c + 37 + 5 * i               # positions [0, end) written
            for p in range(end):
                k_pos[i, p % c] = p
            cur[i] = end - 1
            window = c // 2 + 3 if layout == "window" else 0
        elif layout == "empty":
            n = min(c, 7 + 11 * i)
            k_pos[i, :n] = np.arange(n)
            cur[i] = n - 1
        elif layout == "per_seq":
            n = 1 if i == 0 else int(rng.integers(2, c + 1))
            k_pos[i, :n] = np.arange(n)
            cur[i] = n - 1
        else:                                  # middle
            lo, hi = 40, c - 40
            k_pos[i, lo:hi] = np.arange(hi - lo)
            cur[i] = hi - lo - 1 - i
    return k_pos, cur, window


DECODE_POSITION_CASES = [
    # (b, c, hq, hkv, hd, layout)
    (2, 100, 4, 2, 64, "ring"), (3, 257, 16, 8, 128, "ring"),
    (2, 96, 8, 2, 64, "empty"), (1, 8192, 16, 8, 128, "window"),
    (3, 300, 32, 32, 96, "window"), (8, 576, 16, 8, 128, "per_seq"),
    (4, 200, 14, 2, 64, "per_seq"), (2, 160, 4, 1, 128, "middle"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,hq,hkv,hd,layout", DECODE_POSITION_CASES)
def test_flash_decode_stored_positions_match_plain(b, c, hq, hkv, hd, layout,
                                                   dtype):
    """The split-KV decode masking each slot by its stored position
    against its plain version (the reference's ``decode_attention``):
    wrapped rings, empty slots holding NaN, windows, rows at their own
    positions, empty tiles; one counted launch on the split-KV path,
    positions left on the card, bitwise repeatable."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = DTYPES[dtype]
    q = _randn(gen, (b, 1, hq, hd), dt)
    k, v = (_randn(gen, (b, c, hkv, hd), dt) for _ in range(2))
    k_pos, cur, window = _decode_positions(layout, b, c,
                                           np.random.default_rng(7))
    empty = torch.as_tensor(k_pos < 0, device="cuda")
    k[empty] = float("nan")              # empty slots must never be read
    v[empty] = float("nan")
    kp = torch.as_tensor(k_pos, dtype=torch.int32, device="cuda")
    cp = torch.as_tensor(cur, dtype=torch.int32, device="cuda")
    before = TFA.path_launches()
    got = TOPS.flash_decode(q, k, v, kp, cp, window=window)
    after = TFA.path_launches()
    want = TFA.flash_decode_plain(q, torch.nan_to_num(k), torch.nan_to_num(v),
                                  kp, cp, window=window)
    torch.cuda.synchronize()
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == "split_kv") for p in TFA.PATHS}
    assert torch.isfinite(got).all()
    _close(got, want, FLASH_TOL[dtype])
    assert torch.equal(got, TFA.flash_decode_kernel(q, k, v, kp, cp,
                                                    window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", RMSNORM_CASES + [
    ((8, 512, 2048), "bfloat16"), ((8, 512, 16, 128), "bfloat16"),
    ((8, 1, 2048), "float32"), ((5, 1000), "float32")])
def test_rmsnorm_kernel_matches_plain(shape, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = _randn(gen, shape, DTYPES[dtype])
    scale = torch.rand(shape[-1], generator=gen, device="cuda")
    before = TRN.rmsnorm_kernel.launches
    got = TOPS.rmsnorm(x, scale)
    want = TRN.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    assert TRN.rmsnorm_kernel.launches == before + 1
    assert got.dtype == x.dtype
    _close(got, want, RMSNORM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,dtype", MLSTM_CASES + [
    (8, 512, 4, 512, "bfloat16")])   # xlstm-350m prefill at full width
def test_mlstm_scan_kernel_matches_plain(b, s, h, hd, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    dt = DTYPES[dtype]
    q, k, v = (_randn(gen, (b, s, h, hd), dt) for _ in range(3))
    ig, fg = (torch.randn((b, s, h), generator=gen, device="cuda")
              for _ in range(2))
    before = TMS.mlstm_scan_kernel.launches
    got = TOPS.mlstm_scan(q, k, v, ig, fg)
    want = TMS.mlstm_scan_plain(q, k, v, ig, fg)
    torch.cuda.synchronize()
    assert TMS.mlstm_scan_kernel.launches == before + 1
    _close(got, want, MLSTM_TOL[dtype])


@pytest.mark.cuda
def test_token_kernels_refuse_wrong_types_and_shapes():
    _need_card()
    f32 = torch.zeros((1, 4, 2, 32), device="cuda")
    bf = f32.to(torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 or"):
        TFA.flash_attention_kernel(f32, bf, bf)
    with pytest.raises(ValueError, match="hd"):
        TFA.flash_attention_kernel(*(torch.zeros((1, 4, 2, 48),
                                                 device="cuda"),) * 3)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 4, 32), device="cuda").transpose(1, 2)
        TFA.flash_attention_kernel(t, t, t)
    with pytest.raises(ValueError, match="sk_valid"):
        TFA.flash_attention_kernel(f32, f32, f32, sk_valid=5)
    with pytest.raises(ValueError, match="aligned"):
        off = torch.zeros(1 + 4 * 2 * 32, device="cuda")[1:].view(1, 4, 2, 32)
        TFA.flash_attention_kernel(f32, off, off)
    with pytest.raises(ValueError, match="scale"):
        TRN.rmsnorm_kernel(f32, torch.ones(16, device="cuda"))
    with pytest.raises(ValueError, match="fp32"):
        TRN.rmsnorm_kernel(f32.half(), torch.ones(32, device="cuda"))
    gates = torch.zeros((1, 4, 2), device="cuda")
    with pytest.raises(ValueError, match="gates"):
        TMS.mlstm_scan_kernel(bf, bf, bf, gates.to(torch.bfloat16), gates)
    with pytest.raises(ValueError, match="shapes"):
        TMS.mlstm_scan_kernel(f32, f32, f32, gates[:, :3], gates)


# the redesigned kernels' own edges: the path each call takes, split-KV
# decode with mostly empty splits, the tensor-core prefill off its row tile
# and with window + sk_valid, split-K at K not divisible by its split count

FLASH_PATH_CASES = [
    # (b, sq, sk, hq, hkv, hd, causal, window, sk_valid, dtype, path)
    (1, 128, 128, 4, 2, 32, True, 0, None, "bfloat16", "tc"),
    (1, 128, 128, 4, 2, 64, True, 0, None, "bfloat16", "tc"),
    (1, 77, 77, 3, 1, 128, True, 0, None, "bfloat16", "tc"),
    (2, 100, 100, 6, 2, 64, True, 0, None, "bfloat16", "tc"),
    (2, 150, 300, 4, 2, 128, True, 40, 120, "bfloat16", "tc"),
    (2, 96, 200, 4, 2, 64, False, 0, 150, "bfloat16", "tc"),
    (1, 130, 130, 9, 3, 64, True, 0, None, "bfloat16", "tc"),
    (2, 64, 256, 8, 8, 32, True, 0, None, "float32", "fp32"),
    (8, 1, 544, 16, 8, 128, False, 0, 1, "bfloat16", "split_kv"),
    (8, 1, 544, 16, 8, 128, False, 0, 1, "float32", "split_kv"),
    (8, 1, 544, 16, 8, 128, False, 0, 513, "float32", "split_kv"),
    (2, 1, 4000, 16, 8, 128, False, 0, 3999, "bfloat16", "split_kv"),
    (2, 1, 300, 9, 3, 64, False, 0, 257, "bfloat16", "split_kv"),
    (1, 1, 100, 16, 1, 64, False, 0, 99, "float32", "split_kv"),
    (2, 1, 64, 4, 2, 64, True, 0, None, "bfloat16", "split_kv"),
    # the token families of the last serving slice at full width: phi3's
    # hd 96 (prefill, decode; fp32 prefill), whisper's encoder (1500 x
    # 1500, non-causal), its cross-attention (512 x 1500) and its decode
    # cross step (kv_end 1500), internvl2's group 7 and glm4's group 16
    (8, 512, 512, 32, 32, 96, True, 0, None, "bfloat16", "tc"),
    (8, 1, 544, 32, 32, 96, False, 0, 513, "bfloat16", "split_kv"),
    (2, 64, 64, 32, 32, 96, True, 0, None, "float32", "fp32"),
    (2, 1, 72, 32, 32, 96, False, 0, 65, "float32", "split_kv"),
    (8, 1500, 1500, 16, 16, 64, False, 0, None, "bfloat16", "tc"),
    (8, 512, 1500, 16, 16, 64, False, 0, None, "bfloat16", "tc"),
    (8, 1, 1500, 16, 16, 64, False, 0, None, "bfloat16", "split_kv"),
    (8, 512, 512, 14, 2, 64, True, 0, None, "bfloat16", "tc"),
    (8, 1, 544, 14, 2, 64, False, 0, 513, "bfloat16", "split_kv"),
    (8, 512, 512, 32, 2, 128, True, 0, None, "bfloat16", "tc"),
    (8, 1, 544, 32, 2, 128, False, 0, 513, "bfloat16", "split_kv"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,hd,causal,window,sk_valid,dtype,path", FLASH_PATH_CASES)
def test_flash_attention_paths_match_plain(b, sq, sk, hq, hkv, hd, causal,
                                           window, sk_valid, dtype, path):
    """Each case runs on its path (one counted launch there) and matches
    the plain version at the bar; the split-KV decode is bitwise
    repeatable (its combine runs in a fixed order)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = DTYPES[dtype]
    q = _randn(gen, (b, sq, hq, hd), dt)
    k, v = (_randn(gen, (b, sk, hkv, hd), dt) for _ in range(2))
    kw = dict(causal=causal, window=window, sk_valid=sk_valid)
    before = TFA.path_launches()
    got = TFA.flash_attention_kernel(q, k, v, **kw)
    after = TFA.path_launches()
    want = TFA.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in TFA.PATHS}
    _close(got, want, FLASH_TOL[dtype])
    if path == "split_kv":
        assert torch.equal(got, TFA.flash_attention_kernel(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,c,transposed", [
    (2, 33, 5000, 70, True),      # odd M, a transposed view, 3 splits
    (8, 27, 65536, 64, True),     # conv1.dW: M = 27, K = 27 · 2^11
    (3, 129, 3333, 17, False),    # K prime to the split count, ragged C
    (1, 1, 1500, 1, True)])
def test_batched_matmul_split_k_matches_plain_and_repeats(n, m, k, c,
                                                          transposed):
    _need_card()
    assert TBC.gemm_splits(n, m, k, c)[0] > 1
    gen = torch.Generator(device="cuda").manual_seed(6)
    if transposed:
        a = torch.randn((n, k, m), device="cuda", generator=gen).transpose(1, 2)
    else:
        a = torch.randn((n, m, k), device="cuda", generator=gen)
    b = torch.randn((n, k, c), device="cuda", generator=gen)
    before = TBC.batched_matmul_kernel.launches
    out = TBC.batched_matmul_kernel(a, b)
    assert TBC.batched_matmul_kernel.launches == before + 1
    want = TBC.batched_matmul_plain(a, b)
    scale = float(want.abs().max())
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(), rtol=0,
                               atol=1e-5 * scale * max(1.0, (k / 1024) ** 0.5))
    assert torch.equal(out, TBC.batched_matmul_kernel(a, b))


# the mLSTM scan's two paths (bf16: the parallel form on the tensor cores;
# fp32: the recurrence), each against the plain recurrence at the bar:
# (b, s, h, hd, dtype, gates, path); gates "normal" are N(0, 1) pre-
# activations, "extreme" forget pre-activations of ±30 and input ones at
# -1e30 in the first steps and at random, so that D underflows and the
# stabilizer takes the input gate's branch
MLSTM_PATH_CASES = [
    (8, 512, 4, 512, "bfloat16", "normal", "tc"),     # xlstm-350m prefill
    (1, 200, 2, 512, "bfloat16", "normal", "tc"),     # S off the 64-row tile
    (1, 96, 4, 64, "bfloat16", "normal", "tc"),
    (2, 100, 2, 32, "bfloat16", "normal", "tc"),
    (1, 130, 2, 128, "bfloat16", "extreme", "tc"),
    (2, 70, 2, 256, "bfloat16", "extreme", "tc"),
    (2, 64, 4, 512, "float32", "normal", "recurrent"),
    (1, 130, 2, 64, "float32", "extreme", "recurrent"),
]


def mlstm_gates(gen, shape, kind, device="cuda"):
    """(i_gate, f_gate) fp32 pre-activations of ``kind`` (see above)."""
    ig = torch.randn(shape, generator=gen, device=device)
    fg = torch.randn(shape, generator=gen, device=device)
    if kind == "extreme":
        sign = torch.rand(shape, generator=gen, device=device) < 0.5
        fg = torch.where(sign, 30.0, -30.0)
        off = torch.rand(shape, generator=gen, device=device) < 0.3
        ig = torch.where(off, -1e30, ig * 5)
        ig[:, :3] = -1e30
    return ig, fg


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,dtype,gates,path", MLSTM_PATH_CASES)
def test_mlstm_scan_paths_match_plain(b, s, h, hd, dtype, gates, path):
    """Each case runs on its path (one counted launch there) and matches
    the plain recurrence at the bar; the tensor-core path is bitwise
    repeatable (no atomics)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = DTYPES[dtype]
    q, k, v = (_randn(gen, (b, s, h, hd), dt) for _ in range(3))
    ig, fg = mlstm_gates(gen, (b, s, h), gates)
    before = TMS.path_launches()
    got = TMS.mlstm_scan_kernel(q, k, v, ig, fg)
    after = TMS.path_launches()
    want = TMS.mlstm_scan_plain(q, k, v, ig, fg)
    torch.cuda.synchronize()
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in TMS.PATHS}
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, MLSTM_TOL[dtype])
    if path == "tc":
        assert torch.equal(got, TMS.mlstm_scan_kernel(q, k, v, ig, fg))


@pytest.mark.cuda
def test_mlstm_tc_path_matches_parallel_plain():
    """The tensor-core kernel against the plain parallel form with the same
    roundings (fp64 prefix, P as two bf16 parts in PV), at xlstm's head
    width."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (_randn(gen, (2, 192, 2, 512), torch.bfloat16)
               for _ in range(3))
    ig, fg = mlstm_gates(gen, (2, 192, 2), "normal")
    _close(TMS.mlstm_scan_kernel(q, k, v, ig, fg),
           TMS.mlstm_parallel_plain(q, k, v, ig, fg), MLSTM_TOL["bfloat16"])


# kernel 6's backward: (b, s, h, hd, dtype, gates); bf16 on the tensor
# cores, fp32 on the CUDA cores, each against the plain formulas in fp64
MLSTM_BWD_CASES = [
    (1, 64, 2, 32, "float32", "normal"),
    (2, 100, 2, 64, "float32", "normal"),
    (1, 64, 2, 32, "bfloat16", "normal"),
    (2, 200, 4, 512, "bfloat16", "normal"),
    (2, 256, 4, 512, "bfloat16", "extreme"),
    (1, 130, 2, 512, "float32", "extreme"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,dtype,gates", MLSTM_BWD_CASES)
def test_mlstm_scan_bwd_kernel_matches_plain(b, s, h, hd, dtype, gates):
    """Kernel 6's backward from the forward's h, a and m (h bitwise
    serving's): one counted launch on its path, every gradient finite and
    within 2e-5·max|plain| at fp32 (dq and dk sum terms that cancel at
    extreme gates) and 3e-2·max|plain| at bf16, bitwise repeatable; and
    `ops.mlstm_scan` under grad reaches it through `MLSTMScanFn`."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    dt = DTYPES[dtype]
    q, k, v = (_randn(gen, (b, s, h, hd), dt) for _ in range(3))
    ig, fg = mlstm_gates(gen, (b, s, h), gates)
    hh, a, m = TMS.mlstm_scan_kernel(q, k, v, ig, fg, stats=True)
    assert torch.equal(hh, TMS.mlstm_scan_kernel(q, k, v, ig, fg))
    dh = _randn(gen, hh.shape, dt)
    ins = (q, k, v, ig, fg, hh, a, m, dh)
    path = "tc" if dtype == "bfloat16" else "fp32"
    before = TMS.bwd_path_launches()
    got = TMS.mlstm_scan_bwd_kernel(*ins)
    after = TMS.bwd_path_launches()
    want = TMS.mlstm_scan_bwd_plain(*ins)
    torch.cuda.synchronize()
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == path) for p in TMS.BWD_PATHS}
    bar = 2e-5 if dtype == "float32" else 3e-2
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g.float() - w.float()).abs().max()) \
            <= bar * float(w.float().abs().max())
    assert all(torch.equal(g, x)
               for g, x in zip(got, TMS.mlstm_scan_bwd_kernel(*ins)))
    # the kernel launches of one call, as the kernel's library counts them
    launched = TMS.bwd_kernel_launches()
    TMS.mlstm_scan_bwd_kernel(*ins)
    assert TMS.bwd_kernel_launches() - launched == TMS.BWD_LAUNCHES[path]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, ig, fg)]
    before = TMS.mlstm_scan_bwd_kernel.launches
    TOPS.mlstm_scan(*leaves).backward(dh)
    assert TMS.mlstm_scan_bwd_kernel.launches == before + 1
    assert all(torch.equal(t.grad, g) for t, g in zip(leaves, got))


# RMSNorm on each plan: (shape, dtype, offset in elements, expected plan
# kind) — 16-byte vectors with a row in part of a warp, a row over several
# warps, single elements (d · itemsize not a multiple of 16, or x
# misaligned), and a row too wide for registers (read twice)
RMSNORM_PLAN_CASES = [
    ((8, 512, 2048), "bfloat16", 0, "row_split"),
    ((65536, 128), "bfloat16", 0, "vector"),
    ((4096, 96), "bfloat16", 0, "vector"),
    ((8, 1, 2048), "bfloat16", 0, "row_split"),
    ((8, 1, 1024), "float32", 0, "row_split"),
    ((7, 100), "bfloat16", 0, "scalar"),
    ((300, 50), "float32", 0, "scalar"),
    ((64, 256), "float32", 1, "scalar"),
    ((2, 65536), "float32", 0, "streamed"),
]


def _plan_kind(plan):
    vec, tpr, nv, _ = plan
    if nv == 0:
        return "streamed"
    if vec == 1:
        return "scalar"
    return "row_split" if tpr > 32 else "vector"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,offset,kind", RMSNORM_PLAN_CASES)
def test_rmsnorm_plans_match_plain(shape, dtype, offset, kind):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    dt = DTYPES[dtype]
    n = int(np.prod(shape))
    x = _randn(gen, (n + offset,), dt)[offset:].view(shape)
    scale = torch.rand(shape[-1], generator=gen, device="cuda")
    rows, d = n // shape[-1], shape[-1]
    aligned = (x.data_ptr() | scale.data_ptr()) % 16 == 0
    plan = TRN.rmsnorm_plan(rows, d, x.element_size(), aligned)
    assert _plan_kind(plan) == kind
    before = TRN.rmsnorm_kernel.launches
    got = TRN.rmsnorm_kernel(x, scale)
    want = TRN.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    assert TRN.rmsnorm_kernel.launches == before + 1
    _close(got, want, RMSNORM_TOL)


# ---------------------------------------------------------------------------
# the dynamic edge on the card: kill-and-resume and traffic runs bitwise
# against their uninterrupted runs (small VGG; both kernels on the path)
# ---------------------------------------------------------------------------

def _dynamic_spec(**over):
    import dataclasses

    import repro_torch.config as TC
    from repro_torch.api import ExperimentSpec

    base = TC.get_config("vgg9-cifar-small")
    TC.register(dataclasses.replace(
        base, arch_id="vgg9-card-dynamic", conv_channels=(8, 16, 16),
        fc_dims=(32,), image_size=16))
    kw = dict(arch="vgg9-card-dynamic", n_clients=4, partition="iid",
              n_train=200, n_test=50, rounds=6, eval_every=2,
              policy="hasfl", estimate=True,
              sfl=TC.SFLConfig(lr=0.05, agg_interval=2))
    kw.update(over)
    return ExperimentSpec(**kw)


def _dynamic_bitwise(spec, ckpt_dir, step):
    """(uninterrupted, resumed) sessions and results of ``spec`` on the
    card, the second resumed from its snapshot at ``step``, with the
    launch counts of the uninterrupted run."""
    from repro_torch.api import Session

    whole = Session(spec)
    TOPS.reset_launch_counts()
    r = whole.run()
    launches = TOPS.launch_counts()
    ck = spec.replace(checkpoint_every=step, checkpoint_dir=ckpt_dir)
    Session(ck).run()
    resumed = Session.resume(ck, step=step)
    return whole, r, resumed, resumed.run(), launches


def _assert_runs_bitwise(a, b, sa, sb):
    from repro_torch.utils.tree import tree_leaves

    assert a.rounds == b.rounds and a.clock == b.clock
    assert a.train_loss == b.train_loss and a.test_loss == b.test_loss
    assert a.test_acc == b.test_acc
    assert all(np.array_equal(x, y) for x, y in zip(a.b_history,
                                                     b.b_history))
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(sa.sim._stacked), tree_leaves(sb.sim._stacked)))


@pytest.mark.cuda
def test_kill_and_resume_is_bitwise_on_the_card(tmp_path):
    _need_card()
    spec = _dynamic_spec(scenario="churn-heavy", scenario_seed=7,
                         fault_mode="deadline", deadline_factor=2.0)
    whole, r, resumed, res, launches = _dynamic_bitwise(
        spec, str(tmp_path / "snaps"), 2)
    _assert_runs_bitwise(r, res, whole, resumed)
    assert launches["batched_matmul"] > 0
    assert launches["clip_sgd"] == spec.rounds


@pytest.mark.cuda
def test_traffic_run_and_resume_are_bitwise_on_the_card(tmp_path):
    _need_card()
    from repro_torch.api import TrafficSpec

    spec = _dynamic_spec(policy="fixed", estimate=False, n_clients=3,
                         traffic=TrafficSpec(
                             n_users=500, arrival_rate=300.0,
                             mean_dwell=0.02, shard_size=40, seed=3))
    whole, r, resumed, res, launches = _dynamic_bitwise(
        spec, str(tmp_path / "snaps"), 2)
    _assert_runs_bitwise(r, res, whole, resumed)
    a, b = whole.plane.log, resumed.plane.log
    assert (a.time, a.kind, a.slot, a.user) == (b.time, b.kind, b.slot,
                                                b.user)
    assert a.counts()["admit"] > spec.n_clients and a.counts()["evict"] > 0
    assert launches["clip_sgd"] == spec.rounds


# ---------------------------------------------------------------------------
# The training kernels: kernel 4's lse and backward, kernel 5's grouped
# scale and backward, kernel 2 on bf16 leaves.  Tolerances: dQ, dK, dV
# within 2e-5·(1+|plain|) at fp32 (sums in another order) and
# 3e-2·max|plain| at bf16 (the gradients rounded once to bf16, the plain
# version's inputs the same bf16 values); RMSNorm's dx within
# 2e-5·(1+|plain|) at fp32 and the forward's 2e-2 at bf16, dscale within
# 1e-4·(1+|plain|) (fp32 sums over thousands of rows in another order);
# kernel 2 on bf16 leaves within one bf16 ulp (2^-7 relative at most) of
# its plain version run in fp32 and rounded once, as the kernel computes
# (the client mean's fp32 sum runs in another order, so a value at a
# rounding boundary may round to its neighbour).
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = FLASH_CASES + [
    (1, 128, 128, 4, 4, 96, True, 0, "float32"),     # phi3's hd 96
    (2, 70, 70, 4, 4, 96, True, 0, "bfloat16"),
    (2, 48, 100, 16, 1, 64, True, 0, "float32"),     # GQA group 16, sq < sk
    (1, 100, 60, 4, 2, 32, True, 16, "float32"),     # sq > sk with a window:
                                                     # rows 75-99 see no key
    # smollm-135m and qwen3-1.7b training shapes
    (128, 128, 128, 9, 3, 64, True, 0, "bfloat16"),
    (8, 512, 512, 16, 8, 128, True, 0, "bfloat16"),
    # the wgmma tiling's edges (128-key dK/dV blocks, 128-row dQ blocks,
    # 64-row and 64-key steps): hd 32 and 96 padded, hd 128 native
    (2, 130, 130, 4, 2, 32, True, 0, "bfloat16"),
    (1, 190, 190, 6, 2, 96, True, 0, "bfloat16"),
    (2, 256, 256, 4, 4, 128, False, 0, "bfloat16"),
    # ragged and non-causal, whisper's encoder length, its cross-attention
    (2, 200, 200, 4, 4, 64, False, 0, "bfloat16"),
    (1, 1500, 1500, 2, 2, 64, False, 0, "bfloat16"),
    (2, 128, 1500, 4, 4, 64, False, 0, "bfloat16"),
    # a window with a GQA group of 2, causal and not
    (2, 300, 300, 4, 2, 64, True, 100, "bfloat16"),
    (1, 300, 300, 4, 2, 128, False, 70, "bfloat16"),
    # GQA groups of 6 (dbrx 48/8) and 7 (internvl2 14/2)
    (1, 256, 256, 12, 2, 128, True, 0, "bfloat16"),
    (2, 192, 192, 14, 2, 64, True, 0, "bfloat16"),
    # sq > sk under a causal window: rows that see no key get zero dQ
    (1, 300, 100, 4, 2, 64, True, 48, "bfloat16"),
]


def _rel_close(got, want, dtype):
    g, w = got.float(), want.float()
    if dtype == "float32":
        bad = (g - w).abs() > 2e-5 * (1 + w.abs())
    else:
        bad = (g - w).abs() > 3e-2 * w.abs().max()
    assert not bool(bad.any()), float((g - w).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,dtype",
                         FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(b, sq, sk, hq, hkv, hd,
                                                  causal, window, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = DTYPES[dtype]
    q = _randn(gen, (b, sq, hq, hd), dt)
    k, v = (_randn(gen, (b, sk, hkv, hd), dt) for _ in range(2))
    do = _randn(gen, (b, sq, hq, hd), dt)
    o, lse = TFA.flash_attention_kernel(q, k, v, causal=causal,
                                        window=window, lse=True)
    _, lse_plain = TFA.flash_attention_plain(q, k, v, causal=causal,
                                             window=window, lse=True)
    # a row with no visible key has lse -inf on the kernel and
    # -1e30 + log Sk on the plain version: compared on the live rows only
    live = TFA._visible(sq, sk, causal, window, None,
                        q.device).expand(sq, sk).any(-1)
    _close(lse[..., live], lse_plain[..., live],
           1e-4 if dtype == "float32" else 2e-3)
    before = TFA.flash_attention_bwd_kernel.launches
    got = TFA.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    want = TFA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    assert TFA.flash_attention_bwd_kernel.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        _rel_close(g, w, dtype)
    # the rows that see no key get no gradient
    assert bool((got[0][:, ~live] == 0).all())
    again = TFA.flash_attention_bwd_kernel(q, k, v, o, lse, do,
                                           causal=causal, window=window)
    for g, a in zip(got, again):     # no atomics: bitwise repeatable
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,hq,hkv,hd,causal,window", [
    (128, 128, 9, 3, 64, True, 0),       # smollm-135m, folded by grid_lm
    (200, 200, 4, 2, 128, True, 0),
    (130, 300, 4, 4, 64, False, 0),
    (300, 300, 6, 2, 96, True, 64)])
def test_flash_attention_bwd_batch_is_its_slices_bitwise(sq, sk, hq, hkv, hd,
                                                        causal, window):
    """The backward at B = 4 equals the four B = 1 calls on the batch's
    slices bitwise (its tiling never reads the batch: grid_lm folds cells
    into attention's batch and holds each folded cell to its own run)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    dt = torch.bfloat16
    q = _randn(gen, (4, sq, hq, hd), dt)
    k, v = (_randn(gen, (4, sk, hkv, hd), dt) for _ in range(2))
    do = _randn(gen, (4, sq, hq, hd), dt)
    kw = dict(causal=causal, window=window)
    o, lse = TFA.flash_attention_kernel(q, k, v, lse=True, **kw)
    whole = TFA.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    for i in range(4):
        part = TFA.flash_attention_bwd_kernel(
            *(t[i:i + 1].contiguous() for t in (q, k, v, o, lse, do)), **kw)
        for w, p in zip(whole, part):
            assert torch.equal(w[i:i + 1], p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_function_carries_the_gradient(dtype):
    """`ops.flash_attention` on grad-requiring inputs goes through
    `FlashAttentionFn`: one forward and one backward launch, gradients
    equal to autograd through the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = DTYPES[dtype]
    q = _randn(gen, (2, 64, 4, 64), dt).requires_grad_()
    k, v = (_randn(gen, (2, 64, 2, 64), dt).requires_grad_()
            for _ in range(2))
    do = _randn(gen, (2, 64, 4, 64), dt)
    fwd = TFA.flash_attention_kernel.launches
    bwd = TFA.flash_attention_bwd_kernel.launches
    TOPS.flash_attention(q, k, v, causal=True).backward(do)
    got = [t.grad.clone() for t in (q, k, v)]
    assert TFA.flash_attention_kernel.launches == fwd + 1
    assert TFA.flash_attention_bwd_kernel.launches == bwd + 1
    for t in (q, k, v):
        t.grad = None
    TFA.flash_attention_plain(q, k, v, causal=True).backward(do)
    for g, t in zip(got, (q, k, v)):
        _rel_close(g, t.grad, dtype)


RMSNORM_BWD_CASES = [(s, d, 1) for s, d in RMSNORM_CASES] + [
    ((8, 128, 576), "bfloat16", 8),          # smollm-135m, scale [N, d]
    ((2, 4, 512, 16, 128), "bfloat16", 2),   # qwen3's qk-norm, [N, hd]
    ((4096, 2048), "bfloat16", 1),
    ((5, 1000), "float32", 5),
    ((3, 7, 50), "float32", 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,groups", RMSNORM_BWD_CASES)
def test_rmsnorm_bwd_kernel_matches_plain(shape, dtype, groups):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = _randn(gen, shape, DTYPES[dtype])
    dy = _randn(gen, shape, DTYPES[dtype])
    d = shape[-1]
    scale = torch.rand((groups, d) if groups > 1 else (d,), generator=gen,
                       device="cuda")
    _close(TRN.rmsnorm_kernel(x, scale), TRN.rmsnorm_plain(x, scale),
           RMSNORM_TOL)
    before = TRN.rmsnorm_bwd_kernel.launches
    dx, ds = TRN.rmsnorm_bwd_kernel(x, scale, dy)
    pdx, pds = TRN.rmsnorm_bwd_plain(x, scale, dy)
    torch.cuda.synchronize()
    assert TRN.rmsnorm_bwd_kernel.launches == before + 1
    assert dx.dtype == x.dtype and ds.shape == scale.shape
    if dtype == "float32":
        assert not bool(((dx - pdx).abs() > 2e-5 * (1 + pdx.abs())).any())
    else:
        _close(dx, pdx, RMSNORM_TOL)
    assert not bool(((ds - pds).abs() > 1e-4 * (1 + pds.abs())).any())
    dx2, ds2 = TRN.rmsnorm_bwd_kernel(x, scale, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    # the kernel launches of one call, as the kernel's library counts them
    launched = TRN.bwd_kernel_launches()
    TRN.rmsnorm_bwd_kernel(x, scale, dy)
    assert TRN.bwd_kernel_launches() - launched == TRN.BWD_LAUNCHES


@pytest.mark.cuda
def test_grad_requiring_inputs_take_the_functions_or_raise():
    """RMSNorm with a grad-requiring input runs `RMSNormFn` (a forward and
    a backward launch), and so does the mLSTM scan `MLSTMScanFn`."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = _randn(gen, (4, 16, 64), torch.bfloat16).requires_grad_()
    scale = torch.rand((4, 64), generator=gen,
                       device="cuda").requires_grad_()
    fwd, bwd = TRN.rmsnorm_kernel.launches, TRN.rmsnorm_bwd_kernel.launches
    TOPS.rmsnorm(x, scale).float().sum().backward()
    assert TRN.rmsnorm_kernel.launches == fwd + 1
    assert TRN.rmsnorm_bwd_kernel.launches == bwd + 1
    assert x.grad is not None and scale.grad is not None
    q = torch.zeros((1, 8, 2, 32), device="cuda", requires_grad=True)
    g = torch.zeros((1, 8, 2), device="cuda")
    fwd = TMS.mlstm_scan_kernel.launches
    bwd = TMS.mlstm_scan_bwd_kernel.launches
    TOPS.mlstm_scan(q, q, q, g, g).sum().backward()
    assert TMS.mlstm_scan_kernel.launches == fwd + 1
    assert TMS.mlstm_scan_bwd_kernel.launches == bwd + 1
    assert q.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("n,part", [(8, None), (4, [1.0, 0.0, 1.0, 0.5])])
def test_clip_sgd_leaves_kernel_takes_bf16_leaves(n, part):
    """A token round's leaves: bf16 weights (ragged and vector widths)
    beside fp32 norm scales in one launch, past the table's capacity."""
    _need_card()
    rng = np.random.default_rng(9)
    ds = [576, 10, 4096, 300] * 20
    dts = [torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16] * 20
    keeps = [bool(i % 3 == 0) for i in range(len(ds))]
    ps = [torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
          .to("cuda", dt) for d, dt in zip(ds, dts)]
    gs = [torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
          .to("cuda", dt) for d, dt in zip(ds, dts)]
    scale = torch.from_numpy(rng.uniform(0.2, 1.0, n).astype(np.float32)) \
        .cuda()
    w = None if part is None else torch.tensor(part, device="cuda")
    want = TCS.clip_sgd_leaves_plain(
        [p.float() for p in ps], [g.float() for g in gs], scale, keeps, w,
        gamma=GAMMA)
    before = TCS.clip_sgd_kernel.launches
    got = TCS.clip_sgd_leaves_kernel([p.clone() for p in ps], gs, scale,
                                     keeps, w, gamma=GAMMA)
    torch.cuda.synchronize()
    assert TCS.clip_sgd_kernel.launches == before + 2   # 80 leaves, 64 a table
    for g, wv, dt in zip(got, want, dts):
        assert g.dtype == dt
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   wv.to(dt).float().cpu().numpy(),
                                   rtol=2 ** -7, atol=1e-6)


# ---------------------------------------------------------------------------
# the HASFL estimate's per-unit gradient moments (csrc/grad_moments.cu)
# against the host path's numpy, and the controller on either path
# ---------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
_VGG16 = vgg16_leaf_sizes()
GRAD_MOMENT_CASES = {
    # unit after unit, its leaves as (elements, dtype, offset into a
    # buffer: misaligned for the 16-byte vectors where not 0)
    "fp32": [[(4096, F32, 0), (64, F32, 0)], [(20000, F32, 0)]],
    "bf16": [[(9000 * 8, BF16, 0), (576, F32, 0)], [(576, BF16, 0)],
             [(24576, BF16, 0)]],
    "ragged": [[(10, F32, 0), (8195, F32, 0)], [(8199, BF16, 0),
                                                (7, BF16, 0)]],
    "misaligned": [[(4096, F32, 1), (16384, BF16, 3)], [(1, F32, 0)]],
    "one_element": [[(1, F32, 0)], [(1, BF16, 0)]],
    "vgg16": [[(d, F32, 0) for d in _VGG16[i:i + 2]]
              for i in range(0, len(_VGG16), 2)],
    # 300 leaves in one pair of launches: the table lives in device
    # memory, so a launch is not held to a table passed by value
    # (clip_sgd's `CAPACITY` of 64)
    "many_leaves": [[(37 * (u + 1), F32, 0), (128, BF16, 0), (5, F32, 0)]
                    for u in range(100)],
}


def _grad_samples(spec, k, seed, zero=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(k):
        units = []
        for u, unit in enumerate(spec):
            leaves = []
            for i, (n, dtype, offset) in enumerate(unit):
                x = torch.randn(n + offset, device="cuda", generator=gen) \
                    * 10.0 ** ((u + i) % 5 - 2)
                x = torch.zeros_like(x) if zero else x
                leaves.append(x.to(dtype)[offset:])
            units.append(leaves)
        out.append(units)
    return out


def _host_moments(samples):
    from repro_torch.core.convergence import estimate_constants
    from repro_torch.scenarios.controller import _flat_grad

    est = estimate_constants([[_flat_grad(u) for u in s] for s in samples])
    return np.stack([est["g_sq"], est["sigma_sq"]], axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("case,k", [(c, 3) for c in sorted(
    GRAD_MOMENT_CASES)] + [("bf16", 2), ("ragged", 4), ("fp32", 1)])
def test_grad_moments_kernel_matches_the_host_path(case, k):
    _need_card()
    samples = _grad_samples(GRAD_MOMENT_CASES[case], k, seed=len(case) + k)
    before = TGM.grad_moments_kernel.launches
    got = TGM.grad_moments_kernel(samples)
    again = TGM.grad_moments_kernel(samples)
    torch.cuda.synchronize()
    assert TGM.grad_moments_kernel.launches == before + 2 * TGM.LAUNCHES
    got, again = got.cpu().numpy(), again.cpu().numpy()
    assert np.array_equal(got.view(np.int64), again.view(np.int64))
    assert np.array_equal(got, TGM.grad_moments_plain(samples))
    want = _host_moments(samples)
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want))
    assert (want[:, 0] > 0).all() and (want[:, 1] > 0).all() == (k > 1)


@pytest.mark.cuda
def test_grad_moments_kernel_of_a_zero_gradient_is_zero():
    _need_card()
    samples = _grad_samples(GRAD_MOMENT_CASES["vgg16"], 3, 0, zero=True)
    got = TGM.grad_moments_kernel(samples).cpu().numpy()
    assert got.shape == (16, 2) and not got.any()


@pytest.mark.cuda
def test_grad_moments_kernel_refuses_mixed_samples():
    _need_card()
    a = _grad_samples(GRAD_MOMENT_CASES["fp32"], 2, 0)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        TGM.grad_moments_kernel([a[0], [[t.cpu() for t in u] for u in a[1]]])
    with pytest.raises(ValueError, match="fp32 or bf16"):
        TGM.grad_moments_kernel([a[0], [[t.double() for t in u]
                                        for u in a[1]]])


@pytest.mark.cuda
def test_controller_estimate_on_the_card_matches_the_host_path(monkeypatch):
    """A small VGG's HASFL controller on the card (the kernel) beside one
    fed the same three gradient samples copied to the host (numpy), over
    the decisions of a 6-round run: each decision's per-layer G²/σ² within
    1e-12, the blended constants too, (b, cuts) bitwise, and only the
    ``[units, 2]`` fp64 moments copied to the host."""
    _need_card()
    from repro_torch import trace as T
    from repro_torch.api import Session
    from repro_torch.scenarios import controller as C
    from repro_torch.utils.tree import tree_map

    spec = _dynamic_spec()
    sess = Session(spec)
    sim = sess.sim
    kernel, estimate = C.grad_moments_kernel, C.estimate_profile_constants
    seen, ests = [], []

    def spy_kernel(samples):
        seen.append(samples)
        return kernel(samples)

    def spy_estimate(*args, **kw):
        ests.append(estimate(*args, **kw))
        return ests[-1]

    monkeypatch.setattr(C, "grad_moments_kernel", spy_kernel)
    monkeypatch.setattr(C, "estimate_profile_constants", spy_estimate)
    card = C.HASFLController(sess.profile, sess.sfl, seed=5)
    host = C.HASFLController(sess.profile, sess.sfl, seed=5)
    n_units = len(sim.units)
    decisions = []

    def both(sim, rng):
        before = T.counts().get("estimate_bytes_to_host", 0)
        b, cuts = card(sim, rng)
        sent = T.counts()["estimate_bytes_to_host"] - before
        on_host = iter([[tree_map(lambda t: t.detach().cpu(), u) for u in s]
                        for s in seen.pop()])
        sim._grad_fn = lambda units, batch: ((None, None), next(on_host))
        try:
            hb, hcuts = host(sim, rng)
        finally:
            del sim._grad_fn
        decisions.append((sent, (b, cuts), (hb, hcuts), ests[-2], ests[-1],
                          card.profile.g_sq.copy(), host.profile.g_sq.copy(),
                          card.profile.sigma_sq.copy(),
                          host.profile.sigma_sq.copy()))
        return b, cuts

    sim.run(both, rounds=spec.rounds, eval_every=spec.eval_every,
            reconfigure_every=spec.reconfigure_every)
    assert len(decisions) >= 3 and not seen
    for sent, (b, cuts), (hb, hcuts), e_card, e_host, *blended in decisions:
        assert sent == n_units * 2 * 8
        assert np.array_equal(b, hb) and np.array_equal(cuts, hcuts)
        for key in ("g_sq", "sigma_sq"):
            assert np.all(np.abs(e_card[key] - e_host[key])
                          <= 1e-12 * np.abs(e_host[key]))
        gc, gh, sc, sh = blended
        assert np.all(np.abs(gc - gh) <= 1e-12 * np.abs(gh))
        assert np.all(np.abs(sc - sh) <= 1e-12 * np.abs(sh))
