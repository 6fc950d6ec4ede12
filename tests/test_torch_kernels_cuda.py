"""The port's kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips itself without a card (it
decides inside the test, never at import).  The file imports no JAX and
nothing of the reference package, so it runs where only the port's
dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the GEMM matches `torch.einsum` within fp32 rounding of sums
taken in another order (1e-5 relative); the conv and both updates take
the reference's own bars (2e-5 forward, 2e-4 gradients, 2e-6 update).  The
case lists are shared with the CPU parity tests in `test_torch_kernels.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import batched_conv as TBC
from repro_torch.kernels import clip_sgd as TCS
from repro_torch.kernels import ops as TOPS

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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA/Triton kernels only run there")
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
