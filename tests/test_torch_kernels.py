"""The port's kernel modules against the JAX reference, on the CPU.

Same numpy-seeded inputs through both packages.  On the CPU the port's
wrappers run their kernels' plain PyTorch versions (the CUDA GEMM and the
Triton update only run on a card: `test_torch_kernels_cuda.py`), and
the reference runs its Pallas kernels in interpret mode, as its own tests
do.  Tolerances are the reference's own bars (`tests/test_kernels.py`):
2e-5 for the conv forward, 2e-4 for its gradients, 2e-6 for the fused
update — fp32 throughout, the two sides differing only in summation order.
The cases are shared with `test_torch_kernels_cuda.py` (kernel vs plain
on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro_torch.kernels import batched_conv as TBC
from repro_torch.kernels import clip_sgd as TCS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from test_torch_kernels_cuda import CONV_CASES, GAMMA, clip_cases

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
CLIP_TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _conv_operands(case, seed):
    n, b, h, w, cin, cout, stride = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((n, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal((n, cout)).astype(np.float32)
    return x, wt, bias, stride


@pytest.mark.parametrize("case", CONV_CASES)
def test_batched_conv_forward_matches_reference_kernel(case):
    x, wt, bias, stride = _conv_operands(case, seed=4)
    ref = ROPS.batched_conv(jnp.asarray(x), jnp.asarray(wt),
                            jnp.asarray(bias), stride=stride,
                            impl="interpret")
    out = TOPS.batched_conv(torch.from_numpy(x), torch.from_numpy(wt),
                            torch.from_numpy(bias), stride=stride)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("case", CONV_CASES)
def test_batched_conv_vjp_matches_reference(case):
    """`BatchedConv`'s hand-written backward (dx, dW, db through the GEMM)
    against jax.vjp of the reference's vmapped lax.conv oracle, with one
    cotangent row zeroed (a padded batch row)."""
    x, wt, bias, stride = _conv_operands(case, seed=5)
    out_r, vjp_r = jax.vjp(
        lambda *a: RREF.batched_conv_ref(*a, stride=stride),
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    dy = np.random.default_rng(6).standard_normal(out_r.shape).astype(
        np.float32)
    dy[0, -1] = 0.0
    grads_r = vjp_r(jnp.asarray(dy))

    args = [torch.from_numpy(a).requires_grad_() for a in (x, wt, bias)]
    out_t = TOPS.batched_conv(*args, stride=stride)
    grads_t = torch.autograd.grad(out_t, args, torch.from_numpy(dy))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_r),
                               **FWD_TOL)
    for g_t, g_r, name in zip(grads_t, grads_r, ("dx", "dw", "db")):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_r),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", CONV_CASES)
def test_grouped_conv_oracle_matches_reference_oracle(case):
    x, wt, bias, stride = _conv_operands(case, seed=8)
    ref = RREF.batched_conv_ref(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(bias), stride=stride)
    out = TREF.batched_conv_ref(torch.from_numpy(x), torch.from_numpy(wt),
                                torch.from_numpy(bias), stride=stride)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_batched_conv_skips_dx_for_inputs_without_grad():
    x, wt, bias, stride = _conv_operands(CONV_CASES[2], seed=9)
    w = torch.from_numpy(wt).requires_grad_()
    out = TOPS.batched_conv(torch.from_numpy(x), w, torch.from_numpy(bias),
                            stride=stride)
    (gw,) = torch.autograd.grad(out.sum(), [w])
    assert gw.shape == w.shape


@pytest.mark.parametrize("part,keep_spec", clip_cases())
def test_clip_sgd_matches_reference_kernel(part, keep_spec):
    """Every participation vector of N=4 (agg and non-agg sides), the
    fractional lone survivor, and the full cohort (``None``)."""
    rng = np.random.default_rng(7)
    n, d = 4, 300                        # non-pow2 D: the masked tail
    p = rng.standard_normal((n, d)).astype(np.float32)
    g = rng.standard_normal((n, d)).astype(np.float32)
    scale = rng.uniform(0.1, 1.0, (n,)).astype(np.float32)
    if part is None:
        keep = np.full((n,), keep_spec)
        w = None
    else:
        w = np.asarray(part, np.float32)
        keep = np.logical_and(keep_spec, w > 0)
    ref = ROPS.clip_sgd(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(scale),
        jnp.asarray(keep), None if w is None else jnp.asarray(w),
        gamma=GAMMA, impl="interpret")
    out = TOPS.clip_sgd(
        torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(scale),
        torch.from_numpy(keep), None if w is None else torch.from_numpy(w),
        gamma=GAMMA)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CLIP_TOL)


def test_cpu_tensors_take_the_plain_versions():
    TOPS.reset_launch_counts()
    x, wt, bias, stride = _conv_operands(CONV_CASES[0], seed=1)
    TOPS.batched_conv(torch.from_numpy(x), torch.from_numpy(wt),
                      torch.from_numpy(bias), stride=stride)
    p = torch.zeros((2, 5))
    TOPS.clip_sgd(p, torch.ones_like(p), torch.ones(2),
                  torch.ones(2, dtype=torch.bool), gamma=0.1)
    TOPS.clip_sgd(p, torch.ones_like(p), torch.ones(2),
                  torch.zeros(2, dtype=torch.bool), gamma=0.1,
                  common=torch.ones(5), use_common=True)
    assert TOPS.launch_counts() == {"batched_matmul": 0, "clip_sgd": 0,
                                    "clip_sgd_ext": 0}


def test_kernel_launchers_refuse_cpu_tensors():
    a = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        TBC.batched_matmul_kernel(a, torch.zeros((1, 3, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        TCS.clip_sgd_kernel(torch.zeros((2, 3)), torch.zeros((2, 3)),
                            torch.ones(2), torch.ones(2), gamma=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        TCS.clip_sgd_ext_kernel(torch.zeros((2, 3)), torch.zeros((2, 3)),
                                torch.ones(2), torch.ones(2), torch.zeros(3),
                                True, gamma=0.1)
