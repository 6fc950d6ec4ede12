"""The port's kernel modules against the JAX reference, on the CPU.

Same numpy-seeded inputs through both packages.  On the CPU the port's
wrappers run their kernels' plain PyTorch versions (the CUDA kernels only
run on a card: `test_torch_kernels_cuda.py`), and
the reference runs its Pallas kernels in interpret mode, as its own tests
do.  Tolerances are the reference's own bars (`tests/test_kernels.py`):
2e-5 for the conv forward, 2e-4 for its gradients, 2e-6 for the fused
update — fp32 throughout, the two sides differing only in summation order.
The cases are shared with `test_torch_kernels_cuda.py` (kernel vs plain
on the card).  The token-model kernels (flash attention, RMSNorm, the
mLSTM scan) take the reference's own cases and bars: 2e-5 fp32 / 2e-2
bf16, 2e-2, and 2e-4 fp32 / 3e-2 bf16.
"""
import bisect
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ROPS
from repro.kernels import ref as RREF
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.mlstm_scan import mlstm_scan as r_mlstm
from repro.kernels.rmsnorm import rmsnorm as r_rmsnorm
from repro.models import attention as RATT
from repro.models.attention import decode_attention as r_decode_attention
import repro_torch.config as TC
from repro_torch.core import split as TSP
from repro_torch.kernels import batched_conv as TBC
from repro_torch.kernels import clip_sgd as TCS
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import launch as TLAUNCH
from repro_torch.kernels import mlstm_scan as TMS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import rmsnorm as TRN
from repro_torch.models import attention as TATT
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_kernels_cuda import (CONV_CASES, DECODE_CASES, FLASH_CASES,
                                     FLASH_FAMILY_CASES,
                                     FLASH_TOL, GAMMA, MLSTM_CASES, MLSTM_TOL,
                                     RMSNORM_CASES, RMSNORM_TOL, CLIP_TOL,
                                     LEAF_DS, LEAF_KEEPS, clip_cases,
                                     leaf_cases, leaf_weights,
                                     vgg16_leaf_sizes)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


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


def _round_leaves(rng, n, ds=LEAF_DS):
    ps = [rng.standard_normal((n, d)).astype(np.float32) for d in ds]
    gs = [rng.standard_normal((n, d)).astype(np.float32) for d in ds]
    scale = rng.uniform(0.1, 1.0, (n,)).astype(np.float32)
    return ps, gs, scale


@pytest.mark.parametrize("n,part", leaf_cases())
def test_clip_sgd_leaves_matches_reference_kernel(n, part):
    """One round's call over mixed leaves against the reference's per-leaf
    kernel (interpret mode), leaf i's keep vector ``keep_spec_i`` for the
    survivors."""
    rng = np.random.default_rng(17 + n)
    ps, gs, scale = _round_leaves(rng, n)
    w = leaf_weights(rng, n, part)
    outs = TOPS.clip_sgd_leaves(
        [torch.from_numpy(p) for p in ps], [torch.from_numpy(g) for g in gs],
        torch.from_numpy(scale), list(LEAF_KEEPS),
        None if w is None else torch.from_numpy(w), gamma=GAMMA)
    assert len(outs) == len(ps)
    for p, g, keep_spec, out in zip(ps, gs, LEAF_KEEPS, outs):
        keep = np.full((n,), keep_spec) if w is None \
            else np.logical_and(keep_spec, w > 0)
        ref = ROPS.clip_sgd(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(scale),
            jnp.asarray(keep), None if w is None else jnp.asarray(w),
            gamma=GAMMA, impl="interpret")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **CLIP_TOL)


@pytest.mark.parametrize("vectors", [1, 2])
@pytest.mark.parametrize("ds,aligned", [
    (tuple(vgg16_leaf_sizes()), (True,) * 32),
    (LEAF_DS + (5120, 1, 4), (True, True, True, False, True, True, True)),
    ((7, 4099, 4, 1024, 1025), (True,) * 5),
], ids=["vgg16", "mixed", "ragged"])
def test_clip_sgd_plan_covers_every_column_once(ds, aligned, vectors):
    """Block b takes the last leaf whose first chunk is at or before it
    (the kernel's search) and columns [chunk·W, (chunk+1)·W) of it, W =
    threads · vectors · (4 or 1): every column of every leaf once, and
    16-byte vectors only where D % 4 == 0 and the pointers allow."""
    starts, vecs, total = TCS.clip_sgd_plan(ds, aligned, vectors)
    assert vecs == [al and d % 4 == 0 for d, al in zip(ds, aligned)]
    seen = [np.zeros(d, np.int64) for d in ds]
    for b in range(total):
        i = bisect.bisect_right(starts, b) - 1
        width = TCS.THREADS * vectors * (4 if vecs[i] else 1)
        lo = (b - starts[i]) * width
        hi = min(ds[i], lo + width)
        assert lo < hi, (b, i)
        seen[i][lo:hi] += 1
    assert all((s == 1).all() for s in seen)


_NARROW = dataclasses.replace(
    TC.get_config("vgg9-cifar-small"), arch_id="vgg9-round-update",
    conv_channels=(8, 16, 16), fc_dims=(32,), image_size=16)


def _narrow_vgg_round(seed, n):
    """(stacked units, grads, clip factors, masks) of a narrowed VGG-9 at N
    clients, each client's parameters apart, from a numpy seed."""
    cfg = _NARROW
    units = build_model(cfg).init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def rnd(a):
        return torch.from_numpy(rng.standard_normal(
            (n,) + tuple(a.shape)).astype(np.float32))

    stacked = [tree_map(lambda a: a.unsqueeze(0) + 0.1 * rnd(a), u)
               for u in units]
    grads = [tree_map(rnd, u) for u in units]
    scale = torch.from_numpy(rng.uniform(0.1, 1.0, (n,)).astype(np.float32))
    masks = TSP.client_unit_mask(cfg, len(units), 2)
    return stacked, grads, scale, masks


@pytest.mark.parametrize("part", [None, [1.0, 0.0, 0.5, 1.0], [0.0] * 4],
                         ids=["full", "partial", "drop-everyone"])
@pytest.mark.parametrize("do_agg", [False, True], ids=["local", "agg"])
def test_round_update_through_the_op_matches_inline(do_agg, part):
    """``hasfl_round_update(impl="kernel")`` on the CPU (one
    `ops.clip_sgd_leaves` call, the plain loop) against the inline algebra
    of ``impl=None``, on an aggregation and a non-aggregation round."""
    stacked, grads, scale, masks = _narrow_vgg_round(3, 4)
    w = None if part is None else torch.tensor(part)
    outs = [TSP.hasfl_round_update(
        [tree_map(torch.clone, u) for u in stacked], grads, masks, do_agg,
        GAMMA, grad_scale=scale, impl=impl, participation=w)
        for impl in (None, "kernel")]
    inline, fused = (tree_leaves(o) for o in outs)
    assert [t.shape for t in fused] == [t.shape for t in inline]
    for a, b in zip(fused, inline):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **CLIP_TOL)


def _cells(tensor, cells):
    return list(tensor.chunk(cells)) if tensor is not None \
        else [None] * cells


@pytest.mark.parametrize("part", [None, "partial", "zeros"])
def test_clip_sgd_leaves_plain_cells_equal_one_cell_calls(part):
    """A folded call over G cells (``cells=G``, one ``keep_specs`` list a
    cell) equals G one-cell calls to the bit, with different keeps per
    cell and with participation."""
    rng = np.random.default_rng(23)
    g_cells, n = 3, 4
    ps, gs, scale = _round_leaves(rng, g_cells * n)
    w = {None: None,
         "partial": rng.choice([0.0, 0.5, 1.0], g_cells * n),
         "zeros": np.r_[np.zeros(n), rng.uniform(0.1, 1, 2 * n)]}[part]
    w = None if w is None else torch.from_numpy(w.astype(np.float32))
    keeps = [list(LEAF_KEEPS), [False] * len(LEAF_DS),
             [not k for k in LEAF_KEEPS]]
    ps, gs = ([torch.from_numpy(a) for a in xs] for xs in (ps, gs))
    scale = torch.from_numpy(scale)
    folded = TOPS.clip_sgd_leaves(ps, gs, scale, keeps, w, gamma=GAMMA,
                                  cells=g_cells)
    alone = [TOPS.clip_sgd_leaves(
        [p.chunk(g_cells)[c] for p in ps], [g.chunk(g_cells)[c] for g in gs],
        _cells(scale, g_cells)[c], keeps[c], _cells(w, g_cells)[c],
        gamma=GAMMA) for c in range(g_cells)]
    for i, out in enumerate(folded):
        assert torch.equal(out, torch.cat([a[i] for a in alone]))


@pytest.mark.parametrize("impl", [None, "kernel"], ids=["inline", "op"])
@pytest.mark.parametrize("part", [None, "partial"])
@pytest.mark.parametrize("do_agg", [False, True], ids=["local", "agg"])
def test_round_update_cells_equal_one_cell_updates(do_agg, part, impl):
    """``hasfl_round_update(..., cells=G)`` over a folded carry with a cut
    a cell equals G one-cell updates to the bit."""
    g_cells, n = 3, 4
    stacked, grads, scale, _ = _narrow_vgg_round(5, g_cells * n)
    cfg_units = len(stacked)
    masks = np.stack([TSP.client_unit_mask(_NARROW, cfg_units, c)
                      for c in (1, 2, 3)])
    w = None if part is None else torch.tensor(
        [1.0, 0.0, 0.5, 1.0] * g_cells)

    def cell(tree, c):
        return [tree_map(lambda a: a[c * n:(c + 1) * n].clone(), u)
                for u in tree]

    folded = TSP.hasfl_round_update(
        [tree_map(torch.clone, u) for u in stacked], grads, masks, do_agg,
        GAMMA, grad_scale=scale, impl=impl, participation=w, cells=g_cells)
    alone = [TSP.hasfl_round_update(
        cell(stacked, c), cell(grads, c), masks[c], do_agg, GAMMA,
        grad_scale=scale[c * n:(c + 1) * n], impl=impl,
        participation=None if w is None else w[c * n:(c + 1) * n])
        for c in range(g_cells)]
    got = tree_leaves(folded)
    want = [torch.cat(xs) for xs in zip(*(tree_leaves(a) for a in alone))]
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
    TOPS.clip_sgd_leaves([p], [torch.ones_like(p)], torch.ones(2), [True],
                         gamma=0.1)
    TOPS.clip_sgd_leaves([p], [torch.ones_like(p)], torch.ones(2), [False],
                         gamma=0.1, commons=[torch.ones(5)],
                         count=torch.tensor(2.0))
    q = torch.zeros((1, 4, 2, 32))
    TOPS.flash_attention(q, q, q, causal=True)
    TOPS.rmsnorm(q, torch.ones(32))
    TOPS.mlstm_scan(q, q, q, torch.zeros((1, 4, 2)), torch.zeros((1, 4, 2)))
    assert TOPS.launch_counts() == {
        "batched_matmul": 0, "clip_sgd": 0, "clip_sgd_ext": 0,
        "flash_attention": 0, "flash_attention_bwd": 0, "rmsnorm": 0,
        "rmsnorm_bwd": 0, "mlstm_scan": 0, "mlstm_scan_bwd": 0,
        "grad_moments": 0}


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
    with pytest.raises(ValueError, match="CUDA"):
        TCS.clip_sgd_leaves_kernel([torch.zeros((2, 3))],
                                   [torch.zeros((2, 3))], torch.ones(2),
                                   [True], gamma=0.1)
    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention_kernel(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        TRN.rmsnorm_kernel(q, torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        TMS.mlstm_scan_kernel(q, q, q, torch.zeros((1, 4, 2)),
                              torch.zeros((1, 4, 2)))


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (bf16 rounding done once, on the JAX side, and carried over)."""
    j = jnp.asarray(a, JDT[dtype])
    t = torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])
    return j, t


def _assert_close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,dtype",
                         FLASH_CASES + FLASH_FAMILY_CASES)
def test_flash_attention_matches_reference_kernel(b, sq, sk, hq, hkv, hd,
                                                  causal, window, dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal(shape), dtype)
        for shape in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    ref = r_flash(qj, kj, vj, causal=causal, window=window, block_q=64,
                  block_k=64, interpret=True)
    out = TOPS.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.dtype == qt.dtype
    _assert_close(out, ref, FLASH_TOL[dtype])
    # the port's oracle (its naive attention) against the reference's
    _assert_close(TREF.flash_attention_ref(qt, kt, vt, causal=causal,
                                           window=window),
                  RREF.flash_attention_ref(qj, kj, vj, causal=causal,
                                           window=window), FLASH_TOL[dtype])


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,dtype",
                         FLASH_CASES)
def test_blockwise_attention_matches_reference(b, sq, sk, hq, hkv, hd,
                                               causal, window, dtype):
    """The port's plain blockwise (online-softmax) attention against the
    reference's, in KV blocks of 64 (ragged last block included)."""
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal(shape), dtype)
        for shape in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    ref = RATT.blockwise_attention(qj, kj, vj, causal=causal, window=window,
                                   block_kv=64)
    out = TATT.blockwise_attention(qt, kt, vt, causal=causal, window=window,
                                   block_kv=64)
    _assert_close(out, ref, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,c,hq,hkv,hd,pos", DECODE_CASES)
def test_flash_decode_form_matches_reference_decode_attention(
        b, c, hq, hkv, hd, pos, dtype):
    """The card's decode route, ``flash_decode`` on the stored positions,
    against the reference's ``decode_attention`` on a cache whose slots
    past ``pos`` are empty (-1) and hold garbage K/V; and the one-token
    prefill route, ``flash_attention(causal=False, sk_valid=pos+1)``, which
    the card runs through the same kernel.  The reference rounds the
    probabilities to bf16 before the PV product and the kernel keeps them
    fp32, so bf16 takes the bf16 bar."""
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal(shape), dtype)
        for shape in ((b, 1, hq, hd), (b, c, hkv, hd), (b, c, hkv, hd)))
    k_pos = np.where(np.arange(c) <= pos, np.arange(c), -1)
    k_pos = np.broadcast_to(k_pos, (b, c)).astype(np.int32)
    ref = r_decode_attention(qj, kj, vj, jnp.asarray(k_pos),
                             jnp.full((b,), pos, jnp.int32))
    out = TOPS.flash_decode(qt, kt, vt, torch.from_numpy(k_pos),
                            torch.full((b,), pos, dtype=torch.int32))
    _assert_close(out, ref, FLASH_TOL[dtype])
    out = TOPS.flash_attention(qt, kt, vt, causal=False, sk_valid=pos + 1)
    _assert_close(out, ref, FLASH_TOL[dtype])


@pytest.mark.parametrize("shape,dtype", RMSNORM_CASES)
def test_rmsnorm_matches_reference_kernel(shape, dtype):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.standard_normal(shape), dtype)
    sc = rng.random(shape[-1]).astype(np.float32)
    ref = r_rmsnorm(xj, jnp.asarray(sc), interpret=True)
    out = TOPS.rmsnorm(xt, torch.from_numpy(sc))
    assert out.dtype == xt.dtype
    _assert_close(out, ref, RMSNORM_TOL)


@pytest.mark.parametrize("b,s,h,hd,dtype", MLSTM_CASES)
def test_mlstm_scan_matches_reference_kernel(b, s, h, hd, dtype):
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal((b, s, h, hd)), dtype) for _ in range(3))
    ig, fg = (rng.standard_normal((b, s, h)).astype(np.float32)
              for _ in range(2))
    ref = r_mlstm(qj, kj, vj, jnp.asarray(ig), jnp.asarray(fg), chunk=32,
                  interpret=True)
    out = TOPS.mlstm_scan(qt, kt, vt, torch.from_numpy(ig),
                          torch.from_numpy(fg))
    assert out.dtype == qt.dtype
    _assert_close(out, ref, MLSTM_TOL[dtype])


# F = Σ log σ(f) reaches about -380 over 256 steps with forget gates of
# spread 3: where an fp32 prefix of the parallel form loses digits
MLSTM_LONG_F = (1, 256, 1, 64, "float32")
F_SPREAD = 3.0


def _mlstm_inputs(b, s, h, hd, dtype, seed, f_spread=1.0):
    rng = np.random.default_rng(seed)
    qkv = [_both(rng.standard_normal((b, s, h, hd)), dtype) for _ in range(3)]
    ig = rng.standard_normal((b, s, h)).astype(np.float32)
    fg = (rng.standard_normal((b, s, h)) * f_spread).astype(np.float32)
    return qkv, ig, fg


@pytest.mark.parametrize("b,s,h,hd,dtype,f_spread", [
    (*c, 1.0) for c in MLSTM_CASES] + [(*MLSTM_LONG_F, F_SPREAD)])
def test_mlstm_parallel_form_matches_reference_kernel(b, s, h, hd, dtype,
                                                     f_spread):
    """The parallel form in plain PyTorch (the tensor-core kernel's
    algorithm and roundings) against the reference's recurrence kernel."""
    ((qj, qt), (kj, kt), (vj, vt)), ig, fg = _mlstm_inputs(
        b, s, h, hd, dtype, seed=1, f_spread=f_spread)
    ref = r_mlstm(qj, kj, vj, jnp.asarray(ig), jnp.asarray(fg), chunk=32,
                  interpret=True)
    out = TMS.mlstm_parallel_plain(qt, kt, vt, torch.from_numpy(ig),
                                   torch.from_numpy(fg))
    assert out.dtype == qt.dtype
    _assert_close(out, ref, MLSTM_TOL[dtype])


@pytest.mark.parametrize("prefix,bar", [(torch.float64, 1e-6),
                                        (torch.float32, None)])
def test_mlstm_gate_prefix_needs_fp64(prefix, bar):
    """D_ts = exp(g_s − M_t) from the prefix helper against the same
    quantity in numpy fp64, over every causal pair with D > 1e-3, with F
    near -380: the fp64 prefix is within a few fp32 ulps (bar 1e-6
    relative), an fp32 cumsum is off by hundreds of ulps (over 1e-5)."""
    _, ig, fg = _mlstm_inputs(*MLSTM_LONG_F, seed=7, f_spread=F_SPREAD)
    it, ft = torch.from_numpy(ig), torch.from_numpy(fg)
    log_f = (-torch.nn.functional.softplus(-ft)).double().numpy()
    f_cum = np.cumsum(log_f, axis=1)
    g = ig.astype(np.float64) - f_cum
    m_run = np.maximum(np.maximum.accumulate(g, axis=1), -1e30)
    assert f_cum.min() < -300
    causal = np.tril(np.ones((ig.shape[1],) * 2, dtype=bool))
    d64 = np.exp(np.where(causal, g[0, None, :, 0] - m_run[0, :, None, 0],
                          -np.inf))
    _, gt, mt, m = TMS.mlstm_gate_prefix(it, ft, prefix)
    d = torch.exp((gt[0, None, :, 0] - mt[0, :, None, 0]).float()
                  .masked_fill(~torch.from_numpy(causal), float("-inf")))
    keep = d64 > 1e-3
    rel = np.abs(d.double().numpy() - d64)[keep] / d64[keep]
    if bar is None:
        assert rel.max() > 1e-5
    else:
        assert rel.max() <= bar
        # m is the recurrence's stabilizer F + M, rounded once to fp32
        np.testing.assert_allclose(m.double().numpy(), f_cum + m_run,
                                   rtol=1e-7, atol=0)


def test_mlstm_parallel_form_takes_the_stabilizer_branch_on_extreme_gates():
    """Forget pre-activations of ±30 and input ones at -1e30 (the first
    steps: h is 0 there, as the recurrence's exp(-m) is inf) against the
    port's recurrence, fp32 and bf16."""
    rng = np.random.default_rng(9)
    b, s, h, hd = 1, 80, 2, 32
    fg = rng.choice([-30.0, 30.0], (b, s, h)).astype(np.float32)
    ig = np.where(rng.random((b, s, h)) < 0.3, -1e30,
                  rng.standard_normal((b, s, h)) * 5).astype(np.float32)
    ig[:, :3] = -1e30
    for dtype in ("float32", "bfloat16"):
        q, k, v = (_both(rng.standard_normal((b, s, h, hd)), dtype)[1]
                   for _ in range(3))
        gates = torch.from_numpy(ig), torch.from_numpy(fg)
        par = TMS.mlstm_parallel_plain(q, k, v, *gates)
        rec = TMS.mlstm_scan_plain(q, k, v, *gates)
        assert bool(torch.isfinite(par.float()).all())
        assert not par[:, :3].float().any()
        np.testing.assert_allclose(par.float().numpy(), rec.float().numpy(),
                                   rtol=MLSTM_TOL[dtype],
                                   atol=MLSTM_TOL[dtype])


# kernel 6's backward: |plain − reference| ≤ bar · max|reference| per input,
# by the gates' spread.  At spread 6 the two fp32 references themselves sit
# up to 3.4e-5 · max off an fp64 run of the same recurrence (measured on
# these cases), so their bar there is 5e-5.
MLSTM_BWD_REL = {1.0: 2e-5, 3.0: 2e-5, 6.0: 5e-5}


def _mlstm_fwd_fp64(q, k, v, ig, fg):
    """(h, a, m) of the parallel form in fp64 (m as the forward keeps it):
    the backward's inputs without the forward's fp32 rounding."""
    b, s, h, hd = q.shape
    _, g, m_run, m = TMS.mlstm_gate_prefix(ig, fg)
    g, m_run = (t.permute(0, 2, 1) for t in (g, m_run))
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    d = torch.where(causal, torch.exp(g[:, :, None, :]
                                      - m_run[:, :, :, None]), 0.0)
    p = torch.einsum("bthd,bshd->bhts", q.double(), k.double()) \
        / math.sqrt(hd) * d
    a = p.sum(-1)
    den = torch.maximum(a.abs(), torch.exp(-m.permute(0, 2, 1).double()))
    out = torch.einsum("bhts,bshd->bthd", p, v.double()) \
        / den.permute(0, 2, 1)[..., None]
    return out, a.permute(0, 2, 1).contiguous(), m


@pytest.mark.parametrize("gate_scale", [1.0, 3.0, 6.0])
@pytest.mark.parametrize("b,s,h,hd,dtype", MLSTM_CASES)
def test_mlstm_scan_bwd_plain_matches_jax_grad(b, s, h, hd, dtype,
                                               gate_scale):
    """`mlstm_scan_bwd_plain` (the backward kernel's formulas, the
    stabilizer held constant) against ``jax.vjp`` of the reference's
    sequential ``mlstm_scan_ref`` and against torch autograd of the port's
    `mlstm_scan_plain`, on the reference's cases (bf16 inputs rounded, the
    arithmetic fp32) with gates of spread 1, 3 and 6: every one of dq, dk,
    dv, di and df within `MLSTM_BWD_REL` · max|reference| (fp32 rounding
    of the two references; the forward's h and a in fp64)."""
    from repro.models.ssm import mlstm_scan_ref

    rng = np.random.default_rng(11)
    q, k, v = (_both(rng.standard_normal((b, s, h, hd)), dtype)[1].float()
               .numpy() for _ in range(3))
    ig, fg = ((rng.standard_normal((b, s, h)) * gate_scale)
              .astype(np.float32) for _ in range(2))
    dh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    _, vjp = jax.vjp(mlstm_scan_ref, *map(jnp.asarray, (q, k, v, ig, fg)))
    ref = vjp(jnp.asarray(dh))
    ins = [torch.from_numpy(x) for x in (q, k, v, ig, fg)]
    got = TMS.mlstm_scan_bwd_plain(*ins, *_mlstm_fwd_fp64(*ins),
                                   torch.from_numpy(dh))
    leaves = [t.clone().requires_grad_() for t in ins]
    TMS.mlstm_scan_plain(*leaves).backward(torch.from_numpy(dh))
    for g, r, t in zip(got, ref, leaves):
        for want in (np.asarray(r), t.grad.numpy()):
            assert np.abs(g.numpy() - want).max() \
                <= MLSTM_BWD_REL[gate_scale] * np.abs(want).max()


def test_mlstm_scan_bwd_plain_on_extreme_gates():
    """Extreme gates (forget pre-activations of ±30, input ones at -1e30):
    where every input gate so far is -1e30 the floor exp(-m) is inf and h
    is 0, and the backward gives 0 there (no 0·inf); every gradient is
    finite."""
    rng = np.random.default_rng(9)
    b, s, h, hd = 1, 80, 2, 32
    fg = rng.choice([-30.0, 30.0], (b, s, h)).astype(np.float32)
    ig = np.where(rng.random((b, s, h)) < 0.3, -1e30,
                  rng.standard_normal((b, s, h)) * 5).astype(np.float32)
    ig[:, :3] = -1e30
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, hd))
                                .astype(np.float32)) for _ in range(3))
    gates = torch.from_numpy(ig), torch.from_numpy(fg)
    hh, a, m = TMS.mlstm_parallel_plain(q, k, v, *gates, stats=True)
    dh = torch.ones_like(hh)
    grads = TMS.mlstm_scan_bwd_plain(q, k, v, *gates, hh, a, m, dh)
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    assert not grads[0][:, :3].any() and not grads[4][:, :3].any()


def test_mlstm_parallel_plain_stats_are_the_denominators_parts():
    """``stats``: h unchanged, ``a`` the signed row sum of P and ``m`` the
    recurrence's stabilizer ``F + M`` (fp32) from the gate prefix."""
    ((_, q), (_, k), (_, v)), ig, fg = _mlstm_inputs(1, 40, 2, 32,
                                                     "float32", seed=4)
    gates = torch.from_numpy(ig), torch.from_numpy(fg)
    hh, a, m = TMS.mlstm_parallel_plain(q, k, v, *gates, stats=True)
    assert torch.equal(hh, TMS.mlstm_parallel_plain(q, k, v, *gates))
    assert torch.equal(m, TMS.mlstm_gate_prefix(*gates)[3])
    den = torch.maximum(a.abs(), torch.exp(-m))[..., None]
    h64, a64, _ = _mlstm_fwd_fp64(q, k, v, *gates)
    np.testing.assert_allclose(a.numpy(), a64.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hh.numpy(), h64.float().numpy(), rtol=2e-5,
                               atol=2e-5)
    assert den.shape == (1, 40, 2, 1)


# ---------------------------------------------------------------------------
# The split plans of the redesigned kernels (pure Python, reached here)
# ---------------------------------------------------------------------------

def _vgg16_gemm_shapes(n=8, b=64):
    """(name, M, K, C) of one VGG-16 round's GEMMs at N=n, batch b (the
    shapes `chip_smoke.py` times): forward, dW and dx of each conv."""
    chans, pools = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512,
                    512, 512), (2, 4, 7, 10, 13)
    shapes, h, cin = [], 32, 3
    for i, cout in enumerate(chans, start=1):
        m = b * h * h
        shapes += [(f"conv{i}.fwd", m, 9 * cin, cout),
                   (f"conv{i}.dW", 9 * cin, m, cout)]
        if i > 1:
            shapes.append((f"conv{i}.dx", m, 9 * cout, cin))
        cin = cout
        h //= 2 if i in pools else 1
    return shapes


GEMM_PLAN_SHAPES = [(8, m, k, c) for _, m, k, c in _vgg16_gemm_shapes()] + [
    (16, m, k, c) for _, m, k, c in _vgg16_gemm_shapes(16)] + [
    (1, 5, 3, 7), (2, 33, 5000, 70), (1, 17, 100000, 9), (3, 1, 4097, 1),
    (1, 27, 1024, 64), (1, 27, 1023, 64), (4, 64, 0, 64)]


@pytest.mark.parametrize("n,m,k,c", GEMM_PLAN_SHAPES)
def test_gemm_splits_cover_k_once_in_whole_slabs(n, m, k, c):
    splits, chunk = TBC.gemm_splits(n, m, k, c)
    assert splits >= 1
    if splits == 1:
        assert chunk == k
        return
    assert chunk % TBC.GEMM_BK == 0 and chunk >= TBC.SPLIT_MIN_CHUNK
    bounds = [(s * chunk, min(k, (s + 1) * chunk)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)                 # none empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("name,m,k,c", [
    s for s in _vgg16_gemm_shapes() if s[0].endswith(".dW")])
def test_gemm_splits_fill_the_card_on_every_vgg16_dw(name, m, k, c):
    """Output tiles × splits reach two blocks per SM (132 SMs) on every
    VGG-16 dW shape at N=8; the long-K ones need split-K for it."""
    n, sms = 8, 132
    splits, _ = TBC.gemm_splits(n, m, k, c, sms)
    tiles = n * -(-m // TBC.GEMM_BM) * -(-c // TBC.gemm_tile_c(c))
    assert tiles * splits >= 2 * sms
    if k >= 16384:
        assert splits > 1


@pytest.mark.parametrize("n,m,k,c", [(8, 4608, 256, 512), (1, 8, 1023, 8),
                                     (2, 27, 27, 64), (8, 65536, 576, 64),
                                     (1, 1, 0, 1)])
def test_gemm_splits_short_k_or_full_card_take_one_split(n, m, k, c):
    assert TBC.gemm_splits(n, m, k, c) == (1, k)


@pytest.mark.parametrize("cells", [1, 2, 4])
def test_gemm_plan_of_a_folded_call_is_the_cells_plan(cells):
    """A call folding G cells of N=8 (n = G·8) planned at ``plan_n=8``
    takes each VGG-16 shape's one-cell (splits, chunk); the split-K
    workspace ``[S, G·N, M, C]`` stays small.  Planned at n itself, the
    long-K dW shapes take fewer splits: the reason for ``plan_n``."""
    n = 8
    for name, m, k, c in _vgg16_gemm_shapes(n):
        plan = TBC.gemm_splits(cells * n, m, k, c, plan_n=n)
        assert plan == TBC.gemm_splits(n, m, k, c), name
        if plan[0] > 1:                  # the workspace, under 256 MiB
            assert 4 * plan[0] * cells * n * m * c < 2 ** 28, name
        if cells > 1 and name in ("conv1.dW", "conv2.dW"):
            assert TBC.gemm_splits(cells * n, m, k, c)[0] < plan[0], name


@pytest.mark.parametrize("cells", [1, 2, 4])
def test_clip_sgd_plan_covers_every_cell_entry_once(cells):
    """One entry a (cell, leaf), cell after cell, pointing at the cell's
    rows; `CAPACITY` entries a launch, ⌈G·32/64⌉ launches for VGG-16;
    within each launch the plan covers every column of every entry
    once."""
    n, ds = 8, list(vgg16_leaf_sizes())
    base = [1 << 32 + i for i in range(len(ds))]
    leaves = [(i, base[i], base[i] + (1 << 31), 0, d)
              for i, d in enumerate(ds)]
    keep_specs = [[(i + c) % 3 == 0 for i in range(len(ds))]
                  for c in range(cells)]
    entries = TCS.cell_entries(leaves, keep_specs, n, [4] * len(leaves))
    assert len(entries) == cells * len(ds)
    for e, (pp, gp, cp, d, ks, row) in enumerate(entries):
        c, i = divmod(e, len(ds))
        assert row == c * n and d == ds[i] and ks == keep_specs[c][i]
        assert pp == base[i] + 4 * row * d
        assert gp - pp == 1 << 31 and cp == 0
    launches = range(0, len(entries), TCS.CAPACITY)
    assert len(launches) == -(-cells * len(ds) // TCS.CAPACITY)
    for lo in launches:
        part = [e[3] for e in entries[lo:lo + TCS.CAPACITY]]
        starts, vecs, total = TCS.clip_sgd_plan(part, [True] * len(part))
        seen = [np.zeros(d, np.int64) for d in part]
        for b in range(total):
            i = bisect.bisect_right(starts, b) - 1
            width = TCS.THREADS * (4 if vecs[i] else 1)
            lo_col = (b - starts[i]) * width
            seen[i][lo_col:min(part[i], lo_col + width)] += 1
        assert all((s == 1).all() for s in seen)


def test_gemm_tile_columns_follow_c():
    assert [TBC.gemm_tile_c(c) for c in (1, 64, 65, 128, 512)] == [
        64, 64, 128, 128, 128]


@pytest.mark.parametrize("lanes", [1, 8, 24, 64, 264, 1000])
@pytest.mark.parametrize("kv_end", [0, 1, 31, 32, 33, 513, 544, 4000])
def test_decode_splits_cover_valid_keys_once_in_whole_tiles(lanes, kv_end):
    splits, chunk = TFA.decode_splits(lanes, kv_end)
    assert splits >= 1 and chunk % TFA.DECODE_TILE == 0 and chunk > 0
    if kv_end == 0:
        assert splits == 1
        return
    bounds = [(s * chunk, min(kv_end, (s + 1) * chunk))
              for s in range(splits)]
    assert bounds[-1][1] == kv_end
    assert all(lo < hi for lo, hi in bounds)   # each split has a tile
    tiles = -(-kv_end // TFA.DECODE_TILE)
    # the grid fills 132 SMs twice wherever the keys allow it
    assert lanes * splits >= min(2 * 132, lanes * tiles)


def test_decode_splits_at_qwen3_decode_shape():
    """8 sequences × 8 kv heads, one row group of 2, 513 valid keys: 6
    splits of 3 tiles (384 blocks on 132 SMs)."""
    lanes = 8 * 8 * -(-2 // TFA.decode_rows(2))
    assert TFA.decode_splits(lanes, 513) == (6, 96)
    assert TFA.decode_splits(lanes, 1) == (1, 32)


def test_decode_rows_per_block():
    assert [TFA.decode_rows(g) for g in (1, 2, 3, 8, 16)] == [2, 2, 8, 8, 8]


def test_path_counts_reset_with_the_launch_counts():
    TFA.flash_attention_kernel.launches_tc = 3
    TFA.flash_attention_kernel.launches_split_kv = 2
    TOPS.reset_launch_counts()
    assert TFA.path_launches() == {"tc": 0, "split_kv": 0, "fp32": 0}


def test_mlstm_path_counts_reset_with_the_launch_counts():
    TMS.mlstm_scan_kernel.launches_tc = 2
    TMS.mlstm_scan_kernel.launches_recurrent = 1
    TMS.mlstm_scan_bwd_kernel.launches_tc = 3
    TMS.mlstm_scan_bwd_kernel.launches_fp32 = 4
    TOPS.reset_launch_counts()
    assert TMS.path_launches() == {"tc": 0, "recurrent": 0}
    assert TMS.bwd_path_launches() == {"tc": 0, "fp32": 0}


def test_mlstm_parallel_workspace_covers_whole_tiles():
    # F and M (fp64) and gl (fp32) per (b, h) over S rounded up to 64
    assert TMS.parallel_workspace_bytes(8, 512, 4) == 8 * 4 * 512 * 20
    assert TMS.parallel_workspace_bytes(1, 200, 2) == 2 * 256 * 20


def test_mlstm_bwd_workspace_covers_whole_tiles():
    # per (b, h) over S rounded up to 64 (sp): fp64 g and M, fp32 1/den,
    # da, the diagonal sums, Q's column and row parts per tile, P' and dS
    assert TMS.bwd_workspace_bytes(8, 512, 4) == 32 * (
        512 * 28 + 2 * 8 * 512 * 4 + 2 * 512 * 512 * 4)
    assert TMS.bwd_workspace_bytes(1, 200, 2) == 2 * (
        256 * 28 + 2 * 4 * 256 * 4 + 2 * 256 * 256 * 4)


# ---------------------------------------------------------------------------
# RMSNorm's launch plan and the shared launch path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,itemsize,aligned,plan", [
    (4096, 2048, 2, True, (8, 128, 2, 1)),    # qwen3 prefill: 4 warps a row
    (65536, 128, 2, True, (8, 8, 2, 4)),      # the qk-norms: 4 rows a warp
    (128, 128, 2, True, (8, 16, 1, 2)),       # ... in decode
    (4096, 1024, 2, True, (8, 64, 2, 1)),     # xlstm prefill
    (8, 2048, 2, True, (8, 256, 1, 1)),       # decode: one vector a thread
    (8, 1024, 2, True, (8, 128, 1, 1)),
    (128, 2048, 4, True, (4, 256, 2, 1)),     # serve_cross, fp32
    (150, 50, 4, True, (1, 64, 1, 1)),        # d · 4 = 200: single elements
    (7, 100, 2, True, (1, 128, 1, 1)),
    (4096, 2048, 2, False, (1, 1024, 2, 1)),  # misaligned: single elements
    (2, 65536, 4, True, (4, 1024, 0, 1)),     # too wide: read twice
    (3, 1, 4, True, (1, 1, 1, 32)),
])
def test_rmsnorm_plan_at_the_serve_shapes(rows, d, itemsize, aligned, plan):
    assert TRN.rmsnorm_plan(rows, d, itemsize, aligned) == plan


@pytest.mark.parametrize("rows", [1, 3, 8, 129, 4096, 70000])
@pytest.mark.parametrize("d,itemsize", [(1, 4), (50, 4), (96, 4), (96, 2),
                                        (128, 2), (1000, 4), (2048, 2),
                                        (6144, 2), (9000, 4), (40000, 4)])
def test_rmsnorm_plan_covers_the_row(rows, d, itemsize):
    """What the kernel's entry point accepts: tpr a power of two in
    1..1024, whole warps and at most 1024 threads a block, vectors that
    tile the row, and registers (nv vectors a thread) that hold it unless
    nv = 0."""
    vec, tpr, nv, rpb = TRN.rmsnorm_plan(rows, d, itemsize)
    assert vec in (1, 16 // itemsize) and d % vec == 0
    assert vec > 1 or d * itemsize % 16 != 0
    assert 1 <= tpr <= 1024 and tpr & (tpr - 1) == 0
    assert rpb >= 1 and tpr * rpb <= 1024 and tpr * rpb % 32 == 0
    assert nv in (0, 1, 2, 4, 8)
    assert nv == 0 or tpr * nv * vec >= d
    assert nv > 0 or tpr * 8 * vec < d


def test_rmsnorm_plan_code_packs_every_field():
    # the entry point unpacks bits 0-1, 2-5, 6-9, 10-20 and 21-31
    code = TRN.plan_code(1, 8, 1024, 8, 256)
    assert [code & 3, code >> 2 & 15, code >> 6 & 15, code >> 10 & 2047,
            code >> 21 & 2047] == [1, 8, 8, 1024, 256]
    assert code < 2 ** 31


def test_device_scope_skips_the_current_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert isinstance(TLAUNCH.device_scope(0), contextlib.nullcontext)
    assert isinstance(TLAUNCH.device_scope(1), torch.cuda.device)
