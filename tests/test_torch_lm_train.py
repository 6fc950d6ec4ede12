"""Dense token-model training in the port against the reference, on the CPU.

The host-side copies (`make_lm_data`, the token profiles, the unit maps)
must be bitwise the reference's.  The loss and its gradients, the plain
backward formulas of flash attention and RMSNorm and the simulator's
token cells (`Session` on a token arch) are held to the reference at fp32 with the reference's weights carried across
(`repro_torch.convert`).  TF32 does not exist on the CPU; every product
here is full fp32.  The SPMD step and the optimizers are in
`test_torch_spmd.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.core import split as RSP
from repro.core.profiles import model_profile as r_profile
from repro.data import make_lm_data as r_lm_data
from repro.kernels import ref as RREF
from repro.models import build_model as r_build
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.convert import params_from_numpy, units_from_numpy
from repro_torch.core import split as TSP
from repro_torch.core.profiles import model_profile as t_profile
from repro_torch.data import make_lm_data as t_lm_data
from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_plain
from repro_torch.models import build_model as t_build
from repro_torch.utils.tree import tree_leaves, tree_map

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
TOKEN_ARCHS = [a for a in RC.list_archs() if not RC.get_config(a).is_cnn]
# the reference's kernel cases (tests/test_kernels.py)
FLASH_CASES = [
    # (b, sq, sk, hq, hkv, hd, causal, window, dtype)
    (1, 128, 128, 4, 2, 64, True, 0, "float32"),
    (2, 64, 256, 8, 8, 32, True, 0, "float32"),
    (1, 96, 96, 4, 1, 128, True, 32, "float32"),
    (1, 128, 128, 2, 2, 64, False, 0, "float32"),
    (1, 200, 200, 3, 1, 64, True, 0, "float32"),
    (1, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (2, 32, 512, 4, 4, 64, True, 128, "bfloat16"),
]
RMSNORM_CASES = [((4, 128), "float32"), ((3, 50, 96), "float32"),
                 ((2, 17, 256), "bfloat16"), ((1, 1, 512), "bfloat16")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(arch, dtype="float32", **cut):
    """The reference's and the port's config of ``arch`` in ``dtype``:
    ``smollm-tiny`` as registered, any other arch `reduced`, with the
    overrides ``cut``."""
    out = []
    for C in (RC, TC):
        cfg = C.get_config(arch)
        cfg = dataclasses.replace(cfg, **cut) if arch == "smollm-tiny" \
            else C.reduced(cfg, **cut)
        out.append(dataclasses.replace(cfg, dtype=dtype))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Host-side copies: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,n,s,seed", [(512, 64, 32, 0),
                                            (49152, 16, 128, 3)])
def test_make_lm_data_is_bitwise_the_references(vocab, n, s, seed):
    for a, b in zip(r_lm_data(vocab, n, s, seed=seed),
                    t_lm_data(vocab, n, s, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_token_profiles_are_bitwise_the_references(arch):
    for seq in (32, 512):
        r = r_profile(RC.get_config(arch), seq_len=seq)
        t = t_profile(TC.get_config(arch), seq_len=seq)
        for f in ("rho", "bwd", "psi", "chi", "delta", "params", "g_sq",
                  "sigma_sq"):
            assert np.array_equal(getattr(r, f), getattr(t, f)), (arch, f)


@pytest.mark.parametrize("arch", ["smollm-tiny", "qwen3-1.7b", "xlstm-350m",
                                  "jamba-v0.1-52b", "whisper-medium"])
def test_token_unit_maps_match_the_reference(arch):
    dense = arch in ("smollm-tiny", "qwen3-1.7b")
    rcfg, tcfg = _configs(arch, "bfloat16", **({"n_layers": 4} if dense
                                                else {}))
    params = r_build(rcfg).init(jax.random.PRNGKey(0))
    r_units, r_rebuild = RSP.to_units(rcfg, params)
    t_params = params_from_numpy(_np(params), tcfg, "cpu")
    t_units, t_rebuild = TSP.to_units(tcfg, t_params)
    assert len(t_units) == len(r_units)
    assert TSP.n_cut_units(tcfg, t_units) == RSP.n_cut_units(rcfg, r_units)
    for a, b in zip(jax.tree_util.tree_leaves(r_units), tree_leaves(t_units)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    back = t_rebuild(t_units)
    for a, b in zip(jax.tree_util.tree_leaves(r_rebuild(r_units)),
                    tree_leaves(back)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    n_layers = r_profile(rcfg).n_layers
    for cut in range(1, n_layers + 1):
        uc = RSP.layer_cut_to_unit_cut(rcfg, cut)
        assert TSP.layer_cut_to_unit_cut(tcfg, cut) == uc
        assert np.array_equal(
            TSP.client_unit_mask(tcfg, len(t_units), uc),
            RSP.client_unit_mask(rcfg, len(r_units), uc))
        assert [len(p) for p in TSP.split_units(t_units, uc, tcfg)] == \
            [len(p) for p in RSP.split_units(r_units, uc, rcfg)]
    # the token unit list carried across keeps each leaf's type
    conv = units_from_numpy(_np(r_units), "cpu", tcfg)
    assert conv[0]["embed"].dtype == torch.bfloat16
    assert tree_leaves(conv[-1])[0].dtype == torch.float32   # final_norm


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-tiny", "qwen3-1.7b",
                                  "phi3-mini-3.8b"])
def test_loss_and_grads_match_jax(arch):
    """``loss`` at fp32 (qwen3: qk-norm; phi3 at hd 96) with the
    reference's weights: loss within 1e-5, every gradient leaf within
    1e-4 of ``jax.grad``."""
    cut = {"head_dim": 96} if arch == "phi3-mini-3.8b" else {}
    rcfg, tcfg = _configs(arch, **cut)
    params = r_build(rcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, rcfg.vocab_size, (b, s)).astype(
                 np.int32),
             "loss_mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    (l_ref, _), g_ref = jax.value_and_grad(r_build(rcfg).loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    t_params = params_from_numpy(_np(params), tcfg, "cpu")
    for t in tree_leaves(t_params):
        t.requires_grad_()
    loss, aux = t_build(tcfg).loss(
        t_params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **LOSS_TOL)
    assert float(aux["lb_loss"]) == 0.0
    g_port = tree_leaves(t_params)
    g_jax = jax.tree_util.tree_leaves(g_ref)
    assert len(g_port) == len(g_jax)
    for a, r in zip(g_port, g_jax):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("arch", ["smollm-tiny", "qwen3-1.7b"])
def test_stacked_loss_is_each_clients_loss(arch):
    """The simulator's client-stacked loss: client i's entry is ``loss``
    of client i's units (the reference's vmap of ``loss``), gradients
    included."""
    _, tcfg = _configs(arch)
    model = t_build(tcfg)
    units, rebuild = TSP.to_units(
        tcfg, model.init(torch.Generator().manual_seed(0), "cpu"))
    n, b, s = 3, 2, 8
    rng = np.random.default_rng(1)
    stacked = TSP.replicate_units(units, n)
    for leaf in tree_leaves(stacked):    # clients differ
        leaf.add_(torch.from_numpy(rng.standard_normal(leaf.shape).astype(
            np.float32)) * 0.01)
        leaf.requires_grad_()
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, tcfg.vocab_size, (n, b, s))),
             "labels": torch.from_numpy(rng.integers(
                 0, tcfg.vocab_size, (n, b, s))),
             "loss_mask": torch.ones(n, b, s)}
    batch["loss_mask"][1, 1] = 0.0
    losses = model.stacked_loss(stacked, batch)
    losses.sum().backward()
    for i in range(n):
        mine = [tree_map(lambda a: a[i].detach().clone().requires_grad_(),
                         u) for u in stacked]
        li, _ = model.loss(rebuild(mine), {k: v[i] for k, v in
                                           batch.items()})
        li.backward()
        np.testing.assert_allclose(float(losses[i].detach()),
                                   float(li.detach()), **LOSS_TOL)
        for a, c in zip(tree_leaves(stacked), tree_leaves(mine)):
            np.testing.assert_allclose(a.grad[i].numpy(), c.grad.numpy(),
                                       **GRAD_TOL)


# ---------------------------------------------------------------------------
# The backward formulas of kernels 4 and 5
# ---------------------------------------------------------------------------

def _widened(rng, shape, dtype):
    """Random values rounded to ``dtype`` and held in fp32: the backward
    formulas run in fp32 whatever the inputs' type, so the bf16 cases
    compare the formula at fp32 on bf16-valued inputs."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,dtype",
                         FLASH_CASES)
def test_flash_attention_bwd_plain_matches_jax_vjp(b, sq, sk, hq, hkv, hd,
                                                   causal, window, dtype):
    rng = np.random.default_rng(0)
    q = _widened(rng, (b, sq, hq, hd), dtype)
    k = _widened(rng, (b, sk, hkv, hd), dtype)
    v = _widened(rng, (b, sk, hkv, hd), dtype)
    do = _widened(rng, (b, sq, hq, hd), dtype)
    _, vjp = jax.vjp(lambda q_, k_, v_: RREF.flash_attention_ref(
        q_, k_, v_, causal=causal, window=window), *map(jnp.asarray,
                                                        (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                    window=window)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("shape,dtype,groups", [
    *[(s, d, 1) for s, d in RMSNORM_CASES],
    ((4, 6, 64), "float32", 4), ((2, 3, 5, 32), "bfloat16", 2)])
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape, dtype, groups):
    """RMSNorm's backward formula against ``jax.vjp`` of the reference's
    `rmsnorm_ref`; a grouped ``[G, d]`` scale against the reference's
    norm vmapped over the G contiguous row groups."""
    rng = np.random.default_rng(2)
    x = _widened(rng, shape, dtype)
    dy = _widened(rng, shape, dtype)
    d = shape[-1]
    sc = rng.random((groups, d) if groups > 1 else (d,)).astype(np.float32)

    def ref(x_, s_):
        if groups == 1:
            return RREF.rmsnorm_ref(x_, s_)
        xg = x_.reshape(groups, -1, d)
        return jax.vmap(RREF.rmsnorm_ref)(xg, s_).reshape(shape)

    out, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(sc))
    rdx, rds = vjp(jnp.asarray(dy))
    tx, tsc, tdy = map(torch.from_numpy, (x, sc, dy))
    np.testing.assert_allclose(rmsnorm_plain(tx, tsc).numpy(),
                               np.asarray(out), rtol=2e-5, atol=2e-5)
    dx, ds = rmsnorm_bwd_plain(tx, tsc, tdy)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(rds), rtol=2e-5,
                               atol=2e-5)


def test_grad_requiring_mlstm_scan_reaches_its_autograd_function(
        monkeypatch):
    """On the card a grad-requiring mLSTM scan goes through `MLSTMScanFn`:
    its forward asks the kernel for the backward's ``a`` and ``m``.  The
    card is faked (the dispatch's device check says "card"; the kernel is
    a trap that records how it was called)."""
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    calls = []

    def trap(*a, **k):
        calls.append(k)
        raise AssertionError("the kernel was reached")

    monkeypatch.setattr(MS, "mlstm_scan_kernel", trap)
    seen = []
    fwd = MS.MLSTMScanFn.forward
    monkeypatch.setattr(MS.MLSTMScanFn, "forward", staticmethod(
        lambda ctx, *a: seen.append(len(a)) or fwd(ctx, *a)))
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    g = torch.zeros((1, 4, 2))
    with pytest.raises(AssertionError, match="reached"):
        ops.mlstm_scan(q, q, q, g, g)
    assert seen == [5] and calls == [{"stats": True}]
    with torch.no_grad(), pytest.raises(AssertionError, match="reached"):
        ops.mlstm_scan(q, q, q, g, g)
    assert seen == [5] and calls[-1] == {}


# ---------------------------------------------------------------------------
# The simulator's token cells
# ---------------------------------------------------------------------------

def _register(dtype):
    name = f"smollm-tiny-{dtype}"
    for C in (RC, TC):
        C.register(dataclasses.replace(C.get_config("smollm-tiny"),
                                       arch_id=name, dtype=dtype))
    return name


def _run_both(dtype, estimate):
    kw = dict(arch=_register(dtype), n_clients=4, partition="iid",
              n_train=256, n_test=32, seq_len=16, seed=0, policy="hasfl",
              estimate=estimate, rounds=6, eval_every=2)
    rs = RSession(RSpec(**kw, sfl=RC.SFLConfig(n_devices=4, agg_interval=3,
                                               lr=0.05)))
    units = _np(rs.sim.units)
    rr = rs.run()
    ts = TSession(TSpec(**kw, sfl=TC.SFLConfig(n_devices=4, agg_interval=3,
                                               lr=0.05)),
                  device="cpu", init_units=units)
    tr = ts.run()
    for a, b in zip(rr.b_history + rr.cut_history,
                    tr.b_history + tr.cut_history):
        assert np.array_equal(a, b)
    assert rr.clock == tr.clock
    return rs, rr, ts, tr


def test_token_session_fp32_matches_reference():
    """A 6-round fp32 smollm-tiny cell (N=4, I=3, HASFL with the online
    G²/σ² estimate): decisions and clocks bitwise, losses, accuracies and
    parameters within 1e-4."""
    rs, rr, ts, tr = _run_both("float32", True)
    for f in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(tr, f), getattr(rr, f), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(rs.sim._stacked),
                    tree_leaves(ts.sim._stacked)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_token_session_bf16_matches_reference():
    """The same cell at the registered bf16 type, priors only: decisions
    and clocks bitwise; losses within 1e-3.  The bar: a bf16 weight moves
    by whole ulps (2^-8 relative) when the two frameworks round a product
    or a client mean at a different place (per-client products as one
    `bmm`, reductions accumulated in fp32), and six rounds carry those
    steps into the loss at ~1e-4 (measured 1.1e-4), well inside 1e-3."""
    _, rr, _, tr = _run_both("bfloat16", False)
    for f in ("train_loss", "test_loss"):
        np.testing.assert_allclose(getattr(tr, f), getattr(rr, f),
                                   rtol=0, atol=1e-3)


def test_token_session_checks():
    """Token cells refuse a non-IID partition; a one-cell token grid is
    its `run()` bitwise (results and every parameter)."""
    name = _register("float32")
    with pytest.raises(ValueError, match="iid"):
        TSession(TSpec(arch=name, partition="noniid-shards", n_train=64,
                       n_test=8, seq_len=8), device="cpu")
    spec = TSpec(arch=name, n_train=64, n_test=8, seq_len=8,
                 partition="iid", rounds=2, eval_every=1)
    grid, alone = TSession(spec, device="cpu"), TSession(spec, device="cpu")
    (g,), r = TSession.run_grid([grid], device="cpu"), alone.run()
    assert (g.clock, g.train_loss, g.test_loss) == \
        (r.clock, r.train_loss, r.test_loss)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(grid.sim._stacked), tree_leaves(alone.sim._stacked)))


def test_xlstm_trains_at_every_entry_point():
    """The SSM family (xlstm, reduced: an mLSTM and an sLSTM block) trains
    at each of the three entry points: ``loss``, ``stacked_loss`` on two
    clients' units and ``split_loss`` with one repetition on the clients
    give finite values and finite gradients (their values against the
    reference: `test_torch_family_train.py`)."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("xlstm-350m")),
                              dtype="float32")
    assert {"mlstm", "slstm"} <= set(cfg.ssm_pattern.split(","))
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)

    def batch(*lead):
        return {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (*lead, 8)).astype(np.int32))
            for k in ("tokens", "labels")}

    def finite(loss, leaves):
        loss.sum().backward()
        assert bool(torch.isfinite(loss).all())
        assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
                   for t in leaves)

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    finite(model.loss(params, batch(2))[0], leaves)
    units, _ = TSP.to_units(cfg, tree_map(lambda a: a.detach(), params))
    stacked = TSP.replicate_units(units, 2)
    leaves = tree_leaves(stacked)
    for t in leaves:
        t.requires_grad_()
    finite(model.stacked_loss(stacked, batch(2, 2)), leaves)
    client, server = TSP.split_stacked(tree_map(lambda a: a.detach(),
                                                params), 1)
    client = TSP.replicate_client(client, 2)
    leaves = tree_leaves([client, server])
    for t in leaves:
        t.requires_grad_()
    # the server's suffix holds no repetition: its empty leaves get no
    # gradient tensor
    finite(model.split_loss(client, server, batch(2, 2))[0],
           [t for t in leaves if t.numel()])
