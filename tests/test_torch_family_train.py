"""Training of the MoE, hybrid, VLM and encoder-decoder token families in
the port against the reference, on the CPU.

`dbrx-132b` and `llama4-maverick-400b-a17b` (MoE), `jamba-v0.1-52b`
(mamba with MoE), `internvl2-1b` (VLM, with patch stubs) and
`whisper-medium` (encoder-decoder, with frame stubs) and `xlstm-350m`
(SSM: an mLSTM and an sLSTM block), each `reduced` and at fp32, from the reference's weights (`repro_torch.convert`) and seeded
numpy batches: ``apply``'s load-balance loss, ``loss`` and its
gradients against ``jax.grad``, ``stacked_loss`` against each client's
own ``loss`` (the reference's vmap), ``split_loss`` against the
reference's, six rounds of a token `Session` and three steps of the SPMD
HASFL step against the reference's.  TF32 does not exist on the CPU;
every product here is full fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.models.moe as RM
from repro.configs import ASSIGNED
from repro.configs.input_shapes import concrete_inputs as r_inputs
import repro_torch.config as TC
import repro_torch.models.moe as TM
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.core.sfl import make_hasfl_train_step as r_step
from repro.models import build_model as r_build
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.configs.input_shapes import concrete_inputs as t_inputs
from repro_torch.convert import params_from_numpy
from repro_torch.core import split as TSP
from repro_torch.core.sfl import make_hasfl_train_step as t_step
from repro_torch.models import build_model as t_build
from repro_torch.training.optim import make_optimizer as t_optimizer
from repro_torch.utils.tree import tree_leaves, tree_map

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]
FAMILIES = MOE_ARCHS + ["internvl2-1b", "whisper-medium", "xlstm-350m"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(arch, **cut):
    """The reference's and the port's fp32 `reduced` config of ``arch``
    with the overrides ``cut``."""
    return [dataclasses.replace(C.reduced(C.get_config(arch), **cut),
                                dtype="float32") for C in (RC, TC)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, cfg, lead, s, mask=False):
    """Seeded numpy tokens and labels ``[*lead, s]``, an optional loss
    mask, and the family's stubs: patches at positions 2.. of every row
    (VLM), frames (whisper)."""
    out = {k: rng.integers(0, cfg.vocab_size, (*lead, s)).astype(np.int32)
           for k in ("tokens", "labels")}
    if mask:
        out["loss_mask"] = (rng.random((*lead, s)) < 0.8).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeddings"] = rng.standard_normal(
            (*lead, cfg.n_patches, cfg.d_model)).astype(np.float32)
        m = np.zeros((*lead, s), bool)
        m[..., 2:2 + cfg.n_patches] = True
        out["patch_mask"] = m
    if cfg.is_enc_dec:
        out["frame_embeddings"] = rng.standard_normal(
            (*lead, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture
def record():
    """The port's `moe.RECORD` hook, on for the test."""
    TM.RECORD = []
    yield TM.RECORD
    TM.RECORD = None


def _close_trees(got, want, tol):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, r in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **tol)


# ---------------------------------------------------------------------------
# The training inputs and the reference's own smoke step
# ---------------------------------------------------------------------------

SMOKE_SHAPE = (16, 4)      # the reference's smoke_train shape: S, B


@pytest.mark.parametrize("arch", RC.list_archs())
def test_train_inputs_are_bitwise_the_references(arch):
    """``concrete_inputs`` of a train shape: tokens, labels and the
    modality stubs (bf16 stubs widened to fp32) as the reference draws
    them; a CNN's images and labels."""
    shapes = [C.InputShape("smoke_train", *SMOKE_SHAPE, "train")
              for C in (RC, TC)]
    ref = r_inputs(RC.get_config(arch), shapes[0])
    got = t_inputs(TC.get_config(arch), shapes[1])
    assert list(got) == list(ref)
    for k in ref:
        assert np.array_equal(got[k], np.asarray(ref[k]).astype(
            got[k].dtype)), k


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_no_nans(arch):
    """The reference's smoke step (`tests/test_smoke_archs.py`) on the
    port: each assigned arch reduced, at its registered type, on the
    reference's concrete train inputs: a finite loss, finite gradients,
    and a finite loss after one SGD step."""
    cfg = TC.reduced(TC.get_config(arch))
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _torch(t_inputs(cfg, TC.InputShape("smoke_train", *SMOKE_SHAPE,
                                               "train")))
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, _ = model.loss(params, batch)
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(t.grad).all())
               for t in tree_leaves(params))
    with torch.no_grad():
        stepped = tree_map(lambda p: p - 1e-3 * p.grad.to(p.dtype), params)
        loss2, _ = model.loss(stepped, batch)
    assert bool(torch.isfinite(loss2))


# ---------------------------------------------------------------------------
# apply's load-balance loss (the repair: the port returned 0.0)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_lb_loss_matches_reference(arch):
    rcfg, tcfg = _configs(arch)
    params = r_build(rcfg).init(jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0), rcfg, (2,), 16)
    r_logits, r_aux = r_build(rcfg).apply(params, _jax(batch))
    with torch.no_grad():
        logits, aux = t_build(tcfg).apply(
            params_from_numpy(_np(params), tcfg, "cpu"), _torch(batch))
    assert float(r_aux["lb_loss"]) > 0
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(r_aux["lb_loss"]), **LOSS_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), **TOL)


# ---------------------------------------------------------------------------
# loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cut", [
    *[(a, {}) for a in FAMILIES],
    # a tight capacity: the router drops tokens, which get no expert
    # gradient
    ("dbrx-132b", {"capacity_factor": 1.0})])
def test_loss_and_grads_match_jax(arch, cut, record):
    """``loss`` (with patch or frame stubs where the family takes them)
    with the reference's weights: the loss and its ``lb_loss`` within
    1e-5, every gradient leaf (the routers included) within 1e-4 of
    ``jax.grad``."""
    rcfg, tcfg = _configs(arch, **cut)
    params = r_build(rcfg).init(jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0), rcfg, (2,), 16, mask=True)
    (l_ref, r_aux), g_ref = jax.value_and_grad(
        r_build(rcfg).loss, has_aux=True)(params, _jax(batch))
    t_params = params_from_numpy(_np(params), tcfg, "cpu")
    for t in tree_leaves(t_params):
        t.requires_grad_()
    loss, aux = t_build(tcfg).loss(t_params, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **LOSS_TOL)
    lb = float(torch.as_tensor(aux["lb_loss"]).detach())
    np.testing.assert_allclose(lb, float(r_aux["lb_loss"]), **LOSS_TOL)
    assert (lb > 0) == (arch in MOE_ARCHS)
    if cut:
        assert any(float(a["dropped_frac"]) > 0 for a in record)
    g_ref = jax.tree_util.tree_leaves(g_ref)
    g_port = tree_leaves(t_params)
    assert len(g_port) == len(g_ref)
    for a, r in zip(g_port, g_ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), **GRAD_TOL)


# ---------------------------------------------------------------------------
# stacked_loss: each client's own loss, as the reference's vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,case", [
    ("dbrx-132b", "plain"), ("jamba-v0.1-52b", "plain"),
    ("internvl2-1b", "plain"), ("whisper-medium", "plain"),
    ("xlstm-350m", "plain"), ("dbrx-132b", "drops"),
    ("dbrx-132b", "chunked")])
def test_stacked_loss_is_each_clients_loss(arch, case, record,
                                           monkeypatch):
    """The simulator's client-stacked loss: client i's entry is ``loss``
    of client i's units, gradients included.  ``drops``: one MoE layer
    with 15 slots for 16 tokens and client 0's router zero, so all its
    tokens tie, go to experts 0 and 1 and overflow them, while client 1
    drops nothing: each client numbers and drops its own tokens.
    ``chunked``: `MOE_TOKEN_CHUNK` at 8 on both packages, so each
    client's 16 tokens go in two chunks of their own; client 0's loss also
    holds against the reference's."""
    cut = {"capacity_factor": 1.8, "n_layers": 1} if case == "drops" \
        else {}
    rcfg, tcfg = _configs(arch, **cut)
    if case == "chunked":
        monkeypatch.setattr(TM, "MOE_TOKEN_CHUNK", 8)
        monkeypatch.setattr(RM, "MOE_TOKEN_CHUNK", 8)
    model = t_build(tcfg)
    r_params = r_build(rcfg).init(jax.random.PRNGKey(0))
    units, rebuild = TSP.to_units(
        tcfg, params_from_numpy(_np(r_params), tcfg, "cpu"))
    n, b, s = 2, 2, 8
    rng = np.random.default_rng(1)
    stacked = TSP.replicate_units(units, n)
    for leaf in tree_leaves(stacked):    # clients differ
        leaf.add_(torch.from_numpy(rng.standard_normal(leaf.shape).astype(
            np.float32)) * 0.01)
    if case == "drops":
        for u in stacked[1:-1]:
            for layer in u.values():
                for block in layer.values():
                    if "w_router" in block:
                        block["w_router"][0] = 0.0
    for leaf in tree_leaves(stacked):
        leaf.requires_grad_()
    batch = _torch(_batch(rng, tcfg, (n, b), s, mask=True))
    losses = model.stacked_loss(stacked, batch)
    if case == "drops":
        drops = torch.stack([a["dropped_frac"] for a in record]).sum(0)
        assert float(drops[0]) > 0 and float(drops[1]) == 0
    losses.sum().backward()
    for i in range(n):
        mine = [tree_map(lambda a: a[i].detach().clone().requires_grad_(),
                         u) for u in stacked]
        mine_batch = {k: v[i] for k, v in batch.items()}
        li, _ = model.loss(rebuild(mine), mine_batch)
        li.backward()
        np.testing.assert_allclose(float(losses[i].detach()),
                                   float(li.detach()), **LOSS_TOL)
        for a, c in zip(tree_leaves(stacked), tree_leaves(mine)):
            np.testing.assert_allclose(a.grad[i].numpy(), c.grad.numpy(),
                                       **GRAD_TOL)
        if case == "chunked" and i == 0:
            r_units = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a.detach().numpy()), mine)
            from repro.core import split as RSP

            _, r_rebuild = RSP.to_units(rcfg, r_params)
            l_ref, _ = r_build(rcfg).loss(
                r_rebuild(r_units),
                {k: jnp.asarray(v.numpy()) for k, v in mine_batch.items()})
            np.testing.assert_allclose(float(li.detach()), float(l_ref),
                                       **LOSS_TOL)


# ---------------------------------------------------------------------------
# split_loss against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cut_reps,remat", [
    ("dbrx-132b", 0, False), ("dbrx-132b", 1, False),
    ("whisper-medium", 1, False), ("internvl2-1b", 1, False),
    ("jamba-v0.1-52b", 1, False), ("jamba-v0.1-52b", 1, True),
    ("xlstm-350m", 0, False), ("xlstm-350m", 1, False),
    ("xlstm-350m", 1, True)])
def test_split_loss_matches_reference(arch, cut_reps, remat):
    """The SPMD step's loss (client-stacked prefix, one server batch;
    whisper's encoder on the server, each client's prefix on its own rows
    of its output; internvl2's patches merged per client; jamba's MoE aux
    out of the recomputed super-block under ``remat``): the value within
    1e-5 and the client and server gradients within 1e-4 of ``jax.grad``
    of the reference's ``split_loss``."""
    from repro.core import split as RSP

    rcfg, tcfg = _configs(arch)
    n = 2
    params = r_build(rcfg).init(jax.random.PRNGKey(0))
    rc, rs = RSP.split_stacked(params, cut_reps)
    rc = RSP.replicate_client(rc, n)
    rng = np.random.default_rng(3)
    rc = jax.tree_util.tree_map(
        lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
        rc)                                   # clients differ
    batch = _batch(rng, rcfg, (n, 2), 8, mask=True)
    (l_ref, _), (g_c, g_s) = jax.value_and_grad(
        r_build(rcfg).split_loss, argnums=(0, 1), has_aux=True)(
        rc, rs, _jax(batch))
    tc = params_from_numpy(_np(rc), tcfg, "cpu")
    ts = params_from_numpy(_np(rs), tcfg, "cpu")
    for t in tree_leaves([tc, ts]):
        t.requires_grad_()
    loss, _ = t_build(tcfg).split_loss(tc, ts, _torch(batch), remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **LOSS_TOL)
    for tree, ref in ((tc, g_c), (ts, g_s)):
        # an empty prefix (cut_reps 0) gets no gradient tensor
        _close_trees(tree_map(lambda a: torch.zeros_like(a)
                              if a.numel() == 0 else a.grad, tree),
                     ref, GRAD_TOL)


# ---------------------------------------------------------------------------
# The simulator's token cells and the SPMD step
# ---------------------------------------------------------------------------

def _register(arch):
    name = f"{arch}-reduced-f32"
    for C in (RC, TC):
        C.register(dataclasses.replace(C.reduced(C.get_config(arch)),
                                       arch_id=name, dtype="float32"))
    return name


def _session_kw(arch, estimate):
    return dict(arch=_register(arch), n_clients=4, partition="iid",
                n_train=256, n_test=32, seq_len=16, seed=0, policy="hasfl",
                estimate=estimate, rounds=6, eval_every=2)


@pytest.mark.parametrize("arch,estimate", [
    ("dbrx-132b", True), ("jamba-v0.1-52b", False),
    ("internvl2-1b", False), ("xlstm-350m", True)])
def test_family_session_matches_reference(arch, estimate):
    """A 6-round fp32 cell (N=4, I=3, HASFL; dbrx with the online G²/σ²
    estimate) from the reference's initial units: decisions and clocks
    bitwise, losses, accuracies and parameters within 1e-4 (the dense
    token Session's bar)."""
    kw = _session_kw(arch, estimate)
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
    for f in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(tr, f), getattr(rr, f), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(rs.sim._stacked),
                    tree_leaves(ts.sim._stacked)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_whisper_session_raises_like_the_reference():
    """The Session builds tokens and labels only, and whisper's loss needs
    the frames: both packages build the session and raise
    ``KeyError('frame_embeddings')`` when it runs."""
    kw = _session_kw("whisper-medium", False)
    rs = RSession(RSpec(**kw, sfl=RC.SFLConfig(n_devices=4,
                                               agg_interval=3)))
    with pytest.raises(KeyError, match="frame_embeddings"):
        rs.run()
    ts = TSession(TSpec(**kw, sfl=TC.SFLConfig(n_devices=4,
                                               agg_interval=3)),
                  device="cpu")
    with pytest.raises(KeyError, match="frame_embeddings"):
        ts.run()


@pytest.mark.parametrize("arch,opt,cut_reps", [
    ("dbrx-132b", "sgd", 1), ("whisper-medium", "adam", 1),
    ("jamba-v0.1-52b", "sgd", 0), ("xlstm-350m", "sgd", 1)])
def test_spmd_step_matches_the_reference(arch, opt, cut_reps):
    """Three steps of the port's SPMD HASFL step against the reference's
    from the same weights (dbrx: the lb term in the loss, an MoE block in
    the client-stacked prefix; whisper: frame stubs in the batch; jamba:
    an empty prefix, every block on the server; xlstm: both blocks in the
    prefix, the mLSTM scan's gradient through autograd on both sides, SGD
    because Adam's first step moves a weight by ±lr whatever the size of
    its gradient, so a gradient that is fp32 noise around 0 on both sides
    moves it by ±3e-4 either way): losses within 1e-5, client and server
    trees within 1e-4."""
    rcfg, tcfg = _configs(arch)
    kw = dict(n_clients=2, cut_reps=cut_reps, agg_interval=2,
              optimizer_name=opt,
              lr=1e-2 if opt == "sgd" else 3e-4)
    r_init, r_train = r_step(r_build(rcfg), remat=False, **kw)
    t_init, t_train = t_step(t_build(tcfg), remat=opt == "adam", **kw)
    rstate = r_init(jax.random.PRNGKey(0))
    client = params_from_numpy(_np(rstate["client"]), tcfg, "cpu")
    server = params_from_numpy(_np(rstate["server"]), tcfg, "cpu")
    opt_t = t_optimizer(opt, kw["lr"])
    tstate = {"client": client, "server": server,
              "opt": opt_t.init({"client": client, "server": server}),
              "step": 0}
    rng = np.random.default_rng(0)
    r_jit = jax.jit(r_train)
    for _ in range(3):
        batch = _batch(rng, rcfg, (2, 2), 16)
        rstate, rm = r_jit(rstate, _jax(batch))
        tstate, tm = t_train(tstate, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   **LOSS_TOL)
    for part in ("client", "server"):
        _close_trees(tstate[part], rstate[part], TOL)
