"""Token cells in the port's mesh mode against the reference's, on the
CPU.

A token `Session` with a `MeshSpec` shards its client-stacked units
(bf16 weights beside fp32 norm scales at the registered type) over a
`torch.distributed` group: a world of one made by the session at d=1,
two spawned gloo processes at d=2.  The Eq. 4/7 mean is the two-tier
combine in the leaf's type; with ``update_impl="kernel"`` the external
form of kernel 3 applies it (its plain version here).  Each port run
starts from the reference's initial units and is held against the
reference run of the same spec and impl: decisions, clocks, gather
plans, cohort rotations, pools and profiles bitwise; losses and
parameters within 1e-4 at fp32, losses within 1e-3 and parameters within
one bf16 ulp at bf16 (the two frameworks round a product or a mean at
other places, and a weight then moves by whole ulps).

Kernel 3 on bf16 leaves: its plain version against the reference's
oracle (`clip_sgd_ref` with a mean) and the kernel's own arithmetic (fp32,
rounded once on the store: what `chip_smoke.py` holds the CUDA kernel
to) against the reference's ``_kernel_ext`` in interpret mode.  The two
round at different points (the plain form rounds ``gamma·g`` to the leaf's
type before the subtraction), so each is held to its own counterpart.

gloo takes bf16 all-reduces, so the two-rank run is at the registered
bf16 type as well as fp32.
"""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.kernels.clip_sgd import clip_sgd_update
from repro.kernels.ref import clip_sgd_ref
from repro.mesh import MeshSpec as RMesh
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.core import split as TSP
from repro_torch.kernels import clip_sgd as TCS
from repro_torch.mesh import MeshSpec as TMesh
from repro_torch.mesh import sharded as TSH
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7     # a bf16 value's ulp, relative, at most
FAMILIES = ["smollm-tiny", "qwen3-1.7b", "glm4-9b", "phi3-mini-3.8b",
            "dbrx-132b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
            "internvl2-1b", "xlstm-350m"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _register(dtype, arch="smollm-tiny"):
    name = f"{arch}-tmesh-{dtype}"
    for C in (RC, TC):
        cfg = C.get_config(arch)
        if arch != "smollm-tiny":
            cfg = C.reduced(cfg)
        C.register(dataclasses.replace(cfg, arch_id=name, dtype=dtype))
    return name


def _kw(pkg, dtype, impl, **mesh):
    """One spec's fields for the reference (``pkg="r"``) or the port."""
    C, M = (RC, RMesh) if pkg == "r" else (TC, TMesh)
    return dict(arch=_register(dtype), n_clients=4, partition="iid",
                n_train=128, n_test=16, seq_len=16, seed=0, policy="hasfl",
                estimate=False, rounds=4, eval_every=2, update_impl=impl,
                sfl=C.SFLConfig(lr=0.05, agg_interval=2),
                mesh=M(**{"devices": 1, **mesh}))


def _record_plans(sim):
    plans = []
    draw = sim.store.segment_indices

    def recording(*a):
        plans.append(draw(*a))
        return plans[-1]

    sim.store.segment_indices = recording
    return plans


@pytest.fixture(scope="module")
def reference():
    """``reference(dtype, impl, **mesh)`` -> (session, initial units,
    gather plans, result) of one reference mesh run, run once per
    configuration (its ``"kernel"`` impl is ``_kernel_ext`` in interpret
    mode off the TPU)."""
    runs = {}

    def run(dtype, impl, **mesh):
        key = (dtype, impl, tuple(sorted(mesh.items())))
        if key not in runs:
            sess = RSession(RSpec(**_kw("r", dtype, impl, **mesh)))
            init = jax.tree_util.tree_map(np.asarray, sess.sim.units)
            plans = _record_plans(sess.sim)
            runs[key] = (sess, init, plans, sess.run())
        return runs[key]

    return run


def _port(init, dtype, impl, **mesh):
    sess = TSession(TSpec(**_kw("t", dtype, impl, **mesh)), device="cpu",
                    init_units=init)
    plans = _record_plans(sess.sim)
    return sess, plans, sess.run()


def _same_run(r, t, dtype):
    for name in ("b_history", "cut_history"):
        a, b = getattr(r, name), getattr(t, name)
        assert len(a) == len(b) and all(
            np.array_equal(x, y) for x, y in zip(a, b)), name
    assert t.clock == r.clock and t.rounds == r.rounds
    tol = 1e-4 if dtype == "float32" else 1e-3
    for name in ("train_loss", "test_loss"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   rtol=tol, atol=tol, err_msg=name)


def _same_params(ref_sim, port_leaves, dtype, lo=0):
    r_leaves = jax.tree_util.tree_leaves(ref_sim._stacked)
    assert len(r_leaves) == len(port_leaves)
    for a, b in zip(port_leaves, r_leaves):
        a = torch.as_tensor(a)
        bf16 = a.dtype == torch.bfloat16
        a = a.float().numpy()
        b = np.asarray(b, np.float32)[lo:lo + a.shape[0]]
        # a bf16 leaf within one ulp; an fp32 leaf (the norm scales beside
        # a bf16 model's weights too) at the fp32 bar
        if bf16:
            np.testing.assert_allclose(a, b, rtol=BF16_ULP, atol=1e-3)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _same_fp32_updates(init, ref_sim, port_leaves):
    """Each fp32 leaf's update (final minus initial units) within 5 % of
    the reference's largest entry of it: where the norm scales beside bf16
    weights move by less than the parameter bar, a frozen or wrong update
    still fails here."""
    r_leaves = jax.tree_util.tree_leaves(ref_sim._stacked)
    i_leaves = jax.tree_util.tree_leaves(init)
    checked = 0
    for a, b, c in zip(port_leaves, r_leaves, i_leaves):
        if a.dtype != torch.float32:
            continue
        c = np.asarray(c, np.float32)
        dt = a.numpy() - c
        dr = np.asarray(b, np.float32)[:a.shape[0]] - c
        assert np.abs(dt - dr).max() <= 0.05 * np.abs(dr).max()
        checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# kernel 3 on bf16 leaves
# ---------------------------------------------------------------------------

def _bf16_case(seed, n=8, d=37, gamma=0.1, edge=4):
    """bf16 p, g (as the reference holds them), fp32 clip factors and
    weights, and the leaf-type mean as the reference's `two_tier_common`
    makes it on one device (edge sums of ``edge`` clients, their total,
    the count and the division in bf16)."""
    rng = np.random.default_rng(seed)
    p = jnp.asarray(rng.normal(size=(n, d)), jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=(n, d)), jnp.bfloat16)
    scale = jnp.asarray(rng.uniform(0.5, 1.0, n), jnp.float32)
    w = jnp.asarray([1, 0, 0.5, 1, 0, 0.25, 1, 1], jnp.float32)
    spec = p - gamma * (g * scale[:, None]).astype(p.dtype)
    wb = w.astype(spec.dtype)
    edges = (spec * wb[:, None]).reshape(n // edge, edge, d).sum(axis=1)
    cnt = wb.sum()
    common = edges.sum(axis=0) / jnp.where(cnt > 0, cnt, 1.0)
    return p, g, scale, w, common, gamma


def _t(a):
    """A jnp array as a torch tensor of its type (bf16 through fp32, which
    holds every bf16 value)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("use", [True, False])
@pytest.mark.parametrize("keep_all", [True, False], ids=["keep", "agg"])
def test_clip_sgd_ext_plain_bf16_matches_reference_oracle(keep_all, use):
    """The plain external form on bf16 leaves against the reference's
    oracle with a mean: the same ops; on the spec rows XLA keeps
    ``p - gamma·g`` in fp32 inside its fusion where the port rounds
    ``gamma·g`` to bf16 first, so those rows agree within one bf16 ulp of
    the operands (|p| + |gamma·g·s|); the mean and held rows bitwise."""
    p, g, scale, w, common, gamma = _bf16_case(5)
    keep = jnp.logical_and(keep_all, w > 0)
    want = clip_sgd_ref(p, g, scale, keep, gamma=gamma, common=common,
                        use_common=jnp.asarray(use))
    got = TCS.clip_sgd_ext_plain(_t(p), _t(g), _t(scale), _t(keep),
                                 _t(common), torch.tensor(use), gamma=gamma)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    f32 = lambda a: np.asarray(a, np.float32)
    bar = BF16_ULP * (np.abs(f32(p)) + gamma * np.abs(
        f32(g) * f32(scale)[:, None]))
    assert (np.abs(got.float().numpy() - want) <= bar).all()
    if not keep_all:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("use", [True, False])
@pytest.mark.parametrize("keep_all", [True, False], ids=["keep", "agg"])
def test_clip_sgd_ext_kernel_arithmetic_bf16_matches_kernel_ext(keep_all,
                                                               use):
    """The kernel's arithmetic on bf16 leaves — the plain form on the
    leaves widened to fp32 (the mean widened by the wrapper), rounded once
    to bf16 on the store — against the reference's ``_kernel_ext`` in
    interpret mode, bitwise: `chip_smoke.py` holds the CUDA kernel to the
    former within one bf16 ulp.  The round's call takes the global count
    and a leaf's keep flag; the mean is used where the count is positive
    and the leaf does not keep, as `hasfl_round_update` sets the flag."""
    p, g, scale, w, common, gamma = _bf16_case(9, d=300)
    keep = jnp.logical_and(keep_all, w > 0)
    want = clip_sgd_update(p, g, scale, keep, None, gamma=gamma,
                           block_d=128, interpret=True, common=common,
                           use_common=jnp.asarray(use and not keep_all))
    assert want.dtype == jnp.bfloat16
    got = TCS.clip_sgd_leaves_plain(
        [_t(p).float()], [_t(g).float()], _t(scale),
        [keep_all], _t(w), gamma=gamma, commons=[_t(common).float()],
        count=torch.tensor(float(use)))[0].to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_two_tier_common_runs_in_the_leaf_type():
    """The combine on bf16 results stays bf16 (edge sums, their total,
    count and division in the leaf's type, as the reference's) and
    matches the reference's combine on one device within one bf16 ulp of
    the summands' mean magnitude (a sum that cancels rounds to other
    neighbours in the two frameworks)."""
    TSH.join_group(TMesh(devices=1), torch.device("cpu"))
    p, g, scale, w, common, gamma = _bf16_case(5)
    spec = _t(p) - gamma * (_t(g) * _t(scale)[:, None]).to(torch.bfloat16)
    got, cnt = TSP.two_tier_common(spec, _t(w), 4,
                                   torch.distributed.group.WORLD)
    assert got.dtype == cnt.dtype == torch.bfloat16
    assert float(cnt) == float(np.asarray(w).sum())
    mag = (spec.float().abs() * _t(w)[:, None]).sum(0) / float(cnt)
    diff = (got.float() - torch.from_numpy(np.asarray(common, np.float32)))
    assert bool((diff.abs() <= BF16_ULP * mag).all())


def _bf16_units(seed, n=4):
    g = torch.Generator().manual_seed(seed)
    return [{"w": torch.randn((n, 3, 40), generator=g).to(torch.bfloat16),
             "norm": torch.rand((n, 40), generator=g)}]


def test_mesh_update_forms_agree_on_bf16_leaves():
    """On an aggregation round mesh mode's two update forms take the same
    two-tier mean of bf16 leaves: the inline algebra and the kernel
    path's combine both form each client's SGD result in the leaf's type
    (``p - gamma·g`` with ``g·scale`` rounded to it, the reference's
    `hasfl_round_update` on either path), so every row is bitwise equal."""
    TSH.join_group(TMesh(devices=1), torch.device("cpu"))
    group = torch.distributed.group.WORLD
    stacked, grads = _bf16_units(1), _bf16_units(2)
    scale = torch.tensor([0.9, 0.7, 1.0, 0.55])
    masks = np.asarray([1.0], np.float32)
    outs = [TSP.hasfl_round_update(
        [dict(u) for u in stacked], grads, masks, True, 0.1,
        grad_scale=scale, impl=impl, group=group, edge_size=2)
        for impl in (None, "kernel")]
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_client_mean_of_bf16_leaves_rounds_once():
    """The aggregate model of mesh mode on bf16 leaves: the fp32 sum
    divided by N and rounded once, as the reference's ``mean`` (and
    torch's) of a bf16 leaf (N=3: a bf16 sum divided by 3 would round
    twice)."""
    TSH.join_group(TMesh(devices=1), torch.device("cpu"))
    pm = TSH.build_process_mesh(TMesh(devices=1, n_edges=1), 3)
    units = _bf16_units(3, n=3)
    for got, a in zip(tree_leaves(pm.client_mean(units)),
                      tree_leaves(units)):
        assert got.dtype == a.dtype
        assert torch.equal(got, a.mean(dim=0))


# ---------------------------------------------------------------------------
# d=1 sessions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "kernel"], ids=["inline", "op"])
@pytest.mark.parametrize("n_edges", [1, 2])
def test_token_mesh_session_matches_reference(reference, n_edges, impl):
    ref, init, ref_plans, r = reference("float32", impl, n_edges=n_edges)
    port, plans, t = _port(init, "float32", impl, n_edges=n_edges)
    _same_run(r, t, "float32")
    assert len(plans) == len(ref_plans)
    assert all(np.array_equal(x, y) for x, y in zip(plans, ref_plans))
    _same_params(ref.sim, tree_leaves(port.sim._stacked), "float32")


def test_token_cohort_bank_bf16_matches_reference(reference):
    """Population 64 on 4 resident slots at the registered bf16, through
    kernel 3's external form: rotations at rounds 2, the resident ids,
    every slot's pool and profile and the gather plans bitwise; losses
    within 1e-3, parameters within one bf16 ulp."""
    mesh = dict(n_edges=2, population=64)
    ref, init, ref_plans, r = reference("bfloat16", "kernel", **mesh)
    port, plans, t = _port(init, "bfloat16", "kernel", **mesh)
    _same_run(r, t, "bfloat16")
    rb, tb = ref.sim._bank, port.sim._bank
    assert tb.rotations == rb.rotations == 1
    np.testing.assert_array_equal(tb.resident, rb.resident)
    for x, y in zip(port.sim.store.client_indices,
                    ref.sim.store.client_indices):
        np.testing.assert_array_equal(x, y)
    assert [dataclasses.astuple(d) for d in port.sim.devices] == \
        [dataclasses.astuple(d) for d in ref.sim.devices]
    assert all(np.array_equal(x, y) for x, y in zip(plans, ref_plans))
    leaves = tree_leaves(port.sim._stacked)
    assert {x.dtype for x in leaves} == {torch.bfloat16, torch.float32}
    _same_params(ref.sim, leaves, "bfloat16")
    _same_fp32_updates(init, ref.sim, leaves)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_runs_in_mesh_mode(arch):
    """Each token family that trains, reduced, at its registered type: a
    mesh cell on 2 edge servers with and without a cohort bank runs (the
    bank rotating once), finite, with the flat run's decisions and clock
    where the bank is off (the mesh clock is the tiered one, priced at
    zero edge cost here)."""
    name = _register(TC.get_config(arch).dtype, arch)
    kw = dict(arch=name, n_clients=4, partition="iid", n_train=64,
              n_test=8, seq_len=8, policy="hasfl", estimate=False,
              rounds=2, eval_every=2, sfl=TC.SFLConfig(lr=0.05,
                                                       agg_interval=1))
    flat = TSession(TSpec(**kw), device="cpu").run()
    for pop in (None, 16):
        sess = TSession(TSpec(**kw, mesh=TMesh(devices=1, n_edges=2,
                                               population=pop)),
                        device="cpu")
        res = sess.run()
        assert all(np.isfinite(res.train_loss + res.test_loss))
        assert all(bool(torch.isfinite(x.float()).all())
                   for x in tree_leaves(sess.sim._stacked))
        if pop is None:
            assert res.clock == flat.clock
            assert all(np.array_equal(a, b) for a, b in
                       zip(res.b_history, flat.b_history))
        else:
            assert sess.sim._bank.rotations == 1


# ---------------------------------------------------------------------------
# d=2: two gloo processes
# ---------------------------------------------------------------------------

_RANK = r"""
import dataclasses, sys
import repro_torch.config as C
from repro_torch.mesh import launch
C.register(dataclasses.replace(C.get_config("smollm-tiny"), arch_id=%r,
                               dtype=%r))
launch.main(sys.argv[1:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_gloo_ranks_match_reference_d1(reference, tmp_path, dtype):
    """d=2 token cell on two spawned gloo processes (explicit 127.0.0.1,
    port, world size and rank) against the reference's d=1 run of the
    same spec: clocks, decisions and gather plans bitwise, losses and
    parameters at the dtype's bar, each rank holding N/2 rows.  gloo
    all-reduces bf16, so the bf16 cell's edge sums stay bf16 as at d=1."""
    ref, init, ref_plans, r = reference(dtype, "kernel", n_edges=2)
    name = _register(dtype)
    spec = TSpec(**_kw("t", dtype, "kernel", devices=2, n_edges=2))
    spec.save(tmp_path / "spec.json")
    torch.save(tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                        list(init)), tmp_path / "init.pt")
    args = ["--spec", str(tmp_path / "spec.json"), "--devices", "2",
            "--cpu", "--port", str(_free_port()), "--init",
            str(tmp_path / "init.pt"), "--out", str(tmp_path / "out")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK % (name, dtype)] + args
        + ["--rank", str(rank)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    for rank in range(2):
        got = torch.load(tmp_path / "out" / f"rank{rank}.pt")
        assert got["n_local"] == 2
        t = SimpleNamespace(
            rounds=got["rounds"], clock=got["clock"],
            train_loss=got["train_loss"], test_loss=got["test_loss"],
            b_history=[b.numpy() for b in got["b_history"]],
            cut_history=[c.numpy() for c in got["cut_history"]])
        _same_run(r, t, dtype)
        assert all(np.array_equal(x.numpy(), y)
                   for x, y in zip(got["plans"], ref_plans))
        assert all(leaf.shape[0] == 2 for leaf in got["leaves"])
        _same_params(ref.sim, got["leaves"], dtype, lo=2 * rank)
