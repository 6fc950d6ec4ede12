"""The port's mesh mode against the reference's, on the CPU.

Mesh mode (DESIGN.md §15) shards the stacked client axis over devices
with a two-tier Eq. 4/7 mean, a tiered clock and a cohort bank.  The
reference runs it under `shard_map` (`repro.mesh`), the port on a
`torch.distributed` process group (`repro_torch.mesh`): a world of one
made by the session itself at d=1, and two spawned gloo processes at
d=2.  The same specs run through both packages from the reference's
initial units (the reference with ``update_impl="interpret"``, so its
external-mean Pallas kernel ``_kernel_ext`` is on the path, and the
im2col conv).  The host plane is the same numpy code on the same seeded
streams, so decisions, clocks, gather plans, cohort rotations, pools and
profiles must be bitwise equal; losses, accuracies and parameters agree
within 1e-4 (fp32, the edge sums reassociate).  The kernel-level bar is
the reference's own (`tests/test_mesh.py`): rtol 1e-5, atol 1e-6.
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
import repro.mesh.topology as RTOP
import repro_torch.config as TC
import repro_torch.mesh.topology as TTOP
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.api import TrafficSpec as RTraffic
from repro.kernels.clip_sgd import clip_sgd_update
from repro.mesh import MeshSpec as RMesh
from repro.mesh.bank import CohortBank as RBank
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.api import TrafficSpec as TTraffic
from repro_torch.core import split as TSP
from repro_torch.kernels import clip_sgd as TCS
from repro_torch.kernels import ops as TOPS
from repro_torch.mesh import CohortBank as TBank
from repro_torch.mesh import MeshSpec as TMesh
from repro_torch.mesh import sharded as TSH
from repro_torch.utils.tree import tree_leaves
from test_torch_kernels_cuda import (CLIP_TOL, LEAF_DS, LEAF_KEEPS,
                                     leaf_cases, leaf_weights)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "vgg9-torch-mesh"
TOL = dict(rtol=1e-4, atol=1e-4)
TIGHT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _register():
    for C in (RC, TC):
        base = C.get_config("vgg9-cifar-small")
        C.register(dataclasses.replace(
            base, arch_id=ARCH, conv_channels=(8, 16, 16), fc_dims=(32,),
            image_size=16))


def _kw(pkg, **mesh):
    """One spec's fields for the reference (``pkg="r"``) or the port."""
    sfl = (RC if pkg == "r" else TC).SFLConfig(lr=0.05, agg_interval=3)
    mesh_cls = RMesh if pkg == "r" else TMesh
    kw = dict(arch=ARCH, n_clients=8, partition="iid", n_train=256,
              n_test=64, seed=3, policy="hasfl", estimate=True, rounds=6,
              eval_every=3, sfl=sfl,
              mesh=mesh_cls(**{"devices": 1, **mesh}))
    if pkg == "r":
        kw.update(conv_impl="kernel", update_impl="interpret")
    return kw


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
    """``reference(**mesh)`` -> (session, initial units, gather plans,
    result) of one reference mesh run, run once per mesh config."""
    runs = {}

    def run(**mesh):
        key = tuple(sorted(mesh.items()))
        if key not in runs:
            _register()
            sess = RSession(RSpec(**_kw("r", **mesh)))
            init = jax.tree_util.tree_map(np.asarray, sess.sim.units)
            plans = _record_plans(sess.sim)
            runs[key] = (sess, init, plans, sess.run())
        return runs[key]

    return run


def _port(init, update_impl=None, **mesh):
    _register()
    sess = TSession(TSpec(update_impl=update_impl, **_kw("t", **mesh)),
                    device="cpu", init_units=init)
    plans = _record_plans(sess.sim)
    return sess, plans, sess.run()


def _same_run(r, t):
    """Decisions and clocks bitwise; losses and accuracies within 1e-4."""
    for name in ("b_history", "cut_history"):
        a, b = getattr(r, name), getattr(t, name)
        assert len(a) == len(b) and all(
            np.array_equal(x, y) for x, y in zip(a, b)), name
    assert t.clock == r.clock
    assert t.rounds == r.rounds
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   err_msg=name, **TOL)


def _same_params(ref_sim, port_leaves, lo=0):
    r_leaves = jax.tree_util.tree_leaves(ref_sim._stacked)
    assert len(r_leaves) == len(port_leaves)
    for a, b in zip(port_leaves, r_leaves):
        a = np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b)[lo:lo + a.shape[0]],
                                   **TOL)


# ---------------------------------------------------------------------------
# topology algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_edges", [1, 2, 4, 8])
def test_topology_matches_reference(n_edges):
    rng = np.random.default_rng(n_edges)
    v = rng.normal(size=(8, 3, 2))
    w = np.asarray([0.5, 0.0, 1.0, 0.25, 0.0, 0.0, 1.0, 0.125])
    np.testing.assert_array_equal(TTOP.edge_assignment(8, n_edges),
                                  RTOP.edge_assignment(8, n_edges))
    for got, want in zip(TTOP.edge_partials(v, w, n_edges),
                         RTOP.edge_partials(v, w, n_edges)):
        np.testing.assert_array_equal(got, want)
    for ws in (w, np.ones(8), np.zeros(8)):
        np.testing.assert_array_equal(TTOP.two_tier_mean(v, ws, n_edges),
                                      RTOP.two_tier_mean(v, ws, n_edges))
        np.testing.assert_array_equal(TTOP.flat_mean(v, ws),
                                      RTOP.flat_mean(v, ws))
    with pytest.raises(ValueError, match="must divide"):
        TTOP.edge_assignment(8, 3)


@pytest.mark.parametrize("n_edges", [1, 2, 4])
def test_two_tier_common_matches_topology(n_edges):
    """The process-group combine on a world of one equals the numpy
    two-tier mean (and its survivor count), fractional weights and the
    zero-survivor guard included."""
    TSH.join_group(TMesh(devices=1), torch.device("cpu"))
    rng = np.random.default_rng(11)
    v = rng.normal(size=(8, 5)).astype(np.float32)
    for w in (np.asarray([0.5, 0, 1, 0.25, 0, 0, 1, 0.125], np.float32),
              np.zeros(8, np.float32)):
        common, cnt = TSP.two_tier_common(
            torch.from_numpy(v), torch.from_numpy(w), 8 // n_edges,
            torch.distributed.group.WORLD)
        np.testing.assert_allclose(common.numpy(),
                                   RTOP.two_tier_mean(v, w, n_edges), **TIGHT)
        assert float(cnt) == pytest.approx(float(w.sum()))


# ---------------------------------------------------------------------------
# kernel 3: the external-mean clip+SGD update
# ---------------------------------------------------------------------------

WEIGHTS = {
    "fractional": [1, 0, 0.5, 1, 0, 0.25, 1, 1],
    "full": [1] * 8,
    "drop-everyone": [0] * 8,
}


@pytest.mark.parametrize("keep_all", [True, False], ids=["keep", "agg"])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_clip_sgd_ext_matches_reference_kernel(weights, keep_all):
    """The port's plain version (and the op on CPU tensors) against the
    reference's ``_kernel_ext`` in interpret mode, with the participation
    weights folded into the precomputed mean — agg and non-agg rounds, as
    `tests/test_mesh.py` holds the reference's two variants."""
    rng = np.random.default_rng(7)
    n, d, gamma = 8, 37, 0.1
    p = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    w = np.asarray(WEIGHTS[weights], np.float32)
    spec = p - gamma * (g * scale[:, None])
    cnt = w.sum()
    common = ((spec * w[:, None]).sum(0) / (cnt if cnt > 0 else 1.0)) \
        .astype(np.float32)
    keep = np.logical_and(keep_all, w > 0)
    use_common = bool(not keep.any() and cnt > 0)
    want = np.asarray(clip_sgd_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(scale),
        jnp.asarray(keep), jnp.asarray(w), gamma=gamma, block_d=16,
        interpret=True, common=jnp.asarray(common),
        use_common=jnp.asarray(use_common)))
    args = [torch.from_numpy(a) for a in (p, g, scale, keep, common)]
    got = TCS.clip_sgd_ext_plain(*args, torch.tensor(use_common),
                                 gamma=gamma)
    np.testing.assert_allclose(got.numpy(), want, **TIGHT)
    via_op = TOPS.clip_sgd(*args[:4], torch.from_numpy(w), gamma=gamma,
                           common=args[4], use_common=use_common)
    np.testing.assert_array_equal(via_op.numpy(), got.numpy())
    if weights == "drop-everyone":
        np.testing.assert_array_equal(got.numpy(), p)   # holds params


@pytest.mark.parametrize("n,part", leaf_cases())
def test_clip_sgd_ext_leaves_matches_reference_kernel(n, part):
    """One round's external-mean call over mixed leaves (``commons`` and
    the global survivor count) against the reference's per-leaf
    ``_kernel_ext`` in interpret mode: leaf i keeps ``keep_spec_i`` for the
    survivors and takes its mean where ``cnt > 0 and not keep_spec_i``."""
    rng = np.random.default_rng(23 + n)
    gamma = 0.1
    w = leaf_weights(rng, n, part)
    w_eff = np.ones((n,), np.float32) if w is None else w
    cnt = w_eff.sum(dtype=np.float32)
    ps, gs, commons = [], [], []
    scale = rng.uniform(0.5, 1.0, size=n).astype(np.float32)
    for d in LEAF_DS:
        p = rng.normal(size=(n, d)).astype(np.float32)
        g = rng.normal(size=(n, d)).astype(np.float32)
        spec = p - gamma * (g * scale[:, None])
        ps.append(p)
        gs.append(g)
        commons.append(((spec * w_eff[:, None]).sum(0)
                        / (cnt if cnt > 0 else 1.0)).astype(np.float32))
    outs = TOPS.clip_sgd_leaves(
        [torch.from_numpy(p) for p in ps], [torch.from_numpy(g) for g in gs],
        torch.from_numpy(scale), list(LEAF_KEEPS),
        None if w is None else torch.from_numpy(w), gamma=gamma,
        commons=[torch.from_numpy(c) for c in commons],
        count=torch.tensor(cnt))
    for p, g, c, keep_spec, out in zip(ps, gs, commons, LEAF_KEEPS, outs):
        keep = np.logical_and(keep_spec, w_eff > 0)
        use = bool(cnt > 0 and not keep_spec)
        want = np.asarray(clip_sgd_update(
            jnp.asarray(p), jnp.asarray(g), jnp.asarray(scale),
            jnp.asarray(keep), None, gamma=gamma, block_d=128,
            interpret=True, common=jnp.asarray(c),
            use_common=jnp.asarray(use)))
        np.testing.assert_allclose(out.numpy(), want, **CLIP_TOL)
        if not keep.any() and not use:
            np.testing.assert_array_equal(out.numpy(), p)  # holds params


# ---------------------------------------------------------------------------
# d=1 sessions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("update_impl", [None, "kernel"],
                         ids=["inline", "op"])
@pytest.mark.parametrize("n_edges", [1, 4])
def test_mesh_session_matches_reference(reference, n_edges, update_impl):
    ref, init, ref_plans, r = reference(n_edges=n_edges)
    port, plans, t = _port(init, update_impl, n_edges=n_edges)
    _same_run(r, t)
    assert len(plans) == len(ref_plans)
    for x, y in zip(plans, ref_plans):
        np.testing.assert_array_equal(x, y)
    _same_params(ref.sim, tree_leaves(port.sim._stacked))
    assert port.sim.n_local == 8


@pytest.mark.parametrize("tiered", [True, False])
def test_tiered_clock_matches_reference(reference, tiered):
    """Edge resources priced by the tiered clock (and opted out of with
    ``tiered_latency=False``) give the reference's clock bitwise."""
    mesh = dict(n_edges=4, edge_flops=1e9, edge_bw=1e8,
                tiered_latency=tiered)
    _, init, _, r = reference(**mesh)
    _, _, t = _port(init, **mesh)
    _same_run(r, t)
    co_located = reference(n_edges=4)[3]
    if tiered:
        assert all(s > f for s, f in zip(t.clock, co_located.clock))
    else:
        assert t.clock == co_located.clock


# ---------------------------------------------------------------------------
# cohort bank
# ---------------------------------------------------------------------------

def test_cohort_bank_derivations_match_reference():
    r = RBank(RMesh(population=64), n_resident=8, n_train=256)
    t = TBank(TMesh(population=64), n_resident=8, n_train=256)
    for lid in (0, 17, 63):
        np.testing.assert_array_equal(t.pool(lid), r.pool(lid))
        assert dataclasses.astuple(t.profile(lid)) == \
            dataclasses.astuple(r.profile(lid))
    for _ in range(3):
        np.testing.assert_array_equal(t.sample_cohort(), r.sample_cohort())


def test_cohort_bank_session_matches_reference(reference):
    """Population 64 on 8 resident slots: the rotation at t=3, the
    resident ids, every slot's pool and profile bitwise; losses and
    parameters within 1e-4."""
    ref, init, ref_plans, r = reference(n_edges=4, population=64)
    port, plans, t = _port(init, n_edges=4, population=64)
    _same_run(r, t)
    rb, tb = ref.sim._bank, port.sim._bank
    assert tb.rotations == rb.rotations == 1
    np.testing.assert_array_equal(tb.resident, rb.resident)
    for x, y in zip(port.sim.store.client_indices,
                    ref.sim.store.client_indices):
        np.testing.assert_array_equal(x, y)
    assert [dataclasses.astuple(d) for d in port.sim.devices] == \
        [dataclasses.astuple(d) for d in ref.sim.devices]
    for x, y in zip(plans, ref_plans):
        np.testing.assert_array_equal(x, y)
    _same_params(ref.sim, tree_leaves(port.sim._stacked))
    with pytest.raises(ValueError, match="agg-aligned"):
        tb.rotate(port.sim, 4)


def test_set_pool_rebinds_and_refuses_empty():
    _register()
    sess = TSession(TSpec(**_kw("t", n_edges=4, population=64)),
                    device="cpu")
    store = sess.sim.store
    store.set_pool(2, np.arange(5))
    np.testing.assert_array_equal(store.client_indices[2], np.arange(5))
    with pytest.raises(ValueError, match="non-empty"):
        store.set_pool(2, [])


# ---------------------------------------------------------------------------
# spec validation
# ---------------------------------------------------------------------------

BAD_SPECS = {
    "with-traffic": dict(traffic="on"),
    "with-checkpointing": dict(checkpoint_every=3, checkpoint_dir="unused"),
    "edges-not-dividing-n": dict(mesh=dict(n_edges=3)),
    "without-scan-engine": dict(engine="vectorized"),
    "dropout-faults": dict(fault_mode="dropout"),
    "population-below-n": dict(mesh=dict(n_edges=4, population=4)),
    "shards-split-edges": dict(mesh=dict(devices=4, n_edges=2)),
    "bank-with-scenario": dict(mesh=dict(n_edges=4, population=64),
                               scenario="churn-heavy"),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_mirrors_reference(case):
    errors = []
    for pkg in ("r", "t"):
        over = dict(BAD_SPECS[case])
        kw = _kw(pkg, **over.pop("mesh", {"n_edges": 4}))
        if over.pop("traffic", None):
            over["traffic"] = RTraffic() if pkg == "r" else TTraffic()
        kw.update(over)
        with pytest.raises(ValueError) as err:
            (RSpec if pkg == "r" else TSpec)(**kw).validated()
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_mesh_spec_json_round_trips_from_reference():
    """A reference mesh spec file loads in the port unchanged; mesh cells
    refuse to stack in a grid."""
    text = RSpec(**_kw("r", n_edges=4, population=64, edge_flops=1e9,
                       edge_bw=1e8)).to_json()
    spec = TSpec.from_json(text)
    assert isinstance(spec.mesh, TMesh)
    assert spec.to_json() == text
    assert spec.grid_key() is None
    assert spec.replace(mesh=None).grid_key() is not None


def test_multi_device_mesh_needs_an_explicit_group():
    """d > 1 in one process: a missing group (or a world of the wrong
    size) raises — nothing falls back to one device."""
    _register()
    with pytest.raises((RuntimeError, ValueError), match="mesh.devices=2"):
        TSession(TSpec(**_kw("t", devices=2, n_edges=4)), device="cpu")


# ---------------------------------------------------------------------------
# d=2: two gloo processes
# ---------------------------------------------------------------------------

_RANK = r"""
import dataclasses, sys
import repro_torch.config as C
from repro_torch.mesh import launch
base = C.get_config("vgg9-cifar-small")
C.register(dataclasses.replace(base, arch_id=%r, conv_channels=(8, 16, 16),
                               fc_dims=(32,), image_size=16))
launch.main(sys.argv[1:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(threads: int = 1):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["GLOO_SOCKET_IFNAME"] = "lo"
    env["OMP_NUM_THREADS"] = str(threads)
    return env


def test_two_gloo_ranks_match_reference_d1(reference, tmp_path):
    """d=2 on two spawned gloo processes (explicit 127.0.0.1, port, world
    size and rank) against the reference d=1 run: clocks, decisions and
    gather plans bitwise, losses and parameters within 1e-4, and each
    rank's carry holds N/2 rows."""
    ref, init, ref_plans, r = reference(n_edges=4)
    _register()
    spec = TSpec(**_kw("t", devices=2, n_edges=4))
    spec.save(tmp_path / "spec.json")
    torch.save([{k: torch.tensor(np.asarray(v)) for k, v in u.items()}
                for u in init], tmp_path / "init.pt")
    port = _free_port()
    args = ["--spec", str(tmp_path / "spec.json"), "--devices", "2",
            "--cpu", "--port", str(port), "--init", str(tmp_path / "init.pt"),
            "--out", str(tmp_path / "out")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK % ARCH] + args + ["--rank", str(rank)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(2)]
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
        assert got["n_local"] == 4
        t = SimpleNamespace(rounds=got["rounds"], clock=got["clock"],
                    train_loss=got["train_loss"], test_loss=got["test_loss"],
                    test_acc=got["test_acc"],
                    b_history=[b.numpy() for b in got["b_history"]],
                    cut_history=[c.numpy() for c in got["cut_history"]])
        _same_run(r, t)
        assert len(got["plans"]) == len(ref_plans)
        for x, y in zip(got["plans"], ref_plans):
            np.testing.assert_array_equal(x.numpy(), y)
        assert all(leaf.shape[0] == 4 for leaf in got["leaves"])
        _same_params(ref.sim, got["leaves"], lo=4 * rank)


def test_launcher_two_ranks_match_one(tmp_path):
    """`python -m repro_torch.mesh.launch --devices 2 --cpu --check-d1`
    (the parent spawning its own ranks, then a d=1 run it holds them
    against) passes its own check and reproduces the in-process d=1 run:
    clocks and decisions bitwise, losses within 1e-4."""
    spec = TSpec(arch="vgg9-cifar-small", n_clients=4, partition="iid",
                 n_train=64, n_test=16, rounds=2, eval_every=1,
                 policy="fixed(b=4,cut=3)", estimate=False,
                 sfl=TC.SFLConfig(lr=0.05, agg_interval=2),
                 mesh=TMesh(devices=2, n_edges=2, population=16))
    spec.save(tmp_path / "spec.json")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.mesh.launch", "--spec",
         str(tmp_path / "spec.json"), "--devices", "2", "--cpu", "--port",
         str(_free_port()), "--out", str(tmp_path / "out"), "--check-d1"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"ok": true' in out.stdout.splitlines()[-1]
    one = TSession(spec.replace(mesh=dataclasses.replace(spec.mesh,
                                                         devices=1)),
                   device="cpu").run()
    for rank in range(2):
        got = torch.load(tmp_path / "out" / f"rank{rank}.pt")
        assert got["clock"] == one.clock
        assert all(np.array_equal(b.numpy(), x)
                   for b, x in zip(got["b_history"], one.b_history))
        np.testing.assert_allclose(got["train_loss"], one.train_loss, **TOL)
        np.testing.assert_allclose(got["test_loss"], one.test_loss, **TOL)
