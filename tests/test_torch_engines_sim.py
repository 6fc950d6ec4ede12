"""The reference's engine tests, run on both packages at the simulator
level on the CPU, and the checks around the port's per-round engines.

Each simulator is built twice from the same seeded data, shards, sampler
stream and device pool (`tests/test_scan_engine.py`'s fixture, on a
narrow vgg9), the port's started from the reference's initial units:

- legacy against vectorized, with and without a reconfiguration that
  lowers the cut (`tests/test_dist_sharding.py`), at that file's bars;
- the three engines under dropout (`tests/test_faults.py`);
- the decision stream under ``flaky-uplink`` with the HASFL controller,
  legacy closing the triangle (`tests/test_scenarios.py`);
- the port's vectorized engine against its scan engine at a power-of-two
  ``b_max`` (`tests/test_scan_engine.py`'s schedule): bitwise, where the
  reference holds its own pair at ``TIGHT`` only;
- no two legacy clients share a tensor, and a reconfiguration that makes
  a shared unit client-specific lets the clients diverge as the
  reference's do;
- the ``vectorized=`` deprecation mapping (`tests/test_api.py`), and the
  reference's refusals of mesh, traffic and snapshots off the scan
  engine;
- the tree and unit-list helpers against the reference's.

Every port engine is also held against the reference's engine of the
same name: decisions and clocks bitwise, losses and parameters within
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.core.split as RSP
import repro.utils as RU
import repro.utils.tree as RUT
import repro_torch.config as TC
import repro_torch.core.split as TSP
import repro_torch.utils as TU
import repro_torch.utils.tree as TUT
from repro.core.latency import sample_devices as r_devices
from repro.core.profiles import model_profile as r_profile
from repro.core.sfl import SFLEdgeSimulator as RSim
from repro.data import ClientSampler as RSampler
from repro.data import make_cifar_like
from repro.data import partition_iid
from repro.mesh import MeshSpec as RMesh
from repro.models import build_model as r_build
from repro.scenarios import HASFLController as RHASFL
from repro.scenarios import make_scenario as r_scenario
from repro.traffic import TrafficPlane as RPlane
from repro.traffic import TrafficSpec as RTraffic
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.convert import units_from_numpy
from repro_torch.core.latency import sample_devices as t_devices
from repro_torch.core.profiles import model_profile as t_profile
from repro_torch.core.sfl import SFLEdgeSimulator as TSim
from repro_torch.data import ClientSampler as TSampler
from repro_torch.mesh import MeshSpec as TMesh
from repro_torch.models import build_model as t_build
from repro_torch.scenarios import HASFLController as THASFL
from repro_torch.scenarios import make_scenario as t_scenario
from repro_torch.traffic import TrafficPlane as TPlane
from repro_torch.traffic import TrafficSpec as TTraffic
from repro_torch.utils.tree import tree_leaves
from test_torch_engines import (assert_same_decisions, assert_same_draws,
                                client_leaves, draws)  # noqa: F401
from test_torch_session import ARCH, TOL, _register

TIGHT = dict(rtol=1e-5, atol=1e-6)          # tests/test_scan_engine.py
SEED_LOOP = dict(rtol=2e-3, atol=2e-4)      # tests/test_dist_sharding.py


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(engine, agg=3, fault_mode="soft"):
    """(reference simulator, port simulator on the CPU) of one engine,
    from the same data, streams, pool and initial units."""
    _register()
    sims = []
    init = None
    for C, build, sampler, devices, profile, Sim in (
            (RC, r_build, RSampler, r_devices, r_profile, RSim),
            (TC, t_build, TSampler, t_devices, t_profile, TSim)):
        cfg = C.get_config(ARCH)
        (xtr, ytr), (xte, yte) = make_cifar_like(10, 240, 60, 16, seed=3)
        shards = partition_iid(len(ytr), 4, np.random.default_rng(1))
        smp = sampler({"images": xtr, "labels": ytr}, shards,
                      np.random.default_rng(2))
        sfl = C.SFLConfig(n_devices=4, agg_interval=agg, lr=0.05)
        kw = dict(seed=0, engine=engine, fault_mode=fault_mode)
        if Sim is TSim:
            kw.update(device="cpu", init_units=units_from_numpy(init, "cpu"))
        sim = Sim(build(cfg), smp, {"images": xte, "labels": yte},
                  devices(4, np.random.default_rng(0)), sfl, profile(cfg),
                  **kw)
        if init is None:
            init = jax.tree_util.tree_map(np.asarray, sim.units)
        sims.append(sim)
    return sims


def _fixed(b=8, cut=3):
    def policy(s, rng):
        return np.full(s.n, b), np.full(s.n, cut)
    return policy


def _lowering():
    """Cut 4, then 2 from the first reconfiguration on."""
    calls = [0]

    def policy(s, rng):
        calls[0] += 1
        return np.full(s.n, 8), np.full(s.n, 4 if calls[0] == 1 else 2)
    return policy


def _close(t, r, tol):
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   err_msg=name, **tol)


def _params_close(sim_a, ref_a, sim_b, ref_b, tol):
    a, b = client_leaves(sim_a, ref_a), client_leaves(sim_b, ref_b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), **tol)


def _run_engines(engines, policy_fn, run_kw, prepare=None, **pair_kw):
    """Each engine on both packages: {engine: (ref res, ref sim, port res,
    port sim)}, each port engine held to its reference engine.
    ``prepare(sim)`` runs on every simulator before its run."""
    out = {}
    for eng in engines:
        rsim, tsim = _pair(eng, **pair_kw)
        for sim in (rsim, tsim):
            if prepare is not None:
                prepare(sim)
        r = rsim.run(policy_fn(), **run_kw)
        t = tsim.run(policy_fn(), **run_kw)
        assert_same_decisions(t, r)
        _close(t, r, TOL)
        _params_close(tsim, False, rsim, True, TOL)
        out[eng] = (r, rsim, t, tsim)
    return out


@pytest.mark.parametrize("lowering", [False, True],
                         ids=["fixed-cut", "reconfigured-lower-cut"])
def test_legacy_matches_vectorized(lowering, draws):
    """The seed-loop regression on both packages: equal losses, evals and
    final units; with a reconfiguration that lowers the cut mid-interval
    (still-diverged units move to the server side and both engines take
    the client mean as the Eq. 4 base)."""
    if lowering:
        policy, run_kw, agg = _lowering, dict(
            rounds=6, eval_every=1, reconfigure_every=2), 5
    else:
        policy, run_kw, agg = _fixed, dict(rounds=6, eval_every=1), 3
    out = _run_engines(("vectorized", "legacy"), policy, run_kw, agg=agg)
    for side in (0, 2):     # the reference's pair, then the port's
        v, lg = out["vectorized"][side], out["legacy"][side]
        np.testing.assert_allclose(v.train_loss, lg.train_loss, **SEED_LOOP)
        np.testing.assert_allclose(v.test_loss, lg.test_loss, **SEED_LOOP)
        np.testing.assert_allclose(v.test_acc, lg.test_acc, atol=0.051)
    _params_close(out["vectorized"][3], False, out["legacy"][3], False,
                  SEED_LOOP)
    assert_same_draws(draws)


def test_three_engines_under_dropout():
    """A static availability mask drops client 1: every engine's clock is
    the same bitwise, the port's vectorized engine is its scan engine
    bitwise (b = 8), legacy within the seed-loop bars; every port engine
    matches the reference's of its name."""
    avail = np.asarray([True, False, True, True])

    def prepare(sim):
        sim.set_devices(sim.devices, available=avail)

    out = _run_engines(("legacy", "vectorized", "scan"), _fixed,
                       dict(rounds=4, eval_every=2), prepare=prepare,
                       agg=2, fault_mode="dropout")
    t = {e: out[e][2] for e in out}
    sims = {e: out[e][3] for e in out}
    assert t["scan"].clock == t["vectorized"].clock == t["legacy"].clock
    for name in ("train_loss", "test_loss", "test_acc"):
        assert getattr(t["scan"], name) == getattr(t["vectorized"], name)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(sims["scan"]._stacked),
        tree_leaves(sims["vectorized"]._stacked)))
    np.testing.assert_allclose(t["scan"].test_loss, t["legacy"].test_loss,
                               **SEED_LOOP)
    # the dropped client held its client-specific units between
    # aggregations and re-synced at round 4's
    _params_close(sims["legacy"], False, sims["scan"], False, SEED_LOOP)


@pytest.mark.parametrize("engines", [("vectorized", "scan"),
                                     ("legacy", "scan")],
                         ids=["vectorized-scan", "legacy-scan"])
def test_decision_stream_under_flaky_uplink(engines):
    """The closed loop under ``flaky-uplink`` with the HASFL controller
    (estimation off, so decisions depend on the host trace alone)
    re-deciding every 2 rounds: the same clock and decision stream on
    every engine of both packages, losses at the reference's bars
    (vectorized-scan rtol 5e-4; legacy closes the triangle at the
    seed-loop bars)."""
    res = {}
    for eng in engines:
        rsim, tsim = _pair(eng, agg=3)
        for sim, scen, ctrl in ((rsim, r_scenario, RHASFL),
                                (tsim, t_scenario, THASFL)):
            scenario = scen("flaky-uplink", sim.devices, seed=9)
            c = ctrl(sim.profile, sim.sfl, estimate=False, solve_iters=3)
            res[eng, sim is tsim] = sim.run(
                c, rounds=6, eval_every=2, reconfigure_every=2,
                scenario=scenario)
        assert_same_decisions(res[eng, True], res[eng, False])
        _close(res[eng, True], res[eng, False], TOL)
        _params_close(tsim, False, rsim, True, TOL)
    a, b = engines
    assert_same_decisions(res[a, True], res[b, True])
    bar = dict(rtol=5e-4) if a == "vectorized" else SEED_LOOP
    for name in ("train_loss", "test_loss"):
        np.testing.assert_allclose(getattr(res[a, True], name),
                                   getattr(res[b, True], name), **bar)


def test_port_vectorized_is_its_scan_engine_bitwise():
    """`tests/test_scan_engine.py`'s schedule (b = 8 on every client, cut
    3, I = 3, evals every 2 rounds: three segments, a mid-run
    aggregation): at a power-of-two ``b_max`` the scan engine pads to
    ``b_max`` too, and both engines run the same round body on the same
    batches, so the port's pair agrees to the bit — losses, evals, clock
    and final parameters."""
    (_, vec), (_, scan) = _pair("vectorized"), _pair("scan")
    rv = vec.run(_fixed(), rounds=6, eval_every=2)
    rs = scan.run(_fixed(), rounds=6, eval_every=2)
    assert_same_decisions(rv, rs)
    for name in ("train_loss", "test_loss", "test_acc"):
        assert getattr(rv, name) == getattr(rs, name), name
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(vec._stacked),
                                                 tree_leaves(scan._stacked)))


def test_legacy_clients_share_no_tensor():
    """After a round in which every unit past the cut is server-common
    (one Eq. 4 result given to every client), an in-place edit of client
    0's copy leaves client 1's alone; then a reconfiguration that raises
    the cut makes those units client-specific, and the clients diverge as
    the reference's do."""
    _, sim = _pair("legacy", agg=5)
    sim.run(_fixed(cut=1), rounds=1, eval_every=1)
    cu = sim.client_units
    for u in range(1, len(cu[0])):
        ptrs = {cu[i][u]["w"].data_ptr() for i in range(sim.n)}
        assert len(ptrs) == sim.n
        assert torch.equal(cu[0][u]["w"], cu[1][u]["w"])
    before = cu[1][1]["w"].clone()
    cu[0][1]["w"].add_(1.0)
    assert torch.equal(cu[1][1]["w"], before)

    def raising():
        calls = [0]

        def policy(s, rng):
            calls[0] += 1
            return np.full(s.n, 8), np.full(s.n, 1 if calls[0] == 1 else 3)
        return policy

    out = _run_engines(("legacy",), raising,
                       dict(rounds=4, eval_every=2, reconfigure_every=2),
                       agg=5)
    for sim in (out["legacy"][1], out["legacy"][3]):
        w = [np.asarray(sim.client_units[i][1]["w"]) for i in range(2)]
        assert not np.allclose(w[0], w[1])


def test_vectorized_kwarg_deprecated():
    """``vectorized=`` warns and maps to the engine when ``engine`` is
    unset; ``engine=`` wins; unset gives the reference's default,
    ``vectorized``; an unknown name raises."""
    _register()
    sess = TSession(TSpec(arch=ARCH, n_clients=4, partition="iid",
                          n_train=200, n_test=50, rounds=2), device="cpu")
    args = dict(model=sess.model, sampler=sess.sampler,
                test_batch={k: v.numpy() for k, v in
                            sess.sim.test_batch.items()},
                devices=sess.devices, sfl=sess.sfl, profile=sess.profile,
                device="cpu")
    for flag, engine, want in ((False, None, "legacy"),
                               (True, None, "vectorized"),
                               (False, "scan", "scan")):
        with pytest.warns(DeprecationWarning, match="vectorized"):
            sim = TSim(**args, vectorized=flag, engine=engine)
        assert sim.engine == want
        assert sim.vectorized == (want != "legacy")
    assert TSim(**args).engine == "vectorized"
    with pytest.raises(ValueError, match="unknown round engine"):
        TSim(**args, engine="loop")


@pytest.mark.parametrize("engine", ["legacy", "vectorized"])
def test_scan_only_features_refuse_other_engines(engine, tmp_path):
    """Mesh mode, the traffic plane and snapshots need the scan engine, in
    the spec and in the simulator, with the reference's ``ValueError``s;
    such a spec has no grid key."""
    from repro.api import ExperimentSpec as RSpec

    _register()
    rsim, tsim = _pair(engine)
    for Spec, Traffic, Mesh, Plane, sim in (
            (RSpec, RTraffic, RMesh, RPlane, rsim),
            (TSpec, TTraffic, TMesh, TPlane, tsim)):
        for fields, match in (
                (dict(traffic=Traffic()), "traffic mode is a segment"),
                (dict(mesh=Mesh(devices=1)), "mesh mode shards the scan"),
                (dict(checkpoint_every=2, checkpoint_dir=str(tmp_path)),
                 "checkpointing is a segment-boundary feature")):
            with pytest.raises(ValueError, match=match):
                Spec(arch=ARCH, n_clients=4, engine=engine, **fields)\
                    .validated()
        assert Spec(arch=ARCH, engine=engine).grid_key() is None

        plane = Plane(Traffic(), n_train=240, cohort=4, capacity=4)
        with pytest.raises(ValueError, match="traffic mode needs"):
            sim.run(_fixed(), rounds=1, traffic=plane)
        with pytest.raises(ValueError, match="traffic mode needs"):
            plane.attach(sim)
        with pytest.raises(ValueError, match="segment-boundary objects"):
            sim.run(_fixed(), rounds=2, checkpoint_every=1,
                    snapshot_cb=lambda *a: None)
        extra = {"device": "cpu"} if sim is tsim else {}
        with pytest.raises(ValueError, match="mesh mode needs engine='scan'"):
            type(sim)(sim.model, sim.sampler,
                      {"images": np.zeros((1, 16, 16, 3), np.float32),
                       "labels": np.zeros(1, np.int32)},
                      sim.devices, sim.sfl, sim.profile, engine=engine,
                      mesh=Mesh(devices=1), **extra)


def test_tree_and_unit_helpers_match_the_reference():
    """`utils` `param_count`, `tree_bytes`, `map_leaves`,
    `tree_allfinite` and `core.split` `stack_unit_trees`, `merge_units`
    on the port's tensors against the reference's on the same arrays;
    `configs.ASSIGNED` and `training.make_optimizer` exported as there."""
    import repro.configs as RCF
    import repro.training as RTR
    import repro_torch.configs as TCF
    import repro_torch.training as TTR

    assert TCF.ASSIGNED == RCF.ASSIGNED
    assert callable(TTR.make_optimizer) and callable(RTR.make_optimizer)
    _register()
    cfg = RC.get_config(ARCH)
    units, _ = RSP.to_units(cfg, r_build(cfg).init(jax.random.PRNGKey(0)))
    ours = units_from_numpy(jax.tree_util.tree_map(np.asarray, units), "cpu")
    assert TU.param_count(ours) == RU.param_count(units) > 0
    assert TU.tree_bytes(ours) == RU.tree_bytes(units)
    half = TU.map_leaves(lambda a: a.half(), ours)
    assert TU.tree_bytes(half) == RU.tree_bytes(
        RU.map_leaves(lambda a: a.astype(jnp.float16), units))
    assert bool(TUT.tree_allfinite(ours)) and bool(RUT.tree_allfinite(units))
    ints = [{"i": torch.arange(3)}]
    assert bool(TUT.tree_allfinite(ints)) == bool(RUT.tree_allfinite(
        [{"i": jnp.arange(3)}])) is True
    bad = TU.map_leaves(torch.clone, ours)
    bad[1]["w"][0, 0, 0, 0] = float("nan")
    r_bad = jax.tree_util.tree_map(np.array, units)
    r_bad[1]["w"][0, 0, 0, 0] = np.nan
    assert not bool(TUT.tree_allfinite(bad))
    assert not bool(RUT.tree_allfinite(r_bad))

    clients = [TU.map_leaves(lambda a, i=i: a + i, ours) for i in range(3)]
    r_clients = [jax.tree_util.tree_map(lambda a, i=i: a + i, units)
                 for i in range(3)]
    stacked = TSP.stack_unit_trees(clients)
    r_stacked = RSP.stack_unit_trees(r_clients)
    for a, b in zip(tree_leaves(stacked), jax.tree_util.tree_leaves(
            r_stacked)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, back in enumerate(TSP.unstack_unit_trees(stacked, 3)):
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(back), tree_leaves(clients[i])))
    for cut in (1, 3):
        c, s = TSP.split_units(ours, cut, TC.get_config(ARCH))
        merged = TSP.merge_units(c, s)
        r_merged = RSP.merge_units(*RSP.split_units(units, cut, cfg))
        assert len(merged) == len(r_merged) == len(ours)
        assert all(m is o for m, o in zip(merged, ours))
