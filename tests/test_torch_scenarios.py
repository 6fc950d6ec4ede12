"""The port's time-varying scenarios against the reference's, on the CPU.

- Every preset of `repro_torch.scenarios` against `repro.scenarios`, from
  the same base pool and seed: `profiles_at`, `available_at` and
  `multipliers_at` bitwise for 40 rounds (verbatim numpy copies on the
  same seeded streams).
- The port's `Session` against the reference's under a preset, from the
  reference's initial units (narrowed VGG of `test_torch_session.py`: 4
  clients, 6 rounds, eval every 3, I=3, one thread): decisions, clocks,
  gather plans and participation plans bitwise, losses, accuracies and
  parameters within 1e-4 (fp32, other summation order).  Cases: the
  maximal-state ``churn-heavy`` cell of `tests/test_resume.py` (deadline
  faults, the estimating HASFL controller) and ``straggler-bursts`` under
  HASFL.
- A policy x preset grid through the port's `run_grid`: each cell
  bitwise equal to its own `run()`, and within 1e-4 of the reference's
  `run_grid` (decisions and clocks bitwise).
- Mesh mode at d=1 under a preset (the reference's external-mean Pallas
  kernel in interpret mode on its side).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.config as RC
import repro_torch.config as TC
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.api import run_grid as r_run_grid
from repro.core.latency import sample_devices as r_sample_devices
from repro.mesh import MeshSpec as RMesh
from repro.scenarios import list_presets as r_list_presets
from repro.scenarios import make_scenario as r_make_scenario
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.api import run_grid
from repro_torch.core.latency import sample_devices
from repro_torch.mesh import MeshSpec as TMesh
from repro_torch.scenarios import list_presets, make_scenario
from repro_torch.scenarios.traces import FIELDS
from repro_torch.utils.tree import tree_leaves

ARCH = "vgg9-torch-scenarios"
TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    # the reference resume test's maximal-state settings: churn masks,
    # deadline faults and the estimating controller
    "churn-heavy-deadline": dict(
        policy="hasfl", estimate=True, scenario="churn-heavy",
        scenario_seed=7, fault_mode="deadline", deadline_factor=2.0),
    "straggler-bursts-hasfl": dict(
        policy="hasfl", estimate=False, scenario="straggler-bursts",
        scenario_seed=3),
}
MESH_CELL = dict(policy="hasfl", scenario="straggler-bursts", scenario_seed=3)
GRID = [dict(policy=p, scenario=s, scenario_seed=5)
        for p in ("hasfl", "rbs+rms")
        for s in ("straggler-bursts", "flaky-uplink")]


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


def _kw(pkg, cell):
    sfl = (RC if pkg == "r" else TC).SFLConfig(lr=0.05, agg_interval=3)
    kw = dict(arch=ARCH, n_clients=4, partition="iid", n_train=200,
              n_test=50, rounds=6, eval_every=3, estimate=False, sfl=sfl)
    if pkg == "r":
        kw.update(conv_impl="kernel", update_impl="kernel")
    kw.update(cell)
    return kw


def _record(sim):
    """Record the gather plans and participation plans ``sim`` draws."""
    plans, parts = [], []
    draw = sim.store.segment_indices
    part = sim._segment_participation

    def drawing(*a):
        plans.append(draw(*a))
        return plans[-1]

    def participating(*a):
        out = part(*a)
        parts.append(None if out is None else np.asarray(out))
        return out

    sim.store.segment_indices = drawing
    sim._segment_participation = participating
    return plans, parts


def _same_arrays(a, b):
    return len(a) == len(b) and all(
        (x is None and y is None) or np.array_equal(x, y)
        for x, y in zip(a, b))


def _same_run(r, t):
    """Decisions, clocks and rounds bitwise; losses within 1e-4."""
    assert _same_arrays(r.b_history, t.b_history)
    assert _same_arrays(r.cut_history, t.cut_history)
    assert t.clock == r.clock
    assert t.rounds == r.rounds
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   err_msg=name, **TOL)


def _same_params(ref_sim, port_sim):
    r_leaves = jax.tree_util.tree_leaves(ref_sim._stacked)
    t_leaves = tree_leaves(port_sim._stacked)
    assert len(r_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, r_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _init(ref):
    return jax.tree_util.tree_map(np.asarray, ref.sim.units)


# ---------------------------------------------------------------------------
# presets, bitwise
# ---------------------------------------------------------------------------

def test_preset_names_match_reference():
    assert list_presets() == r_list_presets()


@pytest.mark.parametrize("name", sorted(r_list_presets()))
def test_preset_streams_match_reference(name):
    base = sample_devices(6, np.random.default_rng(4))
    r_base = r_sample_devices(6, np.random.default_rng(4))
    ours, theirs = make_scenario(name, base, seed=11), \
        r_make_scenario(name, r_base, seed=11)
    assert ours.n == theirs.n == 6
    for t in range(40):
        for a, b in zip(ours.profiles_at(t), theirs.profiles_at(t)):
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
        np.testing.assert_array_equal(ours.available_at(t),
                                      theirs.available_at(t))
        m, rm = ours.multipliers_at(t), theirs.multipliers_at(t)
        assert sorted(m) == sorted(rm) == sorted(FIELDS)
        for f in FIELDS:
            np.testing.assert_array_equal(m[f], rm[f])


def test_unknown_preset_raises():
    _register()
    with pytest.raises(KeyError, match="scenario preset"):
        TSession(TSpec(**_kw("t", dict(scenario="no-such-preset"))),
                 device="cpu")


# ---------------------------------------------------------------------------
# sessions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_scenario_session_matches_reference(case):
    _register()
    ref = RSession(RSpec(**_kw("r", CASES[case])))
    ref_plans, ref_parts = _record(ref.sim)
    r = ref.run()

    port = TSession(TSpec(**_kw("t", CASES[case])), device="cpu",
                    init_units=_init(ref))
    plans, parts = _record(port.sim)
    t = port.run()

    _same_run(r, t)
    assert _same_arrays(plans, ref_plans)
    assert _same_arrays(parts, ref_parts)
    _same_params(ref.sim, port.sim)
    # the scenario left the last round's trace state injected on both
    for a, b in zip(port.sim.devices, ref.sim.devices):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    np.testing.assert_array_equal(port.sim.available, ref.sim.available)
    if case.startswith("churn"):
        # churn and the deadline actually dropped clients
        assert any(p is not None and p.min() == 0.0 for p in parts)


def test_static_session_is_unchanged_by_scenario_plumbing():
    """``scenario=None`` keeps the hoisted static clock: the same run
    as the ``stable`` preset (a static pool), bitwise."""
    _register()
    runs = [TSession(TSpec(**_kw("t", dict(policy="rbs+rms", **extra))),
                     device="cpu").run()
            for extra in ({}, dict(scenario="stable"))]
    assert runs[0].clock == runs[1].clock
    assert runs[0].train_loss == runs[1].train_loss
    assert _same_arrays(runs[0].b_history, runs[1].b_history)


# ---------------------------------------------------------------------------
# policy x preset grids
# ---------------------------------------------------------------------------

def test_scenario_grid_cells_match_their_own_runs():
    _register()
    specs = [TSpec(**_kw("t", cell)) for cell in GRID]
    grid_sess = [TSession(s, device="cpu") for s in specs]
    grid = run_grid(grid_sess)
    for spec, sess, g in zip(specs, grid_sess, grid):
        alone = TSession(spec, device="cpu")
        r = alone.run()
        assert g.clock == r.clock
        assert g.train_loss == r.train_loss
        assert g.test_loss == r.test_loss
        assert g.test_acc == r.test_acc
        assert _same_arrays(g.b_history, r.b_history)
        assert _same_arrays(g.cut_history, r.cut_history)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(sess.sim._stacked), tree_leaves(alone.sim._stacked)))
    # the presets moved the clocks apart
    assert grid[0].clock != grid[1].clock


def test_scenario_grid_matches_reference_run_grid():
    _register()
    refs = [RSession(RSpec(**_kw("r", cell))) for cell in GRID]
    ports = [TSession(TSpec(**_kw("t", cell)), device="cpu",
                      init_units=_init(ref))
             for cell, ref in zip(GRID, refs)]
    r_res = r_run_grid(refs)
    t_res = run_grid(ports)
    for r, t, ref, port in zip(r_res, t_res, refs, ports):
        _same_run(r, t)
        _same_params(ref.sim, port.sim)


# ---------------------------------------------------------------------------
# mesh mode at d=1 under a preset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_reference():
    """(session, gather plans, result) of the reference's d=1 mesh run
    under ``straggler-bursts`` (its external-mean kernel interpreted)."""
    _register()
    r_kw = _kw("r", MESH_CELL)
    r_kw.update(update_impl="interpret", mesh=RMesh(devices=1, n_edges=2))
    ref = RSession(RSpec(**r_kw))
    plans, _ = _record(ref.sim)
    return ref, plans, ref.run()


@pytest.mark.parametrize("update_impl", [None, "kernel"],
                         ids=["inline", "op"])
def test_mesh_session_under_scenario_matches_reference(mesh_reference,
                                                       update_impl):
    """``"kernel"`` runs the external-mean update's plain version (kernel
    3's) on the CPU, ``None`` the inline algebra."""
    ref, ref_plans, r = mesh_reference
    _register()
    port = TSession(TSpec(**_kw("t", MESH_CELL), update_impl=update_impl,
                          mesh=TMesh(devices=1, n_edges=2)),
                    device="cpu", init_units=_init(ref))
    plans, _ = _record(port.sim)
    t = port.run()
    _same_run(r, t)
    assert _same_arrays(plans, ref_plans)
    _same_params(ref.sim, port.sim)
