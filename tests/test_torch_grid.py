"""The port's grid runner (`repro_torch.api.run_grid`) on the CPU.

Grids of the narrowed VGG of `test_torch_session.py` (4 clients, 6
rounds, eval every 3, I=3, one thread):

- the port's grid against the port's own per-cell `Session.run()`,
  bitwise: decisions, clocks, rounds, losses, accuracies and every final
  parameter (`torch.equal`), on (a) three policies crossing pow2 buckets
  with the estimating HASFL controller, (b) seeds x partitions (cells
  reading their own data), (c) deadline faults x seeds (the participation
  lane) and (d) one bucket (the whole carry in one dispatch);
- the port's grid against the reference's `run_grid` on grid (a) from the
  reference's initial units: decisions, clocks and gather plans bitwise,
  losses, accuracies and parameters within 1e-4 (the bar of
  `test_torch_session.py`: fp32, other summation order);
- `group_cells` against the reference's, and the runner surface.
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
from repro.api import group_cells as r_group_cells
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.api import grid as TGRID
from repro_torch.api import run_grid
from repro_torch.api import runners as TRUN
from repro_torch.data.pipeline import DeviceClientStore
from repro_torch.utils import cells as TCELLS
from repro_torch.utils.tree import tree_leaves

ARCH = "vgg9-torch-grid"
TOL = dict(rtol=1e-4, atol=1e-4)
GRIDS = {
    # three pow2 buckets (b_pad 8, 16, 64): one dispatch a cell a segment,
    # and the estimating controller's boundary sync
    "a-policies": [dict(policy="fixed(b=8,cut=3)"), dict(policy="rbs+rms"),
                   dict(policy="hasfl", estimate=True)],
    # seeds x partitions: cells read their own data, two folded buckets
    "b-seeds": [dict(policy="hasfl", seed=s, partition=p)
                for s in (0, 1) for p in ("iid", "noniid-shards")],
    # deadline faults (a lone survivor at seed 0): the participation lane
    "c-deadline": [dict(policy=pol, seed=s, fault_mode="deadline",
                        deadline_factor=1.002)
                   for pol in ("fixed(b=8,cut=3)", "rbs+rms") for s in (0, 1)],
    # one bucket: the whole carry runs as one dispatch
    "d-one-bucket": [dict(policy="fixed(b=8,cut=3)", seed=s)
                     for s in (0, 1)] + [dict(policy="fixed(b=6,cut=2)")],
}


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


def _kw(cell, sfl_cls):
    kw = dict(arch=ARCH, n_clients=4, partition="iid", n_train=200,
              n_test=50, rounds=6, eval_every=3, estimate=False,
              sfl=sfl_cls(lr=0.05, agg_interval=3))
    kw.update(cell)
    return kw


def _specs(grid, **extra):
    return [TSpec(**_kw(dict(cell, **extra), TC.SFLConfig))
            for cell in GRIDS[grid]]


def _record_plans(sim):
    plans = []
    draw = sim.store.segment_indices

    def recording(*a):
        plans.append(draw(*a))
        return plans[-1]

    sim.store.segment_indices = recording
    return plans


def _same_history(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x, y) for x, y in zip(a, b))


def _assert_bitwise(r, s, sess_r, sess_s):
    assert r.rounds == s.rounds
    assert r.clock == s.clock
    assert r.train_loss == s.train_loss
    assert r.test_loss == s.test_loss
    assert r.test_acc == s.test_acc
    assert _same_history(r.b_history, s.b_history)
    assert _same_history(r.cut_history, s.cut_history)
    a, b = tree_leaves(sess_r.sim._stacked), tree_leaves(sess_s.sim._stacked)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _grid_against_run(specs):
    """(grid results, sequential results) of fresh sessions, checked
    bitwise cell by cell; returns the grid's dispatches."""
    alone = [TSession(s, device="cpu") for s in specs]
    plans_alone = [_record_plans(s.sim) for s in alone]
    seq = [s.run() for s in alone]
    folded = [TSession(s, device="cpu") for s in specs]
    plans_folded = [_record_plans(s.sim) for s in folded]
    grid = run_grid(folded)
    dispatches = list(TGRID.run_group.dispatches)
    assert len(grid) == len(specs)
    for r, s, sr, ss, pr, ps in zip(grid, seq, folded, alone, plans_folded,
                                    plans_alone):
        _assert_bitwise(r, s, sr, ss)
        assert _same_history(pr, ps)
    return grid, dispatches


def _check_grid_shape(grid_name, results, dispatches):
    segments = {}
    for d in dispatches:
        segments.setdefault(d.t0, []).append(d)
    assert sorted(segments) == [0, 3]
    if grid_name == "d-one-bucket":
        assert all(len(ds) == 1 for ds in segments.values())
    else:
        # the split-bucket path: two or more dispatches in a segment
        assert all(len(ds) >= 2 for ds in segments.values())
    if grid_name in ("b-seeds", "c-deadline"):
        assert any(len(d.members) > 1 for d in dispatches)
    # the cells differ from each other, or the grid ran one cell G times
    losses = [tuple(r.train_loss) for r in results]
    assert len(set(losses)) == len(losses)


@pytest.mark.parametrize("impl", [None, "kernel"], ids=["inline", "op"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_matches_sequential_bitwise(grid, impl):
    _register()
    results, dispatches = _grid_against_run(_specs(grid, update_impl=impl))
    _check_grid_shape(grid, results, dispatches)


def test_grid_matches_reference_run_grid():
    """Grid (a) through the reference's `run_grid` and the port's, from
    the reference's initial units."""
    _register()
    cells = GRIDS["a-policies"]
    refs = [RSession(RSpec(conv_impl="kernel", update_impl="kernel",
                           **_kw(c, RC.SFLConfig))) for c in cells]
    inits = [jax.tree_util.tree_map(np.asarray, r.sim.units) for r in refs]
    ref_plans = [_record_plans(r.sim) for r in refs]
    r_res = RSession.run_grid(refs)

    ports = [TSession(TSpec(**_kw(c, TC.SFLConfig)), device="cpu",
                      init_units=init) for c, init in zip(cells, inits)]
    port_plans = [_record_plans(p.sim) for p in ports]
    t_res = run_grid(ports)

    for r, t, rs, ts, rp, tp in zip(r_res, t_res, refs, ports, ref_plans,
                                    port_plans):
        assert _same_history(t.b_history, r.b_history)
        assert _same_history(t.cut_history, r.cut_history)
        assert t.clock == r.clock
        assert t.rounds == r.rounds
        assert _same_history(tp, rp)
        for name in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                       err_msg=name, **TOL)
        r_leaves = jax.tree_util.tree_leaves(rs.sim._stacked)
        t_leaves = tree_leaves(ts.sim._stacked)
        assert len(r_leaves) == len(t_leaves)
        for a, b in zip(t_leaves, r_leaves):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _api_specs(spec_cls, sfl_cls):
    """`tests/test_api.py`'s grouping specs, less the ones the port
    refuses (a non-scan engine, checkpointing)."""
    base = dict(arch="vgg9-cifar-small", n_clients=3, partition="iid",
                n_train=180, n_test=45, seed=0, policy="fixed",
                estimate=False, rounds=4, eval_every=2, reconfigure_every=2,
                sfl=sfl_cls(agg_interval=2, lr=0.05))
    cells = [dict(policy="fixed"), dict(policy="hasfl"),
             dict(policy="fixed", seed=1),
             dict(policy="fixed", partition="noniid-shards"),
             dict(policy="fixed", fault_mode="dropout"),
             dict(policy="hasfl", fault_mode="dropout", seed=2),
             dict(policy="fixed", update_impl="kernel")]
    return [spec_cls(**dict(base, **c)) for c in cells]


def test_group_cells_matches_reference():
    specs = _api_specs(TSpec, TC.SFLConfig)
    for s in specs:
        s.validated()
    groups = TGRID.group_cells(specs)
    assert groups == r_group_cells(_api_specs(RSpec, RC.SFLConfig))
    assert groups == [[0, 1, 2, 3], [4, 5], [6]]


def _small(**kw):
    _register()
    return TSpec(**_kw(dict(dict(policy="fixed(b=8,cut=3)", rounds=3),
                            **kw), TC.SFLConfig))


def test_auto_runner_refuses_built_sessions():
    sess = TSession(_small(), device="cpu")
    with pytest.raises(ValueError, match="auto"):
        run_grid([sess], runner="auto", device="cpu")
    with pytest.raises(ValueError, match="unknown runner"):
        run_grid([_small()], runner="fast", device="cpu")


@pytest.mark.parametrize("runner", ["sequential", "auto"])
def test_sequential_and_auto_runners_equal_run(runner, monkeypatch):
    """``"sequential"`` runs each cell alone; ``"auto"`` on one core picks
    sequential too (the reference's core-count rule), on two the grid —
    every way bitwise equal to `run()`."""
    specs = [_small(seed=s) for s in (0, 1)]
    alone = [TSession(s, device="cpu").run() for s in specs]
    for cores in ("1", "2"):
        monkeypatch.setenv("REPRO_CPU_CORES", cores)
        TGRID.run_group.dispatches.clear()
        got = run_grid(specs, runner=runner, device="cpu")
        folded = runner == "auto" and cores == "2"
        assert bool(TGRID.run_group.dispatches) == folded
        for r, s in zip(got, alone):
            assert r.clock == s.clock and r.train_loss == s.train_loss
            assert r.test_acc == s.test_acc


def test_a_session_runs_once_through_the_grid():
    sessions = [TSession(_small(seed=s), device="cpu") for s in (0, 1)]
    run_grid(sessions)
    with pytest.raises(RuntimeError, match="single-shot"):
        sessions[0].run()
    with pytest.raises(RuntimeError, match="single-shot"):
        run_grid(sessions)


def test_runner_table_core_rule_and_pins(monkeypatch):
    spec = _small()
    monkeypatch.setenv("REPRO_CPU_CORES", "1")
    assert TRUN.pick(spec, "cpu").runner == "sequential"
    monkeypatch.setenv("REPRO_CPU_CORES", "4")
    assert TRUN.pick(spec, "cpu").runner == "grid"
    assert TRUN.pick(spec, "cuda") == TRUN.ExecutionChoice(
        "grid", conv_impl="kernel", update_impl="kernel")
    with pytest.raises(ValueError, match="unknown runner"):
        TRUN.ExecutionChoice("vmap")
    saved = dict(TRUN._REGISTRY)
    try:
        TRUN.register_choice("cnn", "cpu", TRUN.ExecutionChoice(
            "sequential", update_impl="kernel"))
        assert TRUN.pick(spec, "cpu").runner == "sequential"
        assert TRUN.apply_choice(spec, "cpu").update_impl == "kernel"
    finally:
        TRUN._REGISTRY.clear()
        TRUN._REGISTRY.update(saved)


def test_fold_plan_offsets_each_cell_to_its_own_samples():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 10, (3, 2, 4, 5))        # [G, R, N, b_pad]
    mask = (rng.random((3, 4, 5)) > 0.3).astype(np.float32)
    plan, folded = DeviceClientStore.fold_plan(idx, mask, n_train=10)
    assert plan.shape == (2, 12, 5) and folded.shape == (12, 5)
    for g in range(3):
        np.testing.assert_array_equal(plan[:, 4 * g:4 * g + 4],
                                      idx[g] + 10 * g)
        np.testing.assert_array_equal(folded[4 * g:4 * g + 4], mask[g])
    shared, _ = DeviceClientStore.fold_plan(idx, mask)
    np.testing.assert_array_equal(shared[:, 4:8], idx[1])


def test_stack_arrays_lays_cells_end_to_end_and_checks_shapes():
    def store(seed, n=6):
        r = np.random.default_rng(seed)
        return DeviceClientStore(
            {"images": r.standard_normal((n, 2, 2, 3)).astype(np.float32),
             "labels": r.integers(0, 9, n)}, [np.arange(n)], r)

    a, b = store(0), store(1)
    stacked = DeviceClientStore.stack_arrays([a, b])
    assert torch.equal(stacked["images"][6:], b.arrays["images"])
    plan, mask = DeviceClientStore.fold_plan(
        np.array([[[[1, 5]]], [[[0, 2]]]]), np.ones((2, 1, 2), np.float32),
        n_train=6)
    batch = DeviceClientStore.device_batch(
        stacked, torch.as_tensor(plan[0]), torch.as_tensor(mask))
    assert torch.equal(batch["images"][1], b.arrays["images"][[0, 2]])
    with pytest.raises(ValueError, match="same-shaped"):
        DeviceClientStore.stack_arrays([a, store(2, n=7)])


@pytest.mark.parametrize("cell_size,calls", [(None, 1), (4, 1), (2, 2)])
def test_by_cell_runs_each_cell_on_its_own_rows(cell_size, calls):
    """`by_cell` calls the op once over the whole leading axis where no
    cell size splits it, else once per cell on that cell's rows of every
    argument, on the CPU as on the card."""
    x = torch.arange(24.0).reshape(4, 6)
    y = torch.arange(4.0)
    seen = []

    def op(a, b):
        seen.append(a.shape[0])
        return a.sum(dim=1) * b

    got = TCELLS.by_cell(op, cell_size, x, y)
    assert torch.equal(got, x.sum(dim=1) * y)
    assert seen == [4 // calls] * calls
