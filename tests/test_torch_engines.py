"""The port's per-round engines (``legacy``, ``vectorized``) against the
reference's engines of the same names, through `Session`, on the CPU.

Each spec runs through `repro.api.Session` and through
`repro_torch.api.Session(device="cpu")` started from the reference's
initial units, on the same engine.  The host plane is the same numpy code
on the same seeded streams, so decisions, clocks and every draw of the
sampler are bitwise equal; losses, accuracies and every client's final
parameters agree within 1e-4 (fp32, other summation order).  The cases
are `tests/test_torch_session.py`'s (mixed cuts, the BCD controller,
deadline faults down to no survivor, random batches past the pools), a
smollm-tiny cell, and a `run_grid` that mixes a scan, a vectorized and a
legacy cell.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.data.pipeline as RPIPE
import repro_torch.config as TC
import repro_torch.data.pipeline as TPIPE
from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.api import run_grid as r_run_grid
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.api import run_grid as t_run_grid
from repro_torch.utils.tree import tree_leaves
from test_torch_session import CASES, TOL, _register, _spec_kw

ENGINES = ("legacy", "vectorized")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def draws(monkeypatch):
    """Every index draw of each package's host sampling routine
    (`draw_indices`, which `ClientSampler.sample` and
    `DeviceClientStore.segment_indices` both call), in order."""
    seen = {"ref": [], "port": []}
    for key, mod in (("ref", RPIPE), ("port", TPIPE)):
        def recording(rng, pool, batch, draw=mod.draw_indices,
                      out=seen[key]):
            take = draw(rng, pool, batch)
            out.append(np.array(take))
            return take
        monkeypatch.setattr(mod, "draw_indices", recording)
    return seen


def assert_same_draws(draws):
    assert len(draws["port"]) == len(draws["ref"]) > 0
    for x, y in zip(draws["port"], draws["ref"]):
        np.testing.assert_array_equal(x, y)


def assert_same_decisions(t, r):
    for name in ("b_history", "cut_history"):
        a, b = getattr(t, name), getattr(r, name)
        assert len(a) == len(b) and all(
            np.array_equal(x, y) for x, y in zip(a, b)), name
    assert t.clock == r.clock
    assert t.rounds == r.rounds


def client_leaves(sim, ref: bool) -> list:
    """Every client's parameter leaves, client after client, as numpy."""
    if ref:
        return [np.asarray(x) for u in sim.client_units
                for x in jax.tree_util.tree_leaves(list(u))]
    return [x.float().numpy() for u in sim.client_units
            for x in tree_leaves(list(u))]


def assert_matches(t, r, tsim, rsim, tol=TOL):
    assert_same_decisions(t, r)
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   err_msg=name, **tol)
    a, b = client_leaves(tsim, False), client_leaves(rsim, True)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y.astype(np.float32), **tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_session_matches_reference(engine, case, draws):
    _register()
    ref = RSession(RSpec(engine=engine, conv_impl="kernel",
                         update_impl="kernel",
                         **_spec_kw(case, RC.SFLConfig)))
    init = jax.tree_util.tree_map(np.asarray, ref.sim.units)
    r = ref.run()
    port = TSession(TSpec(engine=engine, **_spec_kw(case, TC.SFLConfig)),
                    device="cpu", init_units=init)
    assert port.engine == ref.engine == engine
    assert not hasattr(port.sim, "store")
    t = port.run()
    assert_same_draws(draws)
    assert_matches(t, r, port.sim, ref.sim)
    if case.startswith("deadline"):
        part = port.sim._fault_round(r.b_history[0], r.cut_history[0])[0]
        assert part.sum() == (1 if case == "deadline-lone" else 0)
    if case == "rbs-rms":
        assert max(int(np.max(b)) for b in t.b_history) > 50


def _smollm():
    name = "smollm-tiny-engines"
    for C in (RC, TC):
        C.register(dataclasses.replace(C.get_config("smollm-tiny"),
                                       arch_id=name, dtype="float32"))
    return name


@pytest.mark.parametrize("engine", ENGINES)
def test_token_session_matches_reference(engine, draws):
    """A 4-round fp32 smollm-tiny cell (N=4, I=2, HASFL priors, a
    reconfiguration): the legacy engine runs each client's ``loss``, the
    vectorized one the client-stacked ``stacked_loss``."""
    kw = dict(arch=_smollm(), n_clients=4, partition="iid", n_train=128,
              n_test=16, seq_len=16, policy="hasfl", estimate=False,
              rounds=4, eval_every=2, engine=engine)
    ref = RSession(RSpec(**kw, sfl=RC.SFLConfig(agg_interval=2, lr=0.05)))
    init = jax.tree_util.tree_map(np.asarray, ref.sim.units)
    r = ref.run()
    port = TSession(TSpec(**kw, sfl=TC.SFLConfig(agg_interval=2, lr=0.05)),
                    device="cpu", init_units=init)
    t = port.run()
    assert_same_draws(draws)
    assert_matches(t, r, port.sim, ref.sim)


def test_run_grid_runs_each_engine_as_its_own_run():
    """`run_grid` over a scan, a vectorized and a legacy cell: no two
    share a grid key (``grid_key()`` is None off the scan engine), so each
    runs alone.  Each cell is bitwise its own `Session.run()` and matches
    the reference's `run_grid` of the same cells."""
    _register()
    engines = ("scan", "vectorized", "legacy")
    kw = _spec_kw("hasfl", TC.SFLConfig)
    specs = [TSpec(engine=e, **kw) for e in engines]
    assert [s.grid_key() is None for s in specs] == [False, True, True]
    refs = [RSession(RSpec(engine=e, conv_impl="kernel",
                           update_impl="kernel",
                           **_spec_kw("hasfl", RC.SFLConfig)))
            for e in engines]
    inits = [jax.tree_util.tree_map(np.asarray, s.sim.units) for s in refs]
    r_res = r_run_grid(refs)
    sessions = [TSession(s, device="cpu", init_units=i)
                for s, i in zip(specs, inits)]
    t_res = t_run_grid(sessions)
    for spec, init, sess, t, rsess, r in zip(specs, inits, sessions, t_res,
                                             refs, r_res):
        alone = TSession(spec, device="cpu", init_units=init)
        a = alone.run()
        assert_same_decisions(t, a)
        for name in ("train_loss", "test_loss", "test_acc"):
            assert getattr(t, name) == getattr(a, name), name
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves([list(u) for u in sess.sim.client_units]),
            tree_leaves([list(u) for u in alone.sim.client_units])))
        assert_matches(t, r, sess.sim, rsess.sim)
