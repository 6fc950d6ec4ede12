"""Token cells under the port's dynamic edge against the reference's, on
the CPU: scenario presets, crash-safe snapshots with `Session.resume`,
and the streaming traffic plane.

- A smollm-tiny cell (fp32) under ``churn-heavy`` with dropout faults,
  from the reference's initial units: decisions, clocks, gather and
  participation plans bitwise; losses and parameters within 1e-4.
- The reference's own resume spec (`tests/test_resume.py`: smollm-tiny at
  its registered bf16, HASFL with the online G²/σ² estimate,
  ``churn-heavy``, deadline faults): checkpointed every 2 rounds and
  resumed from round 2, bitwise the uninterrupted run (results, every
  parameter, the participation plans), and the uninterrupted run against
  the reference's: decisions, clocks and plans bitwise, losses within
  1e-3, parameters within one bf16 ulp.
- A smollm-tiny traffic cell on the reference's churny plane
  (`tests/test_traffic.py`, fp32): the event log and clocks bitwise,
  losses and parameters within 1e-4; it churns.
- Every token family that trains, reduced: a scenario cell checkpointed
  and resumed bitwise, and a traffic cell resumed bitwise.
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
from repro.api import TrafficSpec as RTraffic
from repro_torch.api import ExperimentSpec as TSpec
from repro_torch.api import Session as TSession
from repro_torch.api import TrafficSpec as TTraffic
from repro_torch.utils.tree import tree_leaves

BF16_ULP = 2.0 ** -7
CHURNY = dict(n_users=500, arrival_rate=300.0, mean_dwell=0.02,
              buffer_frac=0.5, staleness_alpha=0.5, shard_size=40, seed=3)
FAMILIES = ["qwen3-1.7b", "glm4-9b", "phi3-mini-3.8b", "dbrx-132b",
            "llama4-maverick-400b-a17b", "jamba-v0.1-52b", "internvl2-1b",
            "xlstm-350m"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _register(arch, dtype):
    name = f"{arch}-tdyn-{dtype}"
    for C in (RC, TC):
        cfg = C.get_config(arch)
        if arch != "smollm-tiny":
            cfg = C.reduced(cfg)
        C.register(dataclasses.replace(cfg, arch_id=name, dtype=dtype))
    return name


def _record(sim):
    """Every gather plan and participation plan ``sim`` draws."""
    plans, parts = [], []
    draw, participate = sim.store.segment_indices, \
        sim._segment_participation

    def drawing(*a):
        plans.append(draw(*a))
        return plans[-1]

    def participating(*a):
        parts.append(participate(*a))
        return parts[-1]

    sim.store.segment_indices = drawing
    sim._segment_participation = participating
    return plans, parts


def _same_arrays(a, b):
    return len(a) == len(b) and all(
        (x is None and y is None) or np.array_equal(x, y)
        for x, y in zip(a, b))


def _assert_against_reference(r, t, rs, ts, dtype):
    assert _same_arrays(r.b_history, t.b_history)
    assert _same_arrays(r.cut_history, t.cut_history)
    assert t.clock == r.clock and t.rounds == r.rounds
    tol = 1e-4 if dtype == "float32" else 1e-3
    for f in ("train_loss", "test_loss"):
        np.testing.assert_allclose(getattr(t, f), getattr(r, f), rtol=tol,
                                   atol=tol, err_msg=f)
    r_leaves = jax.tree_util.tree_leaves(rs.sim._stacked)
    t_leaves = tree_leaves(ts.sim._stacked)
    assert len(r_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, r_leaves):
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        # a bf16 leaf within one ulp; an fp32 leaf (the norm scales beside
        # a bf16 model's weights too) at the fp32 bar
        if bf16:
            np.testing.assert_allclose(a, b, rtol=BF16_ULP, atol=1e-3)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _same_fp32_updates(init, rs, ts):
    """Each fp32 leaf's update (final minus initial units) within 5 % of
    the reference's largest entry of it: where the norm scales beside bf16
    weights move by less than the parameter bar, a frozen or wrong update
    still fails here."""
    checked = 0
    for a, b, c in zip(tree_leaves(ts.sim._stacked),
                       jax.tree_util.tree_leaves(rs.sim._stacked),
                       jax.tree_util.tree_leaves(init)):
        if a.dtype != torch.float32:
            continue
        c = np.asarray(c, np.float32)
        dt, dr = a.numpy() - c, np.asarray(b, np.float32) - c
        assert np.abs(dt - dr).max() <= 0.05 * np.abs(dr).max()
        checked += 1
    assert checked > 0


def _assert_bitwise(a, b, sa, sb):
    assert a.rounds == b.rounds and a.clock == b.clock
    assert a.train_loss == b.train_loss and a.test_loss == b.test_loss
    assert a.test_acc == b.test_acc
    assert _same_arrays(a.b_history, b.b_history)
    assert _same_arrays(a.cut_history, b.cut_history)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(sa.sim._stacked), tree_leaves(sb.sim._stacked)))


def _both(kw_r, kw_t, dtype):
    """The reference run and the port's from its initial units, each with
    its recorded plans: ((session, result, plans), ..., initial units)."""
    rs = RSession(RSpec(**kw_r))
    init = jax.tree_util.tree_map(np.asarray, rs.sim.units)
    r_rec = _record(rs.sim)
    r = rs.run()
    ts = TSession(TSpec(**kw_t), device="cpu", init_units=init)
    t_rec = _record(ts.sim)
    t = ts.run()
    _assert_against_reference(r, t, rs, ts, dtype)
    return (rs, r, r_rec), (ts, t, t_rec), init


def test_token_scenario_session_matches_reference():
    name = _register("smollm-tiny", "float32")

    def kw(C):
        return dict(arch=name, n_clients=4, partition="iid", n_train=128,
                    n_test=16, seq_len=16, seed=1, policy="hasfl",
                    estimate=False, scenario="churn-heavy", scenario_seed=7,
                    fault_mode="dropout", rounds=4, eval_every=2,
                    sfl=C.SFLConfig(lr=0.05, agg_interval=2))

    (_, _, (rp, rq)), (_, _, (tp, tq)), _ = _both(kw(RC), kw(TC),
                                                  "float32")
    assert _same_arrays(tp, rp) and _same_arrays(tq, rq)
    assert any((q < 1).any() for q in tq)        # churn dropped a client


def _resume_spec(C, **over):
    """`tests/test_resume.py`'s maximal-state spec, for either package."""
    kw = dict(arch="smollm-tiny", n_clients=4, partition="iid",
              n_train=160, n_test=40, seq_len=32, seed=0, policy="hasfl",
              estimate=True, scenario="churn-heavy", scenario_seed=7,
              rounds=4, eval_every=2, fault_mode="deadline",
              deadline_factor=2.0, sfl=C.SFLConfig(lr=0.05, agg_interval=2))
    kw.update(over)
    return kw


def test_reference_resume_spec_resumes_bitwise_and_matches(tmp_path):
    (rs, _, (rp, rq)), (ts, t, (tp, tq)), init = _both(
        _resume_spec(RC), _resume_spec(TC), "bfloat16")
    assert _same_arrays(tp, rp) and _same_arrays(tq, rq)
    _same_fp32_updates(init, rs, ts)
    ck = TSpec(**_resume_spec(TC, checkpoint_every=2,
                              checkpoint_dir=str(tmp_path)))
    checkpointed = TSession(ck, device="cpu", init_units=init)
    _assert_bitwise(checkpointed.run(), t, checkpointed, ts)
    resumed = TSession.resume(ck, step=2, device="cpu")
    _, parts = _record(resumed.sim)
    _assert_bitwise(resumed.run(), t, resumed, ts)
    assert _same_arrays(parts, tq[-len(parts):])


def test_token_traffic_cell_matches_reference():
    name = _register("smollm-tiny", "float32")

    def kw(C, T):
        return dict(arch=name, n_clients=3, partition="iid", n_train=180,
                    n_test=30, seq_len=16, rounds=6, eval_every=3,
                    reconfigure_every=3, policy="fixed",
                    sfl=C.SFLConfig(agg_interval=3, lr=0.05),
                    traffic=T(**CHURNY))

    (rs, _, _), (ts, _, _), _ = _both(kw(RC, RTraffic), kw(TC, TTraffic),
                                      "float32")
    a, b = ts.plane.log, rs.plane.log
    assert (a.time, a.round, a.kind, a.slot, a.user) == \
        (b.time, b.round, b.kind, b.slot, b.user)
    counts = a.counts()
    assert counts["admit"] > 3 and counts["evict"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_resumes_bitwise(arch, tmp_path):
    """Each other token family that trains, reduced, at its registered
    type: a ``straggler-bursts`` cell with deadline faults and a traffic
    cell, each checkpointed every round and resumed from round 1, bitwise
    the uninterrupted run."""
    name = _register(arch, TC.get_config(arch).dtype)
    base = dict(arch=name, n_clients=4, partition="iid", n_train=120,
                n_test=8, seq_len=8, policy="hasfl", estimate=False,
                rounds=2, eval_every=1, sfl=TC.SFLConfig(lr=0.05,
                                                         agg_interval=1))
    cells = {"scenario": dict(scenario="straggler-bursts", scenario_seed=3,
                              fault_mode="deadline", deadline_factor=1.5),
             "traffic": dict(policy="fixed", traffic=TTraffic(**CHURNY))}
    for kind, cell in cells.items():
        spec = TSpec(**dict(base, **cell))
        whole = TSession(spec, device="cpu")
        r = whole.run()
        assert all(np.isfinite(r.train_loss + r.test_loss))
        ck = spec.replace(checkpoint_every=1,
                          checkpoint_dir=str(tmp_path / kind))
        resumed = TSession.resume(_run_checkpointed(ck), step=1,
                                  device="cpu")
        _assert_bitwise(resumed.run(), r, resumed, whole)


def _run_checkpointed(spec):
    TSession(spec, device="cpu").run()
    return spec
