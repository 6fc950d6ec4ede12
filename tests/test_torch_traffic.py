"""The port's streaming traffic plane (DESIGN.md §14) against the
reference's, on the CPU.

- `TrafficSpec` validation and its JSON round trip through the port's
  `ExperimentSpec` (a reference spec file loads unchanged); the spec's
  traffic rows refuse what the reference's refuse, with its messages.
- The numpy planes bitwise against the reference: `staleness_weight`,
  the `Population` arrival stream and per-user derivations, the
  `EventQueue` tie-breaks, and `EventLog` files (each side reads the
  other's).
- The slot store on torch tensors: `write_slot` in place on the slot row,
  `live_mean` over the live slots (all slots when none or all are live).
- alpha = 0 gives the synchronous survivor mean bitwise, through the
  inline update and through the fused op's plain version.
- The reference's churny cell (`tests/test_traffic.py`) through both
  packages from the reference's initial units: event log and clocks
  bitwise, losses, accuracies and parameters within 1e-4; the cell
  churns (admits past the cohort, evictions, a fractional staleness
  weight).
- Checkpointed traffic runs and `Session.resume` bitwise, the event log
  replayed exactly, and the plane's state round trip lossless.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as RSpec
from repro.api import Session as RSession
from repro.api import TrafficSpec as RTraffic
from repro.config import SFLConfig as RSFL
from repro.traffic import EventLog as REventLog
from repro.traffic import EventQueue as REventQueue
from repro.traffic import Population as RPopulation
from repro.traffic import live_mean as r_live_mean
from repro.traffic import staleness_weight as r_staleness_weight
from repro_torch.api import ExperimentSpec, Session, TrafficSpec
from repro_torch.config import SFLConfig
from repro_torch.core import split as SP
from repro_torch.traffic import (
    EventLog,
    EventQueue,
    Population,
    SlotClientStore,
    dummy_pool,
    live_mean,
    staleness_weight,
    write_slot,
)
from repro_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
GAMMA = 0.1
CHURNY = dict(n_users=500, arrival_rate=300.0, mean_dwell=0.02,
              buffer_frac=0.5, staleness_alpha=0.5, shard_size=40, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _kw(pkg, **kw):
    """The reference's churny cell (`tests/test_traffic.py`) for the
    reference (``pkg="r"``) or the port."""
    t = dict(CHURNY)
    t.update(kw.pop("tspec", {}))
    base = dict(
        arch="vgg9-cifar-small", n_clients=3, partition="iid",
        n_train=180, n_test=60, rounds=6, eval_every=3,
        reconfigure_every=3, policy="fixed",
        sfl=(RSFL if pkg == "r" else SFLConfig)(agg_interval=3, lr=0.05),
        traffic=(RTraffic if pkg == "r" else TrafficSpec)(**t),
    )
    if pkg == "r":
        base.update(conv_impl="kernel", update_impl="kernel")
    base.update(kw)
    return base


def _spec(**kw):
    return ExperimentSpec(**_kw("t", **kw))


@pytest.fixture(scope="module")
def churny():
    """(reference session, its result, port session, its result) of the
    churny cell, the port started from the reference's initial units."""
    ref = RSession(RSpec(**_kw("r")))
    init = jax.tree_util.tree_map(np.asarray, ref.sim.units)
    r = ref.run()
    port = Session(_spec(), device="cpu", init_units=init)
    t = port.run()
    return ref, r, port, t


def _same_log(a, b):
    assert a.time == b.time
    assert a.round == b.round
    assert a.kind == b.kind
    assert a.slot == b.slot
    assert a.user == b.user


def _assert_result_bitwise(a, b):
    assert a.rounds == b.rounds
    assert a.clock == b.clock
    assert a.train_loss == b.train_loss
    assert a.test_loss == b.test_loss
    assert a.test_acc == b.test_acc


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

def test_traffic_spec_validation():
    with pytest.raises(ValueError):
        TrafficSpec(arrival_rate=0.0).validated()      # deadlock guard
    with pytest.raises(ValueError):
        TrafficSpec(buffer_frac=0.0).validated()
    with pytest.raises(ValueError):
        TrafficSpec(buffer_frac=1.5).validated()
    with pytest.raises(ValueError):
        TrafficSpec(staleness_alpha=-0.1).validated()
    with pytest.raises(ValueError):
        TrafficSpec(shard_size=0).validated()
    with pytest.raises(ValueError):
        TrafficSpec(mean_dwell=0.0).validated()
    with pytest.raises(ValueError):
        TrafficSpec(n_users=0).validated()
    TrafficSpec().validated()


def test_spec_traffic_json_round_trips_from_reference():
    text = RSpec(**_kw("r")).to_json()
    spec = ExperimentSpec.from_json(text)
    assert isinstance(spec.traffic, TrafficSpec)
    assert spec.to_json() == text
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert spec.grid_key() is None                     # refuse-to-stack
    assert spec.replace(traffic=None).grid_key() is not None
    ck = _spec(checkpoint_every=3, checkpoint_dir="unused")
    assert ck.validated().grid_key() is None


BAD = {
    "engine": dict(engine="vectorized"),
    "faults": dict(fault_mode="dropout"),
    "cohort": dict(n_clients=65),
    "rate": dict(tspec=dict(arrival_rate=0.0)),
    "not-a-spec": dict(traffic="on"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_spec_traffic_validation_mirrors_reference(case):
    errors = []
    for pkg, cls in (("r", RSpec), ("t", ExperimentSpec)):
        kw = _kw(pkg, **BAD[case])
        with pytest.raises(ValueError) as err:
            cls(**kw).validated()
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# numpy planes, bitwise
# ---------------------------------------------------------------------------

def test_staleness_weight_matches_reference():
    for alpha in (0.0, 0.3, 0.5, 1.0, 2.5):
        for tau in range(-2, 12):
            assert staleness_weight(tau, alpha) == \
                r_staleness_weight(tau, alpha)
    assert staleness_weight(1, 1.0) == 0.5


def test_population_streams_match_reference():
    kw = dict(n_users=1_000_000, arrival_rate=0.5, mean_dwell=10.0,
              shard_size=30, seed=5)
    ours = Population(TrafficSpec(**kw), n_train=500)
    theirs = RPopulation(RTraffic(**kw), n_train=500)
    assert ours.initial_cohort(8) == theirs.initial_cohort(8)
    assert [ours.next_arrival() for _ in range(50)] == \
        [theirs.next_arrival() for _ in range(50)]
    assert ours.peek_arrival() == theirs.peek_arrival()
    for uid in (0, 42, 999_999):
        assert ours.user_profile(uid).__dict__ == \
            theirs.user_profile(uid).__dict__
        np.testing.assert_array_equal(ours.user_shard(uid),
                                      theirs.user_shard(uid))


def test_event_queue_breaks_ties_as_reference():
    ours, theirs = EventQueue(), REventQueue()
    for q in (ours, theirs):
        for i, t in enumerate((2.0, 1.0, 2.0, 1.0, 0.5)):
            q.push(t, "depart", (i, 10 * i))
    assert [ours.pop() for _ in range(5)] == [theirs.pop() for _ in range(5)]
    assert ours.peek_time() == float("inf")


def test_event_log_files_cross_load(tmp_path):
    log = EventLog()
    log.append(0.5, 1, "admit", slot=2, user=77)
    log.append(1.5, 1, "deliver", slot=2, user=77)
    log.append(2.0, 2, "round")
    log.save(str(tmp_path / "port"))
    _same_log(REventLog.load(str(tmp_path / "port")), log)
    back = EventLog.load(str(tmp_path / "port"))
    _same_log(back, log)
    assert back.counts()["deliver"] == 1
    with pytest.raises(ValueError):
        log.append(3.0, 2, "teleport")
    ref = REventLog()
    ref.append(0.25, 3, "evict", slot=1, user=5)
    ref.save(str(tmp_path / "ref"))
    _same_log(EventLog.load(str(tmp_path / "ref")), ref)
    # no marker -> unreadable (the crash-safety contract)
    (tmp_path / "port.json").unlink()
    with pytest.raises(FileNotFoundError):
        EventLog.load(str(tmp_path / "port"))


# ---------------------------------------------------------------------------
# slot store on torch tensors
# ---------------------------------------------------------------------------

def _stacked(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": torch.tensor(rng.normal(size=(n, 3, 2)), dtype=torch.float32),
             "b": torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float32)}
            for _ in range(2)]


@pytest.mark.parametrize("live", [[1, 0, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0],
                                  [0, 0, 0, 1]])
def test_live_mean_matches_reference(live):
    live = np.asarray(live, bool)
    stacked = _stacked()
    ref = r_live_mean([{k: np.asarray(v.numpy()) for k, v in u.items()}
                       for u in stacked], live)
    ours = live_mean(stacked, live)
    for u, ru in zip(ours, ref):
        for k in u:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ru[k]),
                                       rtol=1e-6, atol=1e-7)
    if live.any() and not live.all():
        want = stacked[0]["w"][torch.as_tensor(np.flatnonzero(live))].mean(0)
        assert torch.equal(ours[0]["w"], want)


def test_write_slot_writes_the_row_in_place():
    stacked = _stacked()
    ptrs = [t.data_ptr() for t in tree_leaves(stacked)]
    before = [t.clone() for t in tree_leaves(stacked)]
    values = live_mean(stacked, np.asarray([1, 0, 0, 1], bool))
    out = write_slot(stacked, 2, values)
    assert out is stacked
    assert [t.data_ptr() for t in tree_leaves(stacked)] == ptrs
    for t, old, v in zip(tree_leaves(stacked), before, tree_leaves(values)):
        assert torch.equal(t[2], v)
        keep = [0, 1, 3]
        assert torch.equal(t[keep], old[keep])


def test_slot_store_binds_dummy_pools_and_refuses_empty():
    arrays = {"images": np.zeros((10, 2, 2, 3), np.float32),
              "labels": np.zeros(10, np.int32)}
    store = SlotClientStore(arrays, 4, np.random.default_rng(0))
    assert store.n_clients == 4
    assert all(np.array_equal(p, dummy_pool()) for p in store.client_indices)
    store.set_pool(1, np.arange(3))
    np.testing.assert_array_equal(store.client_indices[1], np.arange(3))
    with pytest.raises(ValueError):
        store.set_pool(0, np.asarray([], np.int64))
    assert len(dummy_pool()) == 1
    # adopting a slot-dummy sampler shares its RNG object (the host stream
    # stays authoritative) and its pools
    from repro_torch.data import ClientSampler

    rng = np.random.default_rng(1)
    sampler = ClientSampler(arrays, [dummy_pool() for _ in range(4)], rng)
    adopted = SlotClientStore.from_sampler(sampler)
    assert isinstance(adopted, SlotClientStore) and adopted.rng is rng
    assert adopted.n_clients == 4
    assert tuple(adopted.arrays["images"].shape) == (10, 2, 2, 3)


# ---------------------------------------------------------------------------
# staleness algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", [None, "kernel"], ids=["inline", "op"])
def test_alpha_zero_is_synchronous_mean_bitwise(impl):
    """alpha=0 makes every delivery weight exactly 1.0, so the weight
    vector is the full-participation ones vector and the update — the
    same op sequence — is the synchronous survivor mean bit for bit."""
    rng = np.random.default_rng(0)
    stacked = [{"w": torch.tensor(rng.normal(size=(4, 6)),
                                  dtype=torch.float32)} for _ in range(2)]
    grads = [{"w": torch.tensor(rng.normal(size=(4, 6)),
                                dtype=torch.float32)} for _ in range(2)]
    masks = np.asarray([1.0, 0.0], np.float32)
    w = torch.tensor([staleness_weight(t, 0.0) for t in range(4)],
                     dtype=torch.float32)
    assert torch.equal(w, torch.ones(4))
    for do_agg in (False, True):
        a = SP.hasfl_round_update(stacked, grads, masks, do_agg, GAMMA,
                                  impl=impl, participation=w)
        b = SP.hasfl_round_update(stacked, grads, masks, do_agg, GAMMA,
                                  impl=impl, participation=torch.ones(4))
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the churny cell against the reference
# ---------------------------------------------------------------------------

def test_churny_cell_matches_reference(churny):
    ref, r, port, t = churny
    _same_log(port.plane.log, ref.plane.log)
    assert t.clock == r.clock
    assert t.rounds == r.rounds
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   err_msg=name, **TOL)
    r_leaves = jax.tree_util.tree_leaves(ref.sim._stacked)
    t_leaves = tree_leaves(port.sim._stacked)
    assert len(r_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, r_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(port.plane.live, ref.plane.live)
    for a, b in zip(port.sim.store.client_indices,
                    ref.sim.store.client_indices):
        np.testing.assert_array_equal(a, b)


def test_churny_cell_churns(churny):
    _, _, port, t = churny
    counts = port.plane.log.counts()
    assert counts["admit"] > port.spec.n_clients       # churned in
    assert counts["evict"] > 0                         # churned out
    assert counts["round"] == 6
    assert len(t.clock) == 2 and 0 < t.clock[0] < t.clock[1]
    assert np.all(np.isfinite(t.train_loss))
    assert int(port.plane.live_mask().sum()) <= port.spec.n_clients
    # capacity is the pow2 bucket of the cohort
    assert port.sim.n == 4 and port.plane.capacity == 4


def test_fractional_staleness_weights_reach_the_update():
    """A cell whose rounds close on stale deliveries: the participation
    plans handed to the segments carry weights strictly between 0 and 1,
    and the run stays finite."""
    sess = Session(_spec(tspec=dict(arrival_rate=2.0, mean_dwell=5.0,
                                    buffer_frac=0.25)), device="cpu")
    plans = []
    plan = sess.plane.plan_segment

    def recording(*a):
        plans.append(plan(*a))
        return plans[-1]

    sess.plane.plan_segment = recording
    res = sess.run()
    w = np.concatenate([p.ravel() for p in plans])
    assert ((w > 0) & (w < 1)).any()
    assert np.all(np.isfinite(res.train_loss))


# ---------------------------------------------------------------------------
# checkpoint/resume: the plane's host state rides the Session snapshot
# ---------------------------------------------------------------------------

def test_traffic_checkpointed_run_and_resume_are_bitwise(tmp_path, churny):
    _, _, port, ref = churny
    init = jax.tree_util.tree_map(np.asarray, port.sim.units)
    d = str(tmp_path / "snaps")
    spec_ck = _spec(checkpoint_every=3, checkpoint_dir=d)
    first = Session(spec_ck, device="cpu", init_units=init)
    _assert_result_bitwise(first.run(), ref)
    _same_log(first.plane.log, port.plane.log)

    resumed = Session.resume(spec_ck, step=3, device="cpu")
    assert resumed.plane.clock > 0               # restored, not fresh
    res = resumed.run()
    _assert_result_bitwise(res, ref)
    _same_log(resumed.plane.log, port.plane.log)
    for a, b in zip(tree_leaves(resumed.sim._stacked),
                    tree_leaves(port.sim._stacked)):
        assert torch.equal(a, b)


def test_plane_state_roundtrip_is_lossless():
    sess = Session(_spec(rounds=3, eval_every=3), device="cpu")
    sess.run()
    plane, sim = sess.plane, sess.sim
    arrays, meta = plane.state(sim.store)

    sess2 = Session(_spec(rounds=3, eval_every=3), device="cpu")
    plane2 = sess2.plane
    plane2.restore(sess2.sim, arrays, meta)
    assert plane2.clock == plane.clock
    assert plane2.queue._n == plane.queue._n
    assert sorted(plane2.queue._heap) == sorted(plane.queue._heap)
    np.testing.assert_array_equal(plane2.live, plane.live)
    np.testing.assert_array_equal(plane2.user, plane.user)
    np.testing.assert_array_equal(plane2.t_done, plane.t_done)
    assert plane2.pop.rng.bit_generator.state == \
        plane.pop.rng.bit_generator.state
    assert plane2.pop._t_next == plane.pop._t_next
    _same_log(plane2.log, plane.log)
    for a, b in zip(sess2.sim.store.client_indices,
                    sim.store.client_indices):
        np.testing.assert_array_equal(a, b)
    assert [p is None for p in plane2.base_profile] == \
        [p is None for p in plane.base_profile]


def test_traffic_run_is_deterministic():
    spec = _spec(rounds=3, eval_every=3)
    r1 = Session(spec, device="cpu").run()
    r2 = Session(spec, device="cpu").run()
    _assert_result_bitwise(r1, r2)
