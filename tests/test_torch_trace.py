"""The port's spans and counters (`repro_torch.trace`), on the CPU.

- With no profiler running a span is one shared null context: no record
  function is ever entered.
- Under a CPU `torch.profiler` profile a `Session` run records the spans
  at each layer boundary, in order and properly nested, one ``round`` a
  round carrying its ``t``; none reuses the benchmark's own range names,
  and none is a user annotation (so the profiler makes no device-side
  copy of it).
- Decisions, clocks and losses are bitwise the same with the profiler on
  and off.
- The row counters count R · N · b_pad computed and R · Σ b useful rows,
  alike across the scan, vectorized and legacy engines where their rows
  are the same.
- `SpanTrace` gives a device operation to the innermost span open at its
  launch, by a synthetic profile worked out by hand.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.config as TC
from repro_torch import trace as T
from repro_torch.api import ExperimentSpec, Session
from repro_torch.config import SFLConfig
from repro_torch.utils.tree import tree_leaves

ARCH = "vgg9-torch-trace"
ROUNDS = 6
ROUND_PHASES = ("round.gather", "round.forward", "round.backward",
                "round.clip", "round.update")
SEGMENT = ("segment.plan", "segment.upload", "segment.clock", "round",
           *ROUND_PHASES, "eval.aggregate", "eval.forward", "eval.fetch")
POLICY = ("policy.estimate", "policy.estimate.grad",
          "policy.estimate.to_host", "policy.estimate.stats", "policy.solve",
          "policy.solve.bs", "policy.solve.ms")
PARENT = {**{p: "round" for p in ROUND_PHASES},
          "policy.estimate.grad": "policy.estimate",
          "policy.estimate.to_host": "policy.estimate",
          "policy.estimate.stats": "policy.estimate",
          "policy.solve.bs": "policy.solve",
          "policy.solve.ms": "policy.solve"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    T.reset_counts()
    yield
    torch.set_num_threads(prev)


def _spec(policy, **kw):
    base = TC.get_config("vgg9-cifar-small")
    TC.register(dataclasses.replace(base, arch_id=ARCH, conv_channels=(4, 8),
                                    fc_dims=(8,), image_size=8))
    return ExperimentSpec(arch=ARCH, n_clients=3, partition="iid",
                          n_train=90, n_test=10, rounds=ROUNDS, eval_every=3,
                          policy=policy,
                          sfl=SFLConfig(lr=0.05, agg_interval=3), **kw)


def _profiled_run(spec):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        res = Session(spec, device="cpu").run()
    return res, p


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record function was entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert T.span("round", 3) is T.span("policy.solve") is T._NULL
    res = Session(_spec("hasfl"), device="cpu").run()
    assert len(res.train_loss) == 2
    assert T.profiled() == {"counters": {}, "spans": {}}


@pytest.mark.parametrize("policy,names", [
    ("fixed(b=8,cut=2)", SEGMENT),
    ("hasfl", SEGMENT + POLICY),
])
def test_spans_nest_in_order(policy, names):
    _, prof = _profiled_run(_spec(policy))
    st = T.SpanTrace(prof)
    seen = {name for _, _, name in st.spans}
    assert seen == set(names)
    assert seen <= set(T.SPANS)
    assert not seen & {"policy", "segment", "eval"}
    for i, (s, e, name) in enumerate(st.spans):
        p = st.parent[i]
        assert (st.spans[p][2] if p >= 0 else None) == PARENT.get(name)
        if p >= 0:
            assert st.spans[p][0] <= s <= e <= st.spans[p][1]
    for i, (s, e, name) in enumerate(st.spans):
        if name == "round":
            kids = [n for j, (_, _, n) in enumerate(st.spans)
                    if st.parent[j] == i]
            assert kids == list(ROUND_PHASES)
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name() in T.SPANS]
    assert {ev.activity_type() for ev in events} == {"cpu_op"}
    rounds = [ev.kwinputs()["id"] for ev in events if ev.name() == "round"]
    assert sorted(rounds) == list(range(1, ROUNDS + 1))
    if policy == "hasfl":
        for name in ("policy.estimate", "policy.solve"):
            assert sorted(ev.kwinputs()["id"] for ev in events
                          if ev.name() == name) == [0, 1]
    table = st.table()
    tally = T.profiled()
    assert tally["counters"] == T.counts()
    assert {n: s["calls"] for n, s in tally["spans"].items()} == \
        {n: row["calls"] for n, row in table.items()}


def test_profiler_changes_no_result():
    spec = _spec("hasfl")
    off = Session(spec, device="cpu").run()
    on, _ = _profiled_run(spec)
    for a, b in ((off.b_history, on.b_history),
                 (off.cut_history, on.cut_history)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert off.clock == on.clock
    assert off.train_loss == on.train_loss
    assert off.test_loss == on.test_loss
    assert off.test_acc == on.test_acc


@pytest.mark.parametrize("engine,b,fault,rows", [
    ("scan", 6, "soft", (ROUNDS * 3 * 8, ROUNDS * 3 * 6)),
    ("vectorized", 6, "soft", (ROUNDS * 3 * 6, ROUNDS * 3 * 6)),
    ("scan", 8, "soft", (ROUNDS * 3 * 8, ROUNDS * 3 * 8)),
    ("vectorized", 8, "soft", (ROUNDS * 3 * 8, ROUNDS * 3 * 8)),
    ("legacy", 8, "soft", (ROUNDS * 3 * 8, ROUNDS * 3 * 8)),
    ("scan", 8, "deadline", None),
    ("vectorized", 8, "deadline", None),
    ("legacy", 8, "deadline", None),
])
def test_row_counters(engine, b, fault, rows):
    extra = {} if fault == "soft" else dict(fault_mode=fault,
                                              deadline_factor=1.002)
    res = Session(_spec(f"fixed(b={b},cut=2)", engine=engine, **extra),
                  device="cpu").run()
    assert len(res.train_loss) == 2
    got = T.counts()
    if rows is None:
        # the same participation plan on every engine: computed is every
        # client's rows, useful those of the round's survivors
        assert got["rows_computed"] == ROUNDS * 3 * 8
        T.reset_counts()
        Session(_spec(f"fixed(b={b},cut=2)", **extra), device="cpu").run()
        assert got == T.counts()
        assert 0 < got["rows_useful"] < got["rows_computed"]
    else:
        assert (got["rows_computed"], got["rows_useful"]) == rows
    T.reset_counts()
    assert T.counts() == {}


def test_policy_counters():
    Session(_spec("hasfl"), device="cpu").run()
    got = T.counts()
    assert got["bcd_iterations"] >= 2       # two decisions, a solve each
    assert got["dinkelbach_iterations"] >= got["bcd_iterations"]
    # est_batches gradient batches of every unit, fp32, per decision
    sess = Session(_spec("hasfl"), device="cpu")
    params = sum(t.numel() for t in tree_leaves(sess.sim.units))
    assert got["estimate_bytes_to_host"] == 2 * 3 * params * 4


class _Ev(SimpleNamespace):
    """A kineto event of the synthetic profile."""

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.link

    def is_user_annotation(self):
        return self.annotation


def _cpu(n, s, d, c, link=0):
    return _Ev(cuda=False, n=n, s=s, d=d, c=c, link=link, annotation=False)


def _gpu(n, s, d, link, annotation=False):
    return _Ev(cuda=True, n=n, s=s, d=d, c=0, link=link,
               annotation=annotation)


def _profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_span_trace_by_hand():
    """A round [0, 100) with its forward [10, 30) and backward [30, 90);
    the backward's op launched from another thread at 40; an update op
    launched at 95 outside every phase; a runtime event whose correlation
    id shadows the forward op's; a device-side annotation copy."""
    events = [
        _cpu("round", 0, 100, 1), _cpu("round.forward", 10, 20, 2),
        _cpu("aten::mm", 12, 5, 3), _cpu("round.backward", 30, 60, 4),
        _cpu("aten::mm", 40, 5, 5), _cpu("aten::add", 95, 2, 6),
        _cpu("aten::mul", 200, 2, 7),
        _cpu("cudaLaunchKernel", 13, 1, 3, link=3),
        _gpu("fwd_kernel", 20, 10, 3), _gpu("bwd_kernel", 50, 30, 5),
        _gpu("upd_kernel", 96, 14, 6), _gpu("late_kernel", 210, 5, 7),
        _gpu("segment", 20, 90, 0, annotation=True),
    ]
    st = T.SpanTrace(_profile(events))
    assert [op[3] for op in st.ops] == ["fwd_kernel", "bwd_kernel",
                                        "upd_kernel", "late_kernel"]
    t = st.table()
    ns = pytest.approx
    assert t["round"] == {"calls": 1, "host_s": ns(100e-9),
                          "self_s": ns(20e-9), "device_s": ns(54e-9),
                          "launches": 3, "idle_s": ns(56e-9)}
    assert t["round.forward"]["device_s"] == ns(10e-9)
    assert t["round.forward"]["idle_s"] == ns(10e-9)
    assert t["round.backward"]["device_s"] == ns(30e-9)
    assert t["round.backward"]["idle_s"] == ns(30e-9)
    assert t["(none)"] == {"calls": 0, "host_s": 0, "self_s": 0,
                           "device_s": ns(5e-9), "launches": 1, "idle_s": 0}
    # gaps: [110, 210) after every span, [30, 50) and [80, 96) in the
    # backward (a gap starting where the forward ends and the backward
    # begins is the backward's)
    assert st.idle_gaps() == [["(none)", ns(100e-9)],
                              ["round.backward", ns(20e-9)],
                              ["round.backward", ns(16e-9)]]
