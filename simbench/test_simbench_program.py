"""The per-layer metrics that read the program's own spans and counters
(`simbench/program.py`): each reader's value worked out by hand, nothing
where the program keeps no tally, the accepted trace reader unmoved by
the program's spans, and a traced run of each small cell on the CPU."""
from types import SimpleNamespace

import pytest

from repro_torch import trace as T

from simbench import cell as C
from simbench.harness import reader, run_cell
from simbench.test_simbench_reference import small
from simbench.tracing import Trace

BENCH = C.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = ("estimate_share.hasfl", "solve_share.hasfl", "useful_rows",
       "useful_rows.vgg_fixed", "useful_rows.hasfl", "launches_per_round")

TALLY = {"spans": {"policy.estimate": {"calls": 2, "host_s": 3.0},
                   "policy.solve": {"calls": 2, "host_s": 6.0},
                   "round": {"calls": 4, "host_s": 1.0}},
         "counters": {"rows_computed": 128, "rows_useful": 96}}


def _ctx():
    ops = [("k", 0, 1, "segment")] * 10 + [("k", 0, 1, "policy")] * 3
    return SimpleNamespace(window_s=30.0,
                           trace=SimpleNamespace(ops=ops))


@pytest.mark.parametrize("name,value", [
    ("estimate_share.hasfl", 10.0), ("solve_share.hasfl", 20.0),
    ("useful_rows", 75.0), ("useful_rows.vgg_fixed", 75.0),
    ("useful_rows.hasfl", 75.0), ("launches_per_round", 2.5)])
def test_reader_by_hand(monkeypatch, name, value):
    monkeypatch.setattr(T, "profiled", lambda: TALLY)
    assert reader(name)(_ctx()) == pytest.approx(value)


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_without_a_tally(monkeypatch, name):
    monkeypatch.delattr(T, "profiled")
    assert reader(name)(_ctx()) is None


class _Ev(SimpleNamespace):
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


def _events(program_spans: bool) -> list:
    """A ``segment`` range [0, 100) (and its device-side copy) whose ops
    launch kernel 1 twice and an elementwise kernel, then an ``eval``
    range; with ``program_spans`` the program's ``round`` and
    ``round.forward`` spans (function scope: no device-side copy) wrap
    those launches."""
    ev = [_Ev(cuda=False, n="segment", s=0, d=100, c=1, link=0),
          _Ev(cuda=False, n="aten::bmm", s=10, d=5, c=2, link=0),
          _Ev(cuda=False, n="aten::add", s=30, d=5, c=3, link=0),
          _Ev(cuda=False, n="aten::bmm", s=60, d=5, c=4, link=0),
          _Ev(cuda=False, n="eval", s=150, d=50, c=5, link=0),
          _Ev(cuda=False, n="aten::mm", s=160, d=5, c=6, link=0),
          _Ev(cuda=True, n="segment", s=20, d=130, c=0, link=1),
          _Ev(cuda=True, n="void bmm_f32_kernel<64>(float*)", s=20, d=30,
              c=0, link=2),
          _Ev(cuda=True, n="elementwise_kernel", s=50, d=10, c=0, link=3),
          _Ev(cuda=True, n="void bmm_f32_kernel<64>(float*)", s=90, d=60,
              c=0, link=4),
          _Ev(cuda=True, n="gemm", s=170, d=10, c=0, link=6)]
    if program_spans:
        ev += [_Ev(cuda=False, n="round", s=5, d=90, c=7, link=0),
               _Ev(cuda=False, n="round.forward", s=8, d=40, c=8, link=0)]
    return ev


def _trace(program_spans: bool) -> Trace:
    results = SimpleNamespace(events=lambda: _events(program_spans))
    return Trace.from_profiler(SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=results)))


def test_accepted_trace_reads_the_same_with_program_spans():
    bare, spanned = _trace(False), _trace(True)
    assert spanned.ranges == bare.ranges
    assert spanned.ops == bare.ops
    assert spanned.busy_s() == bare.busy_s() == pytest.approx(110e-9)
    assert spanned.top_ops() == bare.top_ops()
    assert spanned.idle_gaps() == bare.idle_gaps()
    assert spanned.seconds({"bmm_f32_kernel"}, within="segment") == \
        pytest.approx(90e-9)
    ctx = SimpleNamespace(trace=spanned, window_s=300e-9)
    assert reader("device_idle_share")(ctx) == \
        reader("device_idle_share")(SimpleNamespace(trace=bare,
                                                    window_s=300e-9))


@pytest.mark.parametrize("name", CELLS)
def test_traced_small_cell_reports_the_new_metrics(name):
    T.reset_counts()
    out = run_cell(BENCH, name, 5, 0.05, True, device="cpu",
                   cell_edit=small)
    metrics = out["metrics"]
    wanted = {m["name"] for m in BENCH["per_layer"]
              if name in m["workloads"] and m["name"] in NEW}
    # no device operations run on the CPU: nothing to count per round
    assert set(metrics) & set(NEW) == wanted - {"launches_per_round"}
    rows = next(k for k in metrics if k.startswith("useful_rows"))
    if "hasfl" in name:
        split = metrics["estimate_share.hasfl"]["value"] + \
            metrics["solve_share.hasfl"]["value"]
        assert 0 < split <= metrics["policy_share.hasfl"]["value"] + 1e-9
        assert metrics["policy_share.hasfl"]["value"] - split < 3.0
        assert 0 < metrics[rows]["value"] <= 100
    else:
        # fixed b = 24 of b_pad 32 (VGG), b = 4 of 4 (the small SmolLM)
        expect = 75.0 if "vgg" in name else 100.0
        assert metrics[rows]["value"] == expect
