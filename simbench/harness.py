"""One run of one cell: set-up, the measured window, the output check.

The program is driven through its own entry: the cell's `Session`, whose
simulator runs the scan engine with the cell's policy as one run.  The
harness hooks in only through what the simulator exposes: the policy
callable it is handed (a host span ended by a device sync, under
``record_function("policy")``), its segment function and its eval (under
``segment`` and ``eval``), and ``run``'s own ``snapshot_cb`` at segment
boundaries.  The run's first `cell.checked_rounds` rounds (through the
first Eq. 7 round) and one more have a boundary after each, where the
readings the reference checks are taken; the run then resumes (bitwise
the uninterrupted run: boundaries do not change its numbers) with a
boundary at every eval.  Both calls pass the session's scenario,
reconfiguration period and traffic plane, as `Session.run` does.  The
first eval boundary ends the warm-up; the window runs from there to the
first eval boundary at least ``seconds`` later, so it holds whole
evaluation periods: rounds, policy calls and evals.  Each boundary's time
follows a device sync.

Once the window has closed and the program is freed, the reference
follows the same first rounds from the same initial units and the two
are compared (`cell.compare`).
"""
from __future__ import annotations

import gc
import importlib.util
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from simbench import cell as C
from simbench.reference.params import leaves
from simbench.reference.rounds import first_rounds
from simbench.tracing import Trace

BENCH = Path(__file__).resolve().parent
NO_END = 10 ** 9        # the run's round count: the window ends it


class WindowClosed(Exception):
    pass


@dataclass
class Ctx:
    """What the metric readers read (`simbench/metrics/<name>.py`)."""
    arch: object
    traffic: dict
    ref: object = None          # the configuration's reference module
    setup_s: float = 0.0
    window_s: float = 0.0
    rounds: int = 0
    peak_bytes: int = 0
    policy_s: float = 0.0
    segments: list = field(default_factory=list)
    trace: object = None


def reader(name: str):
    """The ``read`` function of metric ``name``: ``metrics/<name>.py``, or
    for a quantity split by cells (``<quantity>.<part>``, each part moving
    its own end-to-end metric) and without a file of its own, the
    quantity's ``metrics/<quantity>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"simbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_list(bench: dict, cell_name: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


class Window:
    """The run's ``snapshot_cb`` at eval boundaries: opens the window at
    the first, closes it at the first at least ``seconds`` later."""

    def __init__(self, seconds: float, trace: bool, on_card: bool):
        self.seconds = seconds
        self.trace = trace
        self.on_card = on_card
        self.t0 = self.t1 = None
        self.T0 = self.T1 = None
        self.peak_before = self.peak = 0
        self.prof = None

    def _sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def boundary(self, t, clock, b, cuts, res):
        import torch

        self._sync()
        if self.t0 is None:
            if self.on_card:
                self.peak_before = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            if self.trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.on_card:
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.start()
            self.t0, self.T0 = t, time.perf_counter()
            return
        now = time.perf_counter()
        if now - self.T0 < self.seconds:
            return
        self.t1, self.T1 = t, now
        if self.on_card:
            self.peak = torch.cuda.max_memory_allocated()
        if self.prof is not None:
            self.prof.stop()
        raise WindowClosed


class Spans:
    """Host seconds of named calls, each ended by a device sync."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.spans = []

    def _sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def wrap(self, name: str, fn):
        """``fn`` timed alone: the device's queue drained first (untimed),
        the span ended by a sync, so it holds the call and its own device
        work."""
        from torch.profiler import record_function

        def wrapped(*a, **k):
            self._sync()
            t0 = time.perf_counter()
            with record_function(name):
                try:
                    return fn(*a, **k)
                finally:
                    self._sync()
                    self.spans.append((name, t0, time.perf_counter()))
        return wrapped

    def seconds(self, name: str, lo: float, hi: float) -> float:
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.spans
                   if n == name and e > lo and s < hi)


class Run:
    """One run of a cell on the program, hooked as the module says."""

    def __init__(self, bench: dict, cell_name: str, seed: int, *,
                 device=None, cell_edit=None):
        from torch.profiler import record_function

        self.cell = C.find_cell(bench, cell_name)
        if cell_edit is not None:
            cell_edit(self.cell)
        C.check_sizes(self.cell)
        self.sess, self.units0 = C.build(self.cell, seed, NO_END, device)
        sim = self.sim = self.sess.sim
        self.on_card = self.sess.device.type == "cuda"
        self.spans = Spans(self.on_card)
        policy = self.spans.wrap("policy", self.sess.policy)
        self.decisions = []

        def decide(s, rng):
            out = policy(s, rng)
            self.decisions.append(out)
            return out

        self.decide = decide
        self.rec = C.FirstRounds(sim, self.units0,
                                 self.cell.traffic["sfl"]["lr"],
                                 C.checked_rounds(self.cell.traffic))
        self.run_kw = {"eval_every": self.cell.traffic["eval_every"],
                       "reconfigure_every": self.sess.spec.reconfigure_every,
                       "scenario": self.sess.scenario,
                       "traffic": self.sess.plane}
        self.segments = []
        run_segment = sim._segment_fn

        def segment(t0, idx, row_mask, masks, parts=None):
            with record_function("segment"):
                losses = run_segment(t0, idx, row_mask, masks, parts)
            self.segments.append({
                "t0": int(t0), "rounds": int(idx.shape[0]),
                "counts": [int(c) for c in np.asarray(row_mask).sum(axis=1)]})
            self.rec.segment(t0, idx, row_mask, losses)
            return losses

        sim._segment_fn = segment
        sim._record_metrics = self.spans.wrap("eval", sim._record_metrics)

    def first_rounds(self) -> dict:
        """Rounds 1..`cell.checked_rounds` + 1, a boundary after each; the
        program's readings of the checked ones."""
        self.sim.run(self.decide, rounds=self.rec.rounds + 1,
                     checkpoint_every=1, snapshot_cb=self.rec.boundary,
                     **self.run_kw)
        return C.program_readings(self.rec, self.decisions[0])

    def window(self, seconds: float, trace: bool) -> "Window":
        """The rest of the run, up to the window's close."""
        window = Window(seconds, trace, self.on_card)
        try:
            self.sim.run(self.decide, rounds=NO_END,
                         checkpoint_every=self.run_kw["eval_every"],
                         snapshot_cb=window.boundary, resume=self.rec.state,
                         **self.run_kw)
        except WindowClosed:
            return window
        raise RuntimeError("the run ended before the window closed")

    def free(self) -> None:
        """Drop the program's state (the initial units stay)."""
        import torch

        self.sim._segment_fn = self.sim._record_metrics = None
        self.sess = self.sim = self.rec.sim = self.decide = None
        self.run_kw = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, *, device=None, t_start=None,
             cell_edit=None) -> dict:
    """One run of ``cell_name``; returns the result's fields and the
    numbers compared.  ``device`` None runs on the card.  ``cell_edit``
    (tests) edits the loaded `cell.Cell` in place before the run."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(bench, cell_name, seed, device=device, cell_edit=cell_edit)
    cell, on_card, rec = run.cell, run.on_card, run.rec
    prog = run.first_rounds()
    window = run.window(seconds, trace)
    res = rec.state["res"]
    ctx = Ctx(arch=cell.arch, traffic=cell.traffic, ref=cell.ref,
              setup_s=window.T0 - t_start, window_s=window.T1 - window.T0,
              rounds=window.t1 - window.t0, peak_bytes=window.peak,
              policy_s=run.spans.seconds("policy", window.T0, window.T1),
              segments=[s for s in run.segments
                        if window.t0 <= s["t0"] < window.t1])
    if window.prof is not None:
        ctx.trace = Trace.from_profiler(window.prof)
        window.prof = None
    every = cell.traffic["eval_every"]
    failed = every * sum(
        1 for t, a, b in zip(res.rounds, res.train_loss, res.test_loss)
        if window.t0 < t <= window.t1
        and not (math.isfinite(a) and math.isfinite(b)))
    memory_peak = max(window.peak_before, window.peak)
    run.free()
    units0 = run.units0
    ref = first_rounds(cell.ref, cell.arch, cell.traffic, seed, units0,
                       leaves(units0)[0].device, rounds=rec.rounds)
    readings = C.compare(prog, ref)
    correct, checks = C.verdict(readings, cell.check["limits"])

    metrics = {}
    for m in metric_list(bench, cell_name, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct),
           "attempted": int(ctx.rounds), "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if on_card
                               else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": int(memory_peak)}}
    if trace and ctx.trace is not None:
        out["device"]["busy_s"] = ctx.trace.busy_s()
        out["device"]["window_s"] = ctx.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    out["checks"] = {name: [value, limit] for name, value, limit in checks}
    out["_readings"] = readings
    return out
