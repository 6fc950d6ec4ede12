"""Where one training run's (or one serving run's) time goes on the card,
and the program's spans and counters that say so.

    PYTHONPATH=src python3 -m repro_torch.trace [--rounds 6] [--mesh] [--out DIR]
    PYTHONPATH=src python3 -m repro_torch.trace --serve [--arch xlstm-350m] \
        [--layers N]

The program marks its layers with `span` (names in `SPANS`): the policy
call's estimate and BCD solve, each segment's planning, clock walk and
upload, each round's gather, forward, backward, clip and update, the eval
and the cohort rotation.  A span costs one flag check when no profiler
runs; under ``torch.profiler`` it is a host range on the profiler's clock
(a `RecordFunction` of function scope, so the profiler makes no device-
side copy of it) and never syncs the card.  `count` keeps counters that
the program bumps once a segment or a policy call: ``rows_computed`` and
``rows_useful`` (padded against real rows), ``bcd_iterations``,
``dinkelbach_iterations`` and ``estimate_bytes_to_host`` (the bytes the
estimate copies to the host: every gradient sample where the gradients are
on the CPU, only the ``[units, 2]`` fp64 moments where they are on the
card).  `profiled`
holds what was counted, and each span's calls and host seconds, while a
profile recorded.  `SpanTrace` reduces a profile to a table by span.

The command runs the main path of ``chip_smoke.py``'s ``train`` phase
(VGG-16 at full width, N=8, the HASFL controller) — or, with ``--mesh``,
its ``mesh`` phase (16 resident slots of a population of 1024 on a world
of one) — once untraced to warm the kernel builds, then again under
``torch.profiler`` (CPU + CUDA activities), and prints one JSON line:
the card's name and power limit, the run's wall seconds, for each span
its calls, host seconds, self host seconds, the device seconds and count
of the operations launched inside it and the device's idle seconds while
it was open, the counters, the ten longest device idle gaps each named by
the innermost span open where it began, the device-busy milliseconds (the
union of the kernel and memcpy intervals the profiler saw on the card) by
kernel name, and the device's busy and idle shares of the wall time.  The
Chrome trace goes to ``DIR/trace.json`` (default ``build/trace``).

With ``--serve`` it traces ``chip_smoke.py``'s ``serve`` phase instead
(``--arch``, default qwen3-1.7b, at full width in its own dtype, with
`launch.serve.FULL_WIDTH_TRAFFIC`; ``--layers`` cuts the depth, as
``chip_smoke.py`` does for the MoE and hybrid families that do not fit
the card whole): after a warm-up run and an untraced
run (its prefill and per-step decode times are reported), one
`launch.serve.serve` runs under the profiler, and the JSON line gives,
for each of its spans ``serve.prefill`` and ``serve.decode``, the wall
milliseconds, device-busy milliseconds by kernel name and busy and idle
shares, and the launches of the port's kernels (trace
``DIR/serve.json``).  Needs a card; there is no CPU mode.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import time
from collections import Counter, defaultdict
from pathlib import Path

import torch

SPANS = (
    "policy.estimate", "policy.estimate.grad", "policy.estimate.to_host",
    "policy.estimate.stats", "policy.solve", "policy.solve.bs",
    "policy.solve.ms", "segment.plan", "segment.clock", "segment.upload",
    "round", "round.gather", "round.forward", "round.backward", "round.clip",
    "round.update", "eval.aggregate", "eval.forward", "eval.fetch",
    "mesh.rotate", "serve.prefill", "serve.decode")

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_COUNTS = Counter()
_PROFILED = {"counters": Counter(), "calls": Counter(),
             "host_s": defaultdict(float)}


class _Span:
    """A host range on the profiler's clock that also adds its calls and
    host seconds to `profiled`."""
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str, ident):
        fast = torch._C._profiler._RecordFunctionFast
        self.name = name
        self._rf = fast(name) if ident is None else \
            fast(name, (), {"id": ident})

    def __enter__(self):
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _PROFILED["host_s"][self.name] += time.perf_counter() - self._t0
        _PROFILED["calls"][self.name] += 1
        return self._rf.__exit__(*exc)


def span(name: str, ident=None):
    """The program's span ``name`` (one of `SPANS`): a shared null context
    when no profiler runs, else a host range carrying ``ident`` (the round
    ``t`` or the decision index) as its keyword input ``id``."""
    if not _profiling():
        return _NULL
    return _Span(name, ident)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` (and to `profiled`'s while a profile
    records)."""
    _COUNTS[name] += int(n)
    if _profiling():
        _PROFILED["counters"][name] += int(n)


def counts() -> dict:
    """Every counter since the last `reset_counts`."""
    return dict(_COUNTS)


def profiled() -> dict:
    """What the program counted while a profile recorded, since the last
    `reset_counts`: ``counters``, and per span name its ``calls`` and
    host seconds ``host_s``."""
    return {"counters": dict(_PROFILED["counters"]),
            "spans": {name: {"calls": n,
                             "host_s": _PROFILED["host_s"][name]}
                      for name, n in _PROFILED["calls"].items()}}


def reset_counts() -> None:
    """Zero the counters and `profiled`."""
    _COUNTS.clear()
    for v in _PROFILED.values():
        v.clear()


def train_spec(rounds: int):
    """The ``train`` phase's spec of ``chip_smoke.py``, at ``rounds``."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.config import SFLConfig

    return ExperimentSpec(
        arch="vgg16-cifar", n_clients=8, partition="iid", n_train=4096,
        n_test=512, rounds=rounds, eval_every=4, policy="hasfl",
        conv_impl="kernel", update_impl="kernel",
        sfl=SFLConfig(lr=0.05, agg_interval=3))


def mesh_spec(rounds: int):
    """The ``mesh`` phase's spec of ``chip_smoke.py``, at ``rounds``."""
    from repro_torch.mesh import MeshSpec

    return train_spec(rounds).replace(
        n_clients=16, n_train=16384,
        mesh=MeshSpec(devices=1, n_edges=4, population=1024))


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class SpanTrace:
    """One profile reduced to the program's spans (`SPANS`, every thread's
    on one timeline: they nest) and the device operations, each operation
    given to the innermost span open when its launch began.  The launch is
    the host op the profiler correlates with it; where none is recorded,
    its start on the device.  So the backward's launches, made from
    autograd's thread while the main thread waits inside
    ``round.backward``, land in ``round.backward``."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = list(prof.profiler.kineto_results.events())
        launch_at, self.spans = {}, []
        for ev in events:
            # host ops link to nothing; the runtime's events (linked to
            # the op that called them) number their ids apart and could
            # shadow an op's
            if ev.device_type() == DeviceType.CPU and \
                    ev.linked_correlation_id() == 0:
                start = int(ev.start_ns())
                launch_at[ev.correlation_id()] = start
                if ev.name() in SPANS:
                    self.spans.append(
                        (start, start + int(ev.duration_ns()), ev.name()))
        self.ops = []
        for ev in events:
            # a user annotation on the device is the profiler's copy of a
            # host range (`record_function`), not work
            if ev.device_type() == DeviceType.CUDA and \
                    not ev.is_user_annotation():
                start = int(ev.start_ns())
                self.ops.append((start, start + int(ev.duration_ns()),
                                 launch_at.get(ev.linked_correlation_id(),
                                               start), ev.name()))
        self.spans.sort()
        # the innermost open span after each boundary, and each span's
        # parent (ends before starts at one instant)
        self._at, self._inner, stack = [], [], []
        bounds = sorted([(s, 1, i) for i, (s, _, _) in enumerate(self.spans)]
                        + [(e, 0, i) for i, (_, e, _) in
                           enumerate(self.spans)])
        self.parent = [-1] * len(self.spans)
        for t, opening, i in bounds:
            if opening:
                self.parent[i] = stack[-1] if stack else -1
                stack.append(i)
            else:
                stack.remove(i)
            self._at.append(t)
            self._inner.append(stack[-1] if stack else -1)
        busy = []
        for s, e, _, _ in sorted(self.ops):
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        self._busy = busy
        self._busy_starts = [b[0] for b in busy]
        self._busy_before = [0]
        for s, e in busy:
            self._busy_before.append(self._busy_before[-1] + e - s)

    def innermost(self, t_ns: int) -> int:
        """Index of the innermost span open at ``t_ns`` (-1: none)."""
        k = bisect.bisect_right(self._at, t_ns) - 1
        return self._inner[k] if k >= 0 else -1

    def busy_ns(self, lo: int, hi: int) -> int:
        """Device-busy nanoseconds within [lo, hi)."""
        def upto(t):
            k = bisect.bisect_right(self._busy_starts, t) - 1
            if k < 0:
                return 0
            s, e = self._busy[k]
            return self._busy_before[k] + min(e, t) - s
        return upto(hi) - upto(lo)

    def table(self) -> dict:
        """Per span name: ``calls``, ``host_s``, ``self_s`` (less its child
        spans), ``device_s`` and ``launches`` of the operations launched
        inside it (at any depth), ``idle_s`` (no device operation running
        while it was open).  ``(none)`` holds the operations launched
        outside every span."""
        out = defaultdict(lambda: dict.fromkeys(
            ("calls", "host_s", "self_s", "device_s", "launches",
             "idle_s"), 0))
        child_ns = [0] * len(self.spans)
        for i, (s, e, _) in enumerate(self.spans):
            if self.parent[i] >= 0:
                child_ns[self.parent[i]] += e - s
        for i, (s, e, name) in enumerate(self.spans):
            row = out[name]
            row["calls"] += 1
            row["host_s"] += (e - s) / 1e9
            row["self_s"] += (e - s - child_ns[i]) / 1e9
            row["idle_s"] += (e - s - self.busy_ns(s, e)) / 1e9
        for s, e, at, _ in self.ops:
            i = self.innermost(at)
            names = set() if i >= 0 else {"(none)"}
            while i >= 0:
                names.add(self.spans[i][2])
                i = self.parent[i]
            for name in names:
                out[name]["device_s"] += (e - s) / 1e9
                out[name]["launches"] += 1
        return dict(out)

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest device idle gaps, each named by the innermost
        span open where it began (``(none)`` outside every span)."""
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in
                       zip(self._busy, self._busy[1:])), reverse=True)
        return [[self.name_at(at), g / 1e9] for g, at in gaps[:k]]

    def name_at(self, t_ns: int) -> str:
        """The innermost span open at ``t_ns``, ``(none)`` outside all."""
        i = self.innermost(t_ns)
        return self.spans[i][2] if i >= 0 else "(none)"


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _cuda_events(prof, skip=()):
    """The profile's device events, less the annotations named ``skip``."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.events()
            if ev.device_type == DeviceType.CUDA and ev.name not in skip]


def _device_times(events):
    """(busy ms, top-15 ms by kernel name, event count) of device events."""
    by_name, intervals = defaultdict(float), []
    for ev in events:
        tr = ev.time_range
        intervals.append((tr.start, tr.end))
        by_name[ev.name] += tr.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return _busy_us(intervals) / 1e3, dict(top), len(intervals)


SERVE_SPANS = ("serve.prefill", "serve.decode")


def trace_serve(arch: str, out_dir: Path, layers=None) -> dict:
    """The ``serve`` phase's traffic: a warm-up run, an untraced run, then
    one `serve` under the profiler, split by its prefill and decode
    spans.  ``layers`` cuts the model's depth."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (FULL_WIDTH_TRAFFIC, seeded_inputs,
                                          serve)

    t = FULL_WIDTH_TRAFFIC
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params, prompts = seeded_inputs(cfg, t["batch"], t["prompt"], t["seed"],
                                    "cuda")
    serve(cfg, params, prompts, t["gen"])                 # warm-up
    untraced = serve(cfg, params, prompts, t["gen"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(cfg, params, prompts, t["gen"])
    prof.export_chrome_trace(str(out_dir / "serve.json"))
    spans = {ev.name: ev.time_range for ev in prof.events()
             if ev.device_type == DeviceType.CPU and ev.name in SERVE_SPANS}
    device = _cuda_events(prof, skip=SERVE_SPANS)
    report = {"gpu": _smi(), "spec": "serve", "arch": arch,
              "n_layers": cfg.n_layers, "dtype": cfg.dtype, **t,
              "untraced_prefill_ms": untraced.prefill_s * 1e3,
              "untraced_decode_ms_per_step":
                  untraced.decode_s * 1e3 / t["gen"],
              "launches": {k: v for k, v in ops.launch_counts().items()
                           if v}}
    for name in SERVE_SPANS:
        tr = spans[name]
        busy_ms, top, n = _device_times(
            ev for ev in device if tr.start <= ev.time_range.start < tr.end)
        wall_ms = tr.elapsed_us() / 1e3
        report[name.split(".")[1]] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ms_by_kernel": top, "n_device_events": n}
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--mesh", action="store_true",
                    help="trace the mesh phase instead of the flat one")
    ap.add_argument("--serve", action="store_true",
                    help="trace the serving path (prefill + decode)")
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="the token model of --serve")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut --serve's model to this many layers")
    ap.add_argument("--out", default="build/trace")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.serve:
        report = trace_serve(args.arch, out_dir, args.layers)
        print(json.dumps(report), flush=True)
        return report
    make_spec = mesh_spec if args.mesh else train_spec
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace   # the program's counters, not __main__'s
    from repro_torch.api import Session

    smi = _smi()
    Session(make_spec(3)).run()                       # warm the builds

    sess = Session(make_spec(args.rounds))
    torch.cuda.synchronize()
    trace.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, top, n_events = _device_times(_cuda_events(prof))
    spans = SpanTrace(prof)
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    report = {
        "gpu": smi, "spec": "mesh" if args.mesh else "train",
        "rounds": args.rounds, "wall_s": wall,
        "spans": spans.table(), "counters": trace.counts(),
        "idle_gaps": spans.idle_gaps(),
        "device_busy_ms": busy_ms if n_events else None,
        "device_busy_share": busy_ms / (wall * 1e3) if n_events else None,
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if n_events
        else None,
        "device_ms_by_kernel": top,
        "n_device_events": n_events,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
