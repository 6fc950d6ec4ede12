"""Where one training run's (or one serving run's) time goes on the card.

    PYTHONPATH=src python3 -m repro_torch.trace [--rounds 6] [--mesh] [--out DIR]
    PYTHONPATH=src python3 -m repro_torch.trace --serve [--arch xlstm-350m] \
        [--layers N]

Runs the main path of ``chip_smoke.py``'s ``train`` phase (VGG-16 at full
width, N=8, the HASFL controller) — or, with ``--mesh``, its ``mesh``
phase (16 resident slots of a population of 1024 on a world of one) —
once untraced to warm the kernel builds,
then again under ``torch.profiler`` (CPU + CUDA activities), and prints one
JSON line: the card's name and power limit, the run's wall seconds, the
host seconds spent in policy decisions (the BCD solve and the online
G²/σ² estimate), in eval and (``--mesh``) in cohort rotations, the
device-busy milliseconds (the union of
the kernel and memcpy intervals the profiler saw on the card) by kernel
name, and the device's busy and idle shares of the wall time.  The Chrome
trace goes to ``DIR/trace.json`` (default ``build/trace``).

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
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from repro_torch.api import ExperimentSpec, Session
from repro_torch.config import SFLConfig


def train_spec(rounds: int) -> ExperimentSpec:
    """The ``train`` phase's spec of ``chip_smoke.py``, at ``rounds``."""
    return ExperimentSpec(
        arch="vgg16-cifar", n_clients=8, partition="iid", n_train=4096,
        n_test=512, rounds=rounds, eval_every=4, policy="hasfl",
        conv_impl="kernel", update_impl="kernel",
        sfl=SFLConfig(lr=0.05, agg_interval=3))


def mesh_spec(rounds: int) -> ExperimentSpec:
    """The ``mesh`` phase's spec of ``chip_smoke.py``, at ``rounds``."""
    from repro_torch.mesh import MeshSpec

    return train_spec(rounds).replace(
        n_clients=16, n_train=16384,
        mesh=MeshSpec(devices=1, n_edges=4, population=1024))


def _timed(fn, acc: dict, key: str):
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
    return wrapped


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


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

    smi = _smi()
    Session(make_spec(3)).run()                       # warm the builds

    sess = Session(make_spec(args.rounds))
    host = defaultdict(float)
    sess.policy = _timed(sess.policy, host, "policy_s")
    sess.sim._record_metrics = _timed(sess.sim._record_metrics, host,
                                      "eval_s")
    if sess.sim._bank is not None:
        sess.sim._bank.rotate = _timed(sess.sim._bank.rotate, host,
                                       "rotate_s")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, top, n_events = _device_times(_cuda_events(prof))
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    report = {
        "gpu": smi, "spec": "mesh" if args.mesh else "train",
        "rounds": args.rounds, "wall_s": wall,
        "policy_s": host["policy_s"], "eval_s": host["eval_s"],
        "rotate_s": host["rotate_s"],
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
