"""Where one training run's time goes on the card.

    PYTHONPATH=src python3 -m repro_torch.trace [--rounds 6] [--mesh] [--out DIR]

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
trace goes to ``DIR/trace.json`` (default ``build/trace``).  Needs a card;
there is no CPU mode.
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--mesh", action="store_true",
                    help="trace the mesh phase instead of the flat one")
    ap.add_argument("--out", default="build/trace")
    args = ap.parse_args(argv)
    make_spec = mesh_spec if args.mesh else train_spec
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
    by_name, intervals = defaultdict(float), []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        intervals.append((tr.start, tr.end))
        by_name[ev.name] += tr.elapsed_us() / 1e3
    busy_ms = _busy_us(intervals) / 1e3
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    report = {
        "gpu": smi, "spec": "mesh" if args.mesh else "train",
        "rounds": args.rounds, "wall_s": wall,
        "policy_s": host["policy_s"], "eval_s": host["eval_s"],
        "rotate_s": host["rotate_s"],
        "device_busy_ms": busy_ms if intervals else None,
        "device_busy_share": busy_ms / (wall * 1e3) if intervals else None,
        "device_idle_share": 1 - busy_ms / (wall * 1e3) if intervals
        else None,
        "device_ms_by_kernel": {k: v for k, v in top},
        "n_device_events": len(intervals),
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
