"""Perf experiments on the dry-run (port of `repro.launch.perf`): re-run
one (arch x shape) combination with a named experiment knob and report
its roofline terms beside the baseline's, with the deltas.

    python -m repro_torch.launch.perf --arch qwen3-1.7b --shape train_4k \\
        --experiment seq_parallel

Each experiment swaps a module-level hook or knob of `dist.sharding` /
`launch.dryrun` (the reference's monkeypatch points) for the run and puts
it back afterwards, so baseline and experiment run in one process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as DR

EXPERIMENTS = {}


def experiment(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


@experiment("baseline")
def _baseline():
    """No change — the paper-faithful configuration."""
    return []


@experiment("no_remat")
def _no_remat():
    """Hypothesis: dropping remat trades memory for ~1/3 less compute
    (no recompute) — moves the compute term down, memory term up."""
    return [(DR, "FORCE_REMAT", False)]


@experiment("accum_2x")
def _accum2():
    """Hypothesis: halving the micro-batch count (2x bigger micro-batches)
    reduces per-step overhead; memory term rises."""
    return [(DR, "FORCE_ACCUM_SCALE", 0.5)]


@experiment("seq_parallel")
def _seqp():
    """Hypothesis: sequence-parallel activations ('model' axis on seq)
    instead of batch-only sharding lower per-device activation memory on
    long-sequence shapes at the cost of extra all-gathers around
    attention (collective term up)."""
    return [(SH, "make_shard_fn", SH.make_seq_shard_fn),
            (DR, "make_shard_fn", SH.make_seq_shard_fn)]


@experiment("cache_replicated")
def _cache_repl():
    """Hypothesis (decode): the collective term is dominated by the qk^T
    psum over the hd-sharded cache.  Replicating the cache across 'model'
    removes the psum at the cost of redundant attention compute and more
    per-device cache bytes."""
    return [(SH, "cache_shardings", SH.cache_shardings_replicated),
            (DR, "cache_shardings", SH.cache_shardings_replicated)]


@experiment("flat_experts")
def _flat_experts():
    """Hypothesis (MoE): shard experts over BOTH mesh axes (E over model,
    the last dim over data) instead of (E over model, d over data) —
    balances the all-to-all against the FSDP all-gather."""
    orig = SH.auto_param_spec

    def auto(shape, mesh, **kw):
        if kw.get("expert"):
            n_tp = SH._model_size(mesh)
            dp = SH._dp_axes(mesh)
            n_dp = SH._axis_size(mesh, dp)
            spec = [None] * len(shape)
            dims = list(range(1, len(shape)))  # skip stack axis
            if shape[dims[0]] % n_tp == 0:
                spec[dims[0]] = "model"
            # FSDP on the LAST dim (d_ff for gate/up, d for down)
            if shape[dims[-1]] % n_dp == 0:
                spec[dims[-1]] = dp
            return SH.P(*spec)
        return orig(shape, mesh, **kw)

    return [(SH, "auto_param_spec", auto)]


@contextlib.contextmanager
def applied(name: str):
    """Experiment ``name``'s swaps in place for the block."""
    swaps = EXPERIMENTS[name]()
    saved = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    try:
        for m, a, v in swaps:
            setattr(m, a, v)
        yield
    finally:
        for m, a, v in reversed(saved):
            setattr(m, a, v)


TERMS = ("t_compute_s", "t_memory_s", "t_collective_s")


def run_experiment(arch: str, shape_name: str, name: str,
                   multi_pod: bool = False, **kw) -> dict:
    """The experiment's record beside the baseline's: per-device bytes,
    the roofline terms and each one's delta against the baseline.  ``kw``
    go to `launch.dryrun.run_combo` (``mesh``, ``shape``)."""
    base = DR.run_combo(arch, shape_name, multi_pod, **kw)
    with applied(name):
        rec = DR.run_combo(arch, shape_name, multi_pod, **kw)
    rec["experiment"] = name
    if rec.get("status") != "ok" or base.get("status") != "ok":
        return rec
    rf, bf = rec["roofline"], base["roofline"]
    rec["vs_baseline"] = {
        "per_device_bytes": rec["per_device_bytes"]
        - base["per_device_bytes"],
        **{t: rf[t] - bf[t] for t in TERMS},
        "bottleneck": [bf["bottleneck"], rf["bottleneck"]]}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--experiment", default="baseline",
                    choices=sorted(EXPERIMENTS))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="build/perf")
    args = ap.parse_args(argv)

    rec = run_experiment(args.arch, args.shape, args.experiment,
                         args.mesh == "multi")
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}_{args.shape}_{args.experiment}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    rf = rec.get("roofline", {})
    print(json.dumps({
        "experiment": args.experiment,
        "per_device_GB": round(rec.get("per_device_bytes", 0) / 1e9, 2),
        "t_compute_s": rf.get("t_compute_s"),
        "t_memory_s": rf.get("t_memory_s"),
        "t_collective_s": rf.get("t_collective_s"),
        "bottleneck": rf.get("bottleneck"),
        "useful": rf.get("useful_flops_frac"),
        "vs_baseline": rec.get("vs_baseline"),
    }, indent=1))


if __name__ == "__main__":
    main()
