"""Run one mesh-mode `ExperimentSpec` on ``d`` processes, one per device.

    PYTHONPATH=src python -m repro_torch.mesh.launch --spec spec.json \\
        --devices 4 [--cpu] [--port 29511] [--init units.pt] [--out DIR]

The parent starts ``d`` copies of itself (``--rank r``) and waits for
all of them; if one fails, the others are stopped.  Each rank calls
``torch.distributed.init_process_group`` with an explicit address
(``tcp://127.0.0.1:<port>``), world size and rank — NCCL on the card,
where rank ``r`` runs on ``cuda:r``, gloo with ``--cpu`` — then runs
``Session(spec, device).run()`` and writes ``rank<r>.pt`` into ``--out``:
the `SimResult` lists, the gather plans it drew, and its own
``[N/d, ...]`` slice of the final parameters.  Rank 0 prints one JSON
line with the run's clock, losses and seconds per round.  ``--init``
names a ``torch.save``d unit list of tensors that replaces the port's
seeded init on every rank.

``--check-d1`` then runs the same spec at ``devices=1`` (one process,
into ``<out>/d1``) and holds the d-rank run against it: clocks,
decisions and gather plans bitwise equal, losses, accuracies and the
ranks' concatenated parameters within 1e-4.  It prints one JSON line
and exits 1 if any of these fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHECK_TOL = 1e-4     # losses, accuracies and parameters, fp32


def _run_rank(args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.utils.tree import tree_leaves

    spec = ExperimentSpec.load(args.spec)
    if args.cpu:
        backend, device = "gloo", torch.device("cpu")
    else:
        backend, device = "nccl", torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{args.address}:{args.port}",
        world_size=args.devices, rank=args.rank)
    try:
        init = None if args.init is None else torch.load(args.init)
        sess = Session(spec, device=device, init_units=init)
        plans = []
        draw = sess.sim.store.segment_indices

        def recording(*a):
            plans.append(draw(*a))
            return plans[-1]

        sess.sim.store.segment_indices = recording
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = sess.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        out = {
            "rank": args.rank, "devices": args.devices,
            "n_local": sess.sim.n_local, "seconds": seconds,
            "rounds": res.rounds, "clock": res.clock,
            "train_loss": res.train_loss, "test_loss": res.test_loss,
            "test_acc": res.test_acc,
            "b_history": [torch.as_tensor(b) for b in res.b_history],
            "cut_history": [torch.as_tensor(c) for c in res.cut_history],
            "plans": [torch.as_tensor(p) for p in plans],
            "leaves": [t.detach().cpu() for t in
                       tree_leaves(sess.sim._stacked)],
        }
        Path(args.out).mkdir(parents=True, exist_ok=True)
        torch.save(out, Path(args.out) / f"rank{args.rank}.pt")
        if args.rank == 0:
            print(json.dumps({
                "devices": args.devices, "backend": backend,
                "n_local": out["n_local"], "seconds": seconds,
                "seconds_per_round": seconds / spec.rounds,
                "clock": res.clock, "train_loss": res.train_loss,
                "test_acc": res.test_acc}), flush=True)
    finally:
        dist.destroy_process_group()


def _spawn(args, spec: str, devices: int, out: str) -> int:
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    if args.address == "127.0.0.1":
        # every rank is on this host: bootstrap over the loopback
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    base = [sys.executable, "-m", "repro_torch.mesh.launch",
            "--spec", spec, "--devices", str(devices),
            "--address", args.address, "--port", str(args.port),
            "--out", out]
    if args.cpu:
        base.append("--cpu")
    if args.init is not None:
        base += ["--init", args.init]
    procs = [subprocess.Popen(base + ["--rank", str(r)], env=env)
             for r in range(devices)]
    rcs = [None] * len(procs)
    try:
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    return next((rc for rc in rcs if rc != 0), 0)


def _check_d1(args) -> int:
    """Run the spec at devices=1 and hold the d-rank run against it."""
    import torch

    from repro_torch.api import ExperimentSpec

    spec = ExperimentSpec.load(args.spec)
    d1_dir = Path(args.out) / "d1"
    d1_dir.mkdir(parents=True, exist_ok=True)
    spec.replace(mesh=dataclasses.replace(spec.mesh, devices=1)).save(
        d1_dir / "spec.json")
    rc = _spawn(args, str(d1_dir / "spec.json"), 1, str(d1_dir))
    if rc != 0:
        return rc
    one = torch.load(d1_dir / "rank0.pt")
    ranks = [torch.load(Path(args.out) / f"rank{r}.pt")
             for r in range(args.devices)]

    def same(xs, ys):
        return len(xs) == len(ys) and all(
            torch.equal(x, y) for x, y in zip(xs, ys))

    keys = ("train_loss", "test_loss", "test_acc")
    loss_err = max(abs(a - b) for r in ranks for k in keys
                   for a, b in zip(r[k], one[k]))
    param_err = max(float((torch.cat([r["leaves"][i] for r in ranks])
                           - leaf).abs().max())
                    for i, leaf in enumerate(one["leaves"]))
    report = {
        "check_d1": True, "devices": args.devices,
        "clock_equal": all(r["clock"] == one["clock"] for r in ranks),
        "decisions_equal": all(
            same(r["b_history"], one["b_history"])
            and same(r["cut_history"], one["cut_history"]) for r in ranks),
        "plans_equal": all(same(r["plans"], one["plans"]) for r in ranks),
        "loss_acc_max_err": loss_err, "param_max_err": param_err,
        "seconds": ranks[0]["seconds"], "seconds_d1": one["seconds"],
    }
    report["ok"] = (report["clock_equal"] and report["decisions_equal"]
                    and report["plans_equal"] and loss_err <= CHECK_TOL
                    and param_err <= CHECK_TOL)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", required=True, help="ExperimentSpec JSON file")
    ap.add_argument("--devices", type=int, required=True,
                    help="ranks = devices (must equal spec.mesh.devices)")
    ap.add_argument("--cpu", action="store_true",
                    help="run every rank on the CPU over gloo")
    ap.add_argument("--address", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=29511)
    ap.add_argument("--init", default=None,
                    help="torch.save'd unit list replacing the seeded init")
    ap.add_argument("--out", default="build/mesh_launch")
    ap.add_argument("--check-d1", action="store_true",
                    help="also run devices=1 and hold this run against it")
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank (set by the parent)")
    args = ap.parse_args(argv)
    if args.rank is not None:
        _run_rank(args)
        return 0
    rc = _spawn(args, args.spec, args.devices, args.out)
    if rc == 0 and args.check_d1:
        rc = _check_d1(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
