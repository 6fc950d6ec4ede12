"""Training launcher (port of `repro.launch.train`, edge mode).

``--mode edge`` runs the paper-faithful HASFL edge simulation (N
heterogeneous clients, BS+MS controller, latency model) on a CNN through
`repro_torch.api.Session`, with the reference's flags and defaults, plus
``--device`` (default: the CUDA card, raising without one; ``cpu`` runs
the plain PyTorch paths).  With ``--csv`` it writes one row per eval and
the spec beside it (``<csv>.spec.json``), so the run is replayable.

``--mode spmd`` (the pod-style token-model step) and the ``legacy`` /
``vectorized`` engines are not ported yet (ROADMAP.md §1): they raise
``NotImplementedError``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --mode edge --arch vgg9-cifar-small --rounds 100
    PYTHONPATH=src python -m repro_torch.launch.train --mode edge --device cpu --clients 4 --rounds 12 --scenario straggler-bursts
"""
from __future__ import annotations

import argparse
import os


def edge_spec(args):
    """The `ExperimentSpec` of an edge-mode command line."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.config import SFLConfig

    return ExperimentSpec(
        arch=args.arch,
        n_clients=args.clients,
        partition="iid" if args.iid else "noniid-shards",
        n_train=args.n_train,
        n_test=args.n_test,
        seed=args.seed,
        policy=args.policy,
        estimate=not args.no_estimate,
        scenario=args.scenario or None,
        scenario_seed=args.scenario_seed,
        rounds=args.rounds,
        eval_every=args.eval_every,
        engine=args.engine,
        sfl=SFLConfig(n_devices=args.clients,
                      agg_interval=args.agg_interval, lr=args.lr),
    )


def run_edge(args):
    """Run the edge simulation; returns (spec, `SimResult`)."""
    from repro_torch.api import Session
    from repro_torch.training.metrics import MetricLogger

    spec = edge_spec(args)
    res = Session(spec, device=args.device).run(verbose=True)
    print(f"final acc={res.test_acc[-1]:.4f} "
          f"converged_time={res.converged_time():.1f}s "
          f"simulated_clock={res.clock[-1]:.1f}s")
    if args.csv:
        # the spec lands next to the CSV so the run is replayable (the
        # reference saves it before anything makes the CSV's directory)
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        spec.save(args.csv + ".spec.json")
        log = MetricLogger(args.csv, print_every=0)
        for i, r in enumerate(res.rounds):
            log.log(r, clock=res.clock[i], train_loss=res.train_loss[i],
                    test_acc=res.test_acc[i], test_loss=res.test_loss[i])
        log.close()
    return spec, res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["edge", "spmd"], default="edge")
    ap.add_argument("--arch", default="vgg9-cifar-small")
    ap.add_argument("--policy", default="hasfl")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--agg-interval", type=int, default=15, dest="agg_interval")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10, dest="eval_every")
    ap.add_argument("--engine", default="scan",
                    choices=["legacy", "vectorized", "scan"],
                    help="edge-simulator round engine (DESIGN.md §8; the "
                         "port runs scan only)")
    ap.add_argument("--scenario", default=None,
                    help="time-varying edge scenario preset (edge mode; "
                         "see repro_torch.scenarios.list_presets)")
    ap.add_argument("--scenario-seed", type=int, default=7,
                    dest="scenario_seed")
    ap.add_argument("--no-estimate", action="store_true", dest="no_estimate",
                    help="edge mode: skip the HASFL controller's online "
                         "G²/σ² estimation (priors only)")
    ap.add_argument("--n-train", type=int, default=2000, dest="n_train")
    ap.add_argument("--n-test", type=int, default=400, dest="n_test")
    ap.add_argument("--csv", default=None)
    # spmd extras (parsed so the reference's command lines parse; spmd
    # mode itself raises)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256, dest="d_model")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--grad-accum", type=int, default=1, dest="grad_accum")
    ap.add_argument("--reduce", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    """Parse ``argv`` (None: the command line) and run; returns edge
    mode's (spec, `SimResult`)."""
    args = parser().parse_args(argv)
    if args.mode == "spmd":
        raise NotImplementedError(
            "--mode spmd (token-model training) is not ported yet; see "
            "ROADMAP.md §1 item 7")
    if args.engine != "scan":
        raise NotImplementedError(
            f"--engine {args.engine} is not ported yet (the port runs the "
            f"scan engine's semantics); see ROADMAP.md §1")
    return run_edge(args)


if __name__ == "__main__":
    main()
