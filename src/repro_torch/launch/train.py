"""Training launcher (port of `repro.launch.train`).

Two modes, with the reference's flags and defaults, plus ``--device``
(default: the CUDA card, raising without one; ``cpu`` runs the plain
PyTorch paths):

- ``edge`` runs the paper-faithful HASFL edge simulation (N heterogeneous
  clients, BS+MS controller, latency model) through
  `repro_torch.api.Session`.  With ``--csv`` it writes one row per eval
  and the spec beside it (``<csv>.spec.json``), so the run is replayable.
- ``spmd`` runs the HASFL SPMD step (`core.sfl.make_hasfl_train_step`:
  client-stacked prefix + server tier, Adam) on a token model, on one
  device.  As in the reference, ``--reduce`` cannot be turned off (the
  model is cut to ``--layers``/``--d-model``/``--vocab``), the default
  arch ``vgg9-cifar-small`` maps to ``smollm-135m``, and the batch holds
  tokens and labels only: whisper, whose loss needs the frames, raises
  the reference's ``KeyError('frame_embeddings')``.

``--engine`` picks the edge simulator's round engine, as in the
reference: ``scan`` (the default), ``vectorized`` or ``legacy``.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --mode edge --arch vgg9-cifar-small --rounds 100
    PYTHONPATH=src python -m repro_torch.launch.train --mode edge --device cpu --clients 4 --rounds 12 --scenario straggler-bursts
    PYTHONPATH=src python -m repro_torch.launch.train --mode edge --device cpu --clients 4 --rounds 12 --engine legacy
    PYTHONPATH=src python -m repro_torch.launch.train --mode spmd --device cpu --steps 6 --seq 32 --layers 2 --d-model 64 --clients 2 --batch 2 --eval-every 2
"""
from __future__ import annotations

import argparse
import os
import time


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


def spmd_config(args):
    """The model configuration of an spmd-mode command line: the
    reference's cut of ``--arch`` (``--reduce`` is always on)."""
    from repro_torch.config import get_config, reduced

    return reduced(get_config(args.arch), n_layers=args.layers,
                   d_model=args.d_model,
                   n_heads=max(2, args.d_model // 64),
                   n_kv_heads=max(1, args.d_model // 128),
                   d_ff=args.d_model * 4, vocab_size=args.vocab,
                   head_dim=0) if args.reduce else get_config(args.arch)


def run_spmd(args):
    """Train with the SPMD HASFL step on synthetic LM data; returns the
    `MetricLogger`'s rows (step, loss, steps_per_s)."""
    import torch

    from repro_torch.core.sfl import make_hasfl_train_step
    from repro_torch.data import make_lm_data
    from repro_torch.device import disable_tf32, resolve
    from repro_torch.models import build_model
    from repro_torch.training.metrics import MetricLogger

    cfg = spmd_config(args)
    device = resolve(args.device)
    if device.type == "cuda":
        disable_tf32()
    model = build_model(cfg)
    n, b, s = args.clients, args.batch, args.seq
    init_state, train_step = make_hasfl_train_step(
        model, n_clients=n, cut_reps=max(1, args.layers // 4),
        agg_interval=args.agg_interval, optimizer_name="adam", lr=args.lr,
        grad_accum=args.grad_accum, remat=False)
    state = init_state(torch.Generator().manual_seed(args.seed), device)
    tokens, labels = make_lm_data(cfg.vocab_size, n * b * 64, s,
                                  seed=args.seed)
    tokens = torch.as_tensor(tokens.reshape(-1, n, b, s)).to(device)
    labels = torch.as_tensor(labels.reshape(-1, n, b, s)).to(device)
    log = MetricLogger(args.csv, print_every=args.eval_every)
    t0 = time.time()
    for t in range(args.steps):
        i = t % tokens.shape[0]
        state, m = train_step(state, {"tokens": tokens[i],
                                      "labels": labels[i]})
        log.log(t + 1, loss=float(m["loss"]),
                steps_per_s=(t + 1) / (time.time() - t0))
    log.close()
    return log.rows


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
                    help="edge-simulator round engine (DESIGN.md §8)")
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
    # spmd extras
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
    mode's (spec, `SimResult`) or spmd mode's logged rows."""
    args = parser().parse_args(argv)
    if args.mode == "spmd":
        if args.arch == "vgg9-cifar-small":
            args.arch = "smollm-135m"
        return run_spmd(args)
    return run_edge(args)


if __name__ == "__main__":
    main()
