"""A cell of the benchmark, found by name, and its first rounds.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, ``configs/<config>.json`` (the model's sizes, its source
and its plain reference, ``reference/<reference>.py``: see
`reference.contract`), and a traffic mix, ``traffic/<traffic>.json``
(the cohort, the data, the policy and the SFL settings of the run); the
limits of its output check are in ``workloads/<cell>.json``.  `build`
assembles the program's `Session` from them with the initial units the
benchmark made; `FirstRounds` records the program's readings of the run's
first rounds, through the first Eq. 7 round (`checked_rounds`),
`reference.rounds.first_rounds` works out the reference's, and `compare`
and `verdict` hold the two against the cell's limits.  The losses and the
change are compared over the first `EARLY` rounds, before training
amplifies round-off (the reference run twice on the card already differs
from itself in later rounds' losses); the change at the Eq. 7 round is
compared on its own.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from simbench.reference import contract
from simbench.reference import params as RP
from simbench.reference.hasfl.config import SFLConfig
from simbench.reference.host import check_traffic
from simbench.reference.rounds import EARLY

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CHECKS = ("decision_mismatch", "draw_mismatch", "loss1_gap", "loss_gap",
          "grad1_gap", "delta_gap", "agg_delta_gap")


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    check: dict            # workloads/<cell>.json
    config_path: Path      # the configuration's file
    ref: object            # its reference module (`reference.contract`)

    @property
    def arch(self):
        """The configuration's ``model`` as its reference module's
        architecture (a key the module does not read raises)."""
        try:
            return self.ref.make_arch(self.config["model"])
        except (TypeError, ValueError) as e:
            raise ValueError(f"{self.config_path}: {e}") from None


def find_cell(bench: dict, name: str, root: Path = None) -> Cell:
    """The cell ``name`` of ``bench``, its files found under ``root``
    (by default the checkout's) by the names in its entry, and its
    configuration's sizes read by the configuration's reference module."""
    root = ROOT if root is None else root
    for w in bench["workloads"]:
        if w["name"] == name:
            path = root / "simbench" / "configs" / f"{w['config']}.json"
            config = _json(path)
            if "reference" not in config:
                raise KeyError(f"{path} names no \"reference\" module")
            try:
                ref = contract.load(config["reference"],
                                    root / "simbench" / "reference")
            except (FileNotFoundError, ValueError) as e:
                raise type(e)(f"{path}: {e}") from None
            cell = Cell(
                name=name, chips=int(w["chips"]), config=config,
                traffic=_json(root / "simbench" / "traffic"
                              / f"{w['traffic']}.json"),
                check=_json(root / "simbench" / "workloads" / f"{name}.json"),
                config_path=path, ref=ref)
            cell.arch           # a model key the module does not read raises
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def checked_rounds(traffic: dict) -> int:
    """The rounds the reference follows: the run's first ``agg_interval``,
    so the last of them is the first Eq. 7 round (client-specific units
    averaged over the clients)."""
    return int(SFLConfig(n_devices=traffic["n_clients"],
                         **traffic["sfl"]).agg_interval)


def early_rounds(rounds: int) -> int:
    """The rounds whose losses and change are compared."""
    return min(EARLY, rounds)


def spec_for(cell: Cell, seed: int, rounds: int):
    """The program's `ExperimentSpec` of one run of ``cell``: every key of
    the traffic file is a spec field (an unknown key raises), and only
    those the reference models are allowed (`check_traffic`)."""
    from repro_torch.api import ExperimentSpec

    check_traffic(cell.traffic)
    return ExperimentSpec.from_dict(dict(
        cell.traffic, arch=cell.config["arch_id"], seed=int(seed),
        rounds=rounds))


def check_sizes(cell: Cell) -> None:
    """Raise unless the program's registered architecture has the
    configuration file's sizes (the file holds the configuration as run)."""
    from repro_torch.config import get_config

    prog = get_config(cell.config["arch_id"])
    for k, v in cell.config["model"].items():
        have = getattr(prog, k)
        if (tuple(v) if isinstance(v, list) else v) != have:
            raise ValueError(f"{cell.config['arch_id']}: {k} is {have!r} in "
                             f"the program, {v!r} in the configuration")


def build(cell: Cell, seed: int, rounds: int, device=None):
    """(session, initial units): the program's `Session` for one run, its
    stacked parameters overwritten with units drawn from ``seed`` on the
    session's device."""
    import torch
    from repro_torch.api import Session
    from repro_torch.utils.tree import tree_leaves

    sess = Session(spec_for(cell, seed, rounds), device=device)
    units0 = RP.make_units(cell.ref, cell.arch, seed, sess.device)
    prog = tree_leaves(sess.sim._stacked)
    mine = RP.leaves(units0)
    if len(prog) != len(mine):
        raise ValueError(f"{len(prog)} program leaves, {len(mine)} made")
    with torch.no_grad():
        for p, m in zip(prog, mine):
            if tuple(p.shape[1:]) != tuple(m.shape) or p.dtype != m.dtype:
                raise ValueError(f"leaf {tuple(p.shape)} {p.dtype} against "
                                 f"{tuple(m.shape)} {m.dtype}")
            p.copy_(m.expand_as(p))
    return sess, units0


class FirstRounds:
    """Records the program's first ``rounds`` rounds from inside its own
    run: the segment function's plans and losses (wrap it with `segment`)
    and, at each round's boundary (`boundary`, the run's ``snapshot_cb``),
    the per-leaf norms the reference also reads.  The run that records
    goes one round further, so that a reconfiguration due at round
    ``rounds`` happens inside it; its state after that round is where the
    run resumes."""

    def __init__(self, sim, units0, lr: float, rounds: int):
        self.sim = sim
        self.p0 = RP.leaves(units0)
        self.lr = lr
        self.rounds = rounds
        self.draws, self.losses = [], []
        self.grad1 = self.delta = self.agg_delta = None
        self.state = None

    def segment(self, t0, idx, row_mask, losses):
        if len(self.losses) < self.rounds:
            counts = np.asarray(row_mask).sum(axis=1).astype(int)
            for r in range(idx.shape[0]):
                self.draws.append([np.asarray(idx[r, i, :c])
                                   for i, c in enumerate(counts)])
                self.losses.append(losses[r].float().cpu().numpy())

    def boundary(self, t, clock, b, cuts, res):
        from repro_torch.utils.tree import tree_leaves

        now = tree_leaves(self.sim._stacked)
        if t == 1:
            self.grad1 = _stack_norms(self.p0, now, 1 / self.lr)
        if t == early_rounds(self.rounds):
            self.delta = _stack_norms(self.p0, now, 1.0)
        if t == self.rounds:
            self.agg_delta = _stack_norms(self.p0, now, 1.0)
        if t == self.rounds + 1:
            self.state = {"t": t, "clock": clock, "b": np.asarray(b),
                          "cuts": np.asarray(cuts), "res": res}


def _stack_norms(p0, stacked, factor: float) -> np.ndarray:
    """Per leaf, ``factor · ‖p0 − s_i‖`` over the clients i of the
    stacked leaf, in fp64, one client at a time."""
    import torch

    with torch.no_grad():
        return np.asarray([factor * math.sqrt(sum(
            float(torch.sum(torch.square(s[i].double() - a.double())))
            for i in range(s.shape[0]))) for a, s in zip(p0, stacked)])


def program_readings(rec: FirstRounds, decision) -> dict:
    return {"b": np.asarray(decision[0]), "cuts": np.asarray(decision[1]),
            "draws": rec.draws[:rec.rounds],
            "losses": np.asarray(rec.losses[:rec.rounds]),
            "grad1": rec.grad1, "delta": rec.delta,
            "agg_delta": rec.agg_delta}


def compare(prog: dict, ref: dict, names=None) -> dict:
    """The numbers compared, each worst over clients, rounds or leaves:
    decisions and draws that differ (counts; the draws of every checked
    round), the relative gap of the first round's per-client loss (from
    the same units on the same batch: the forward alone) and of every
    early round's, and for the first gradient, the change after the early
    rounds and the change after the Eq. 7 round the gap between the two
    sides' norms of a leaf against the reference's norm of that leaf or of
    the median leaf, whichever is larger, over the leaves whose reference
    gradient is not nought to rounding (at least a thousandth of the
    median leaf's)."""
    dec = int(np.sum(np.asarray(prog["b"]) != np.asarray(ref["b"]))
              + np.sum(np.asarray(prog["cuts"]) != np.asarray(ref["cuts"])))
    draws = sum(int(len(a) != len(b) or not np.array_equal(a, b))
                for pr, rr in zip(prog["draws"], ref["draws"])
                for a, b in zip(pr, rr))
    lp, lr = np.asarray(prog["losses"], float), np.asarray(ref["losses"], float)
    rel = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-12)
    rel_early = rel[:early_rounds(len(rel))]
    g_ref = np.asarray(ref["grad1"])
    keep = g_ref >= 1e-3 * float(np.median(g_ref))

    def gaps(a, b):
        a, b = np.asarray(a), np.asarray(b)
        den = np.maximum(b, float(np.median(b)))
        return np.where(keep, np.abs(a - b) / den, 0.0)

    g1 = gaps(prog["grad1"], g_ref)
    d3 = gaps(prog["delta"], ref["delta"])
    dagg = gaps(prog["agg_delta"], ref["agg_delta"])
    out = {"decision_mismatch": dec, "draw_mismatch": draws,
           "loss1_gap": float(rel[0].max()),
           "loss_gap": float(rel_early.max()),
           "grad1_gap": float(g1.max()),
           "delta_gap": float(d3.max()),
           "agg_delta_gap": float(dagg.max()),
           "leaves_left_out": int(np.sum(~keep))}
    if names is not None:
        out["grad1_worst"] = names[int(g1.argmax())]
        out["delta_worst"] = names[int(d3.argmax())]
        out["agg_delta_worst"] = names[int(dagg.argmax())]
        out["agg_delta_median_gap"] = float(np.median(dagg[keep]))
    return out


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]) over the cell's limits."""
    missing = [k for k in CHECKS if k not in limits]
    if missing:
        raise KeyError(f"no limit for {missing}")
    rows = [[k, readings[k], limits[k]] for k in CHECKS]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
