"""Benchmark policies from Section VII, plus the fixed classics.

- RBS : random batch size in [1, 64] per device per (re)configuration
- RMS : random cut layer per device
- RHAMS : resource-heterogeneity-aware MS heuristic [55] (CoopFL-style) —
  picks each device's cut to balance its compute+comm time against the
  server, with NO convergence-awareness.
- HABS / HAMS : the paper's heterogeneity-aware BS / MS (Section VI),
  exposed by running one sub-problem of the BCD with the other variable
  fixed to the benchmark policy.
- FIXED / FIXED-BS / FIXED-MS : the non-adaptive classics the scenario
  sweeps compare against (cf. MergeSFL's fixed-BS and AdaptSFL's
  fixed-split ablations): ``fixed`` keeps a uniform (b, cut) forever;
  ``fixed-bs`` keeps b uniform but re-optimizes the cuts (HAMS);
  ``fixed-ms`` keeps the cut uniform but re-optimizes batch sizes
  (HABS).  Driven through a time-varying scenario they quantify exactly
  what closing each half of the control loop buys.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bcd import HASFLOptimizer
from repro_torch.core.latency import BW_FLOOR, FLOPS_FLOOR
from repro_torch.core.ms_opt import MSProblem

# uniform defaults for the fixed policies (paper-scale: b=16 is the BCD
# initializer; the cut sits at the first quarter like the BCD's start)
FIXED_B = 16

# Canonical policy names `policy()` dispatches on — the single source the
# `repro.api.policies` registry is built from (its completeness test
# asserts registry == this list, so adding a branch to `policy()` without
# registering it is caught in tier-1).
POLICY_NAMES = (
    "hasfl",
    "rbs+hams",
    "habs+rms",
    "rbs+rms",
    "rbs+rhams",
    "fixed",
    "fixed-bs",
    "fixed-ms",
)


def fixed_cut(n_layers: int) -> int:
    return max(1, n_layers // 4)


def rbs(n: int, rng: np.random.Generator, max_batch: int = 64) -> np.ndarray:
    return rng.integers(1, max_batch + 1, n)


def rms(n: int, n_layers: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(1, n_layers + 1, n)


def rhams(opt: HASFLOptimizer, b: np.ndarray) -> np.ndarray:
    """Heuristic MS: per-device cut minimizing its own round time, ignoring
    convergence (the [55] comparison point)."""
    p = opt.profile
    n = len(opt.devices)
    cuts = np.zeros(n, int)
    for i, dev in enumerate(opt.devices):
        f = max(dev.flops, FLOPS_FLOOR)
        up = max(dev.up_bw, BW_FLOOR)
        down = max(dev.down_bw, BW_FLOOR)
        t_client = b[i] * (p.rho + p.bwd) / f
        t_comm = b[i] * (p.psi / up + p.chi / down)
        t_server = (
            b[i] * ((p.rho[-1] - p.rho) + (p.bwd[-1] - p.bwd))
            / opt.sfl.server_flops
        )
        cuts[i] = int(np.argmin(t_client + t_comm + t_server)) + 1
    return cuts


def habs(opt: HASFLOptimizer, cuts: np.ndarray, b0=None) -> np.ndarray:
    """Heterogeneity-aware BS only (our Proposition 1, cuts fixed)."""
    from repro_torch.core.bs_opt import solve_bs
    b_ref = np.asarray(b0 if b0 is not None else np.full(len(opt.devices), 16), float)
    prob = opt._bs_problem(np.asarray(cuts, int), b_ref)
    return solve_bs(prob, b0=b_ref)


def hams(opt: HASFLOptimizer, b: np.ndarray) -> np.ndarray:
    """Heterogeneity-aware MS only (our Dinkelbach, b fixed)."""
    ms = MSProblem(opt.profile, opt.devices, opt.sfl, opt.conv, np.asarray(b, float))
    return ms.solve()


def policy(name: str, opt: HASFLOptimizer, rng: np.random.Generator,
           *, b=None, cut=None):
    """Returns (b, cuts) for one reconfiguration event.

    ``b``/``cut`` override the FIXED_B / ``fixed_cut`` defaults of the
    non-adaptive half of the fixed policies — this is how parameterized
    spec policies like ``"fixed(b=8,cut=4)"`` (the figure scripts'
    ablation axes) reach the dispatch; the fully adaptive/random
    policies take no overrides and reject them rather than silently
    ignoring a typo'd knob.
    """
    n = len(opt.devices)
    l = opt.profile.n_layers
    name = name.lower()
    if name not in ("fixed", "fixed-bs", "fixed-ms") and not (
        b is None and cut is None
    ):
        raise ValueError(
            f"policy {name!r} takes no b=/cut= overrides (only the "
            "fixed/fixed-bs/fixed-ms classics do)"
        )
    if name == "hasfl":
        d = opt.solve()
        return d.b, d.cuts
    if name == "rbs+hams":
        b = rbs(n, rng, opt.sfl.max_batch)
        return b, hams(opt, b)
    if name == "habs+rms":
        cuts = rms(n, l, rng)
        return habs(opt, cuts), cuts
    if name == "rbs+rms":
        return rbs(n, rng, opt.sfl.max_batch), rms(n, l, rng)
    if name == "rbs+rhams":
        b = rbs(n, rng, opt.sfl.max_batch)
        return b, rhams(opt, b)
    ub = FIXED_B if b is None else int(b)
    ucut = fixed_cut(l) if cut is None else int(cut)
    if name == "fixed":
        return np.full(n, ub), np.full(n, ucut)
    if name == "fixed-bs":
        if cut is not None:
            raise ValueError("fixed-bs re-optimizes the cuts (HAMS); "
                             "only b= can be pinned")
        bs = np.full(n, ub)
        return bs, hams(opt, bs)
    if name == "fixed-ms":
        if b is not None:
            raise ValueError("fixed-ms re-optimizes the batch sizes "
                             "(HABS); only cut= can be pinned")
        cuts = np.full(n, ucut)
        return habs(opt, cuts), cuts
    raise ValueError(f"unknown policy {name!r}")
