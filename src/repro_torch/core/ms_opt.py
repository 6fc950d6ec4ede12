"""Model-splitting sub-problem (P2) — Dinkelbach on the linear-fractional
objective with an exact-per-L_c inner combinatorial solver.

With b fixed, Theta(mu) = Num(mu) / Den(mu) where

    Num = T3 + T_s^F + T_s^B + T4 + (T5 + T6)/I      (latency per round)
    Den = gamma/(2 theta) * (eps - sum_i B/b_i - drift(L_c))

Dinkelbach iterates  mu <- argmin Num(mu) - lam*Den(mu);  lam <- Num/Den.
Because Den depends on mu only through L_c = max_i cut_i, the parametric
problem decomposes: enumerate L_c (<= L values); given L_c the Den term is
constant, so the inner problem is   min_{cut_i <= L_c} Num(mu)  — a
min-of-(sums + maxima) solved by coordinate descent over clients on
precomputed [N, L] latency tables (exact per sweep for the sum terms;
converges in a few sweeps for the max terms).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.config import DeviceProfile, SFLConfig
from repro_torch.core.profiles import LayerProfile
from repro_torch.core.convergence import ConvergenceModel
from repro_torch.trace import count


@dataclass
class MSProblem:
    profile: LayerProfile
    devices: Sequence[DeviceProfile]
    sfl: SFLConfig
    conv: ConvergenceModel
    b: np.ndarray                      # fixed batch sizes [N]
    eps: Optional[float] = None

    def __post_init__(self):
        from repro_torch.core.latency import BW_FLOOR, FLOPS_FLOOR
        p, devs = self.profile, self.devices
        n, l = len(devs), p.n_layers
        b = np.asarray(self.b, float)
        # same outage floors as LatencyModel: a zero-resource device
        # (scenario trace) yields finite-but-huge table entries, so the
        # solver steers its cut shallow instead of degenerating to the
        # infeasibility fallback
        f = np.maximum([d.flops for d in devs], FLOPS_FLOOR)[:, None]
        r_up = np.maximum([d.up_bw for d in devs], BW_FLOOR)[:, None]
        r_down = np.maximum([d.down_bw for d in devs], BW_FLOOR)[:, None]
        rf_up = np.maximum([d.fed_up_bw for d in devs], BW_FLOOR)[:, None]
        rf_down = np.maximum([d.fed_down_bw for d in devs], BW_FLOOR)[:, None]
        bb = b[:, None]
        # [N, L] tables over candidate cuts
        self.t3 = bb * (p.rho[None, :] / f + p.psi[None, :] / r_up)
        self.t4 = bb * (p.chi[None, :] / r_down + p.bwd[None, :] / f)
        self.srv = (
            bb
            * ((p.rho[-1] - p.rho)[None, :] + (p.bwd[-1] - p.bwd)[None, :])
            / self.sfl.server_flops
        )
        self.tc_up = np.broadcast_to(p.delta[None, :], (n, l)) / rf_up
        self.tc_down = np.broadcast_to(p.delta[None, :], (n, l)) / rf_down
        self.delta = p.delta
        # memory feasibility per (device, cut) given b (constraint C4)
        psi_cum, chi_cum = np.cumsum(p.psi), np.cumsum(p.chi)
        mem_need = (
            bb * (psi_cum + chi_cum)[None, :]
            + (p.delta * (1 + self.sfl.optimizer_state_mult))[None, :]
        )
        mem_cap = np.array([d.memory for d in devs])[:, None]
        self.mem_ok = mem_need < mem_cap

    # ------------------------------------------------------------------
    def num(self, cuts: np.ndarray) -> float:
        """Per-round latency Num(mu); cuts are 1-based."""
        j = np.asarray(cuts, int) - 1
        idx = np.arange(len(j))
        t3 = float(np.max(self.t3[idx, j]))
        t4 = float(np.max(self.t4[idx, j]))
        srv = float(np.sum(self.srv[idx, j]))
        d = self.delta[j]
        lam_s = len(j) * float(np.max(d)) - float(np.sum(d))
        t5 = max(float(np.max(self.tc_up[idx, j])), lam_s / self.sfl.server_fed_bw)
        t6 = max(float(np.max(self.tc_down[idx, j])), lam_s / self.sfl.server_fed_bw)
        return t3 + srv + t4 + (t5 + t6) / self.sfl.agg_interval

    def den(self, cuts: np.ndarray) -> float:
        l_c = int(np.max(cuts))
        a = self.conv.denominator(self.b, l_c, self.eps)
        return self.sfl.lr * a / (2 * self.conv.theta_gap)

    def theta(self, cuts: np.ndarray) -> float:
        d = self.den(cuts)
        if d <= 0:
            return float("inf")
        return self.num(cuts) / d

    # ------------------------------------------------------------------
    def _inner_min_num(self, l_c: int, sweeps: int = 4) -> np.ndarray:
        """min Num over cuts <= l_c by coordinate descent on the tables."""
        n = len(self.devices)
        # init: each client minimizes its own separable proxy
        proxy = self.t3[:, :l_c] + self.t4[:, :l_c] + self.srv[:, :l_c]
        proxy = np.where(self.mem_ok[:, :l_c], proxy, np.inf)
        cuts = np.argmin(proxy, axis=1) + 1
        if not np.all(np.isfinite(np.min(proxy, axis=1))):
            return None  # memory-infeasible at this l_c for some device
        best = self.num(cuts)
        for _ in range(sweeps):
            improved = False
            for i in range(n):
                old = cuts[i]
                vals = np.full(l_c, np.inf)
                for c in range(1, l_c + 1):
                    if not self.mem_ok[i, c - 1]:
                        continue
                    cuts[i] = c
                    vals[c - 1] = self.num(cuts)
                c_best = int(np.argmin(vals)) + 1
                if vals[c_best - 1] < best - 1e-15:
                    cuts[i] = c_best
                    best = vals[c_best - 1]
                    improved = improved or (c_best != old)
                else:
                    cuts[i] = old
            if not improved:
                break
        return cuts

    def solve(
        self, max_dinkelbach: int = 20, tol: float = 1e-9,
        cuts0: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Dinkelbach outer loop; exact enumeration of L_c inside.

        ``cuts0`` warm-starts lambda at Num/Den of the previous decision
        (any feasible point is a valid Dinkelbach initializer): when the
        environment moved only a little since the last solve — the online
        reconfiguration case — the first parametric step already lands at
        the optimum and the loop exits after one confirmation iteration.
        """
        l = self.profile.n_layers
        lam = None
        best_cuts, best_theta = None, float("inf")
        if cuts0 is not None:
            cuts0 = np.asarray(cuts0, int)
            mem_ok = bool(np.all(self.mem_ok[np.arange(len(cuts0)), cuts0 - 1]))
            if mem_ok and self.den(cuts0) > 0:
                best_cuts, best_theta = cuts0.copy(), self.theta(cuts0)
                lam = self.num(cuts0) / self.den(cuts0)
        for _ in range(max_dinkelbach):
            count("dinkelbach_iterations", 1)
            # parametric step: minimize Num - lam*Den over (cuts, L_c)
            cand_best, cand_val = None, float("inf")
            for l_c in range(1, l + 1):
                cuts = self._inner_min_num(l_c)
                if cuts is None:
                    continue
                d = self.den(cuts)
                if d <= 0:
                    continue
                v = self.num(cuts) - (lam if lam is not None else 0.0) * d
                if v < cand_val:
                    cand_best, cand_val = cuts.copy(), v
            if cand_best is None:
                # Convergence-infeasible at the current b (denominator <= 0
                # for every L_c): fall back to the latency-myopic memory-
                # feasible cuts so the BCD outer loop can keep iterating
                # (the BS step will raise b and restore feasibility).
                proxy = self.t3 + self.t4 + self.srv
                proxy = np.where(self.mem_ok, proxy, np.inf)
                if not np.all(np.isfinite(np.min(proxy, axis=1))):
                    raise RuntimeError(
                        "MS sub-problem infeasible: no memory-feasible cut")
                return np.argmin(proxy, axis=1) + 1
            th = self.theta(cand_best)
            if th < best_theta:
                best_cuts, best_theta = cand_best.copy(), th
            new_lam = self.num(cand_best) / self.den(cand_best)
            if lam is not None and abs(new_lam - lam) <= tol * max(1.0, abs(lam)):
                break
            lam = new_lam
        return best_cuts
