"""Algorithm 2 — BCD over the BS and MS sub-problems.

Alternates Proposition-1 batch-size solving and Dinkelbach model-splitting
until the objective Theta stops improving.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.config import DeviceProfile, SFLConfig
from repro_torch.core.profiles import LayerProfile
from repro_torch.core.convergence import ConvergenceModel
from repro_torch.core.latency import LatencyModel
from repro_torch.core.bs_opt import BSProblem, solve_bs
from repro_torch.core.ms_opt import MSProblem
from repro_torch.trace import count, span


@dataclass
class HASFLDecision:
    b: np.ndarray            # batch sizes [N]
    cuts: np.ndarray         # 1-based cut layers [N]
    theta: float             # objective value (estimated total latency)
    rounds: float            # Corollary-1 round count
    t_split: float
    t_agg: float
    history: list            # Theta per BCD iteration


class HASFLOptimizer:
    """Joint heterogeneity-aware BS + MS controller (the paper's core)."""

    def __init__(
        self, profile: LayerProfile, devices: Sequence[DeviceProfile],
        sfl: SFLConfig, conv: Optional[ConvergenceModel] = None
    ):
        self.profile = profile
        self.sfl = sfl
        self.conv = conv or ConvergenceModel(profile, sfl)
        self.lat = LatencyModel(profile, devices, sfl)
        self.devices = self.lat.devices

    def set_devices(self, devices: Sequence[DeviceProfile]) -> None:
        """Re-point the reused optimizer at the current device pool.

        The online control loop (`repro.scenarios.controller`) calls this
        at every reconfiguration boundary instead of rebuilding the
        optimizer, then warm-starts `solve` from the previous decision.
        """
        self.lat.set_devices(devices)
        self.devices = self.lat.devices

    # ------------------------------------------------------------------
    def _bs_problem(self, cuts: np.ndarray, b_ref: np.ndarray) -> BSProblem:
        p, sfl = self.profile, self.sfl
        n = len(self.devices)
        j = np.asarray(cuts, int) - 1
        l_c = int(np.max(cuts))
        a = self.conv.denominator(np.full(n, 1e9), l_c)   # eps - drift only
        b_const = (self.conv.beta * sfl.lr * p.sigma_sq_total() / n ** 2)
        c = ((p.rho[-1] - p.rho[j]) + (p.bwd[-1] - p.bwd[j])) / sfl.server_flops
        rl = self.lat.round_latency(b_ref, cuts)
        t3 = float(np.max(rl.t_f + rl.t_a_up))
        t4 = float(np.max(rl.t_g_down + rl.t_b))
        t5 = max(float(np.max(rl.t_c_up)), rl.t_s_up)
        t6 = max(float(np.max(rl.t_c_down)), rl.t_s_down)
        d = t3 + t4 + (t5 + t6) / sfl.agg_interval
        # caps kappa_i (memory C4 + straggler caps R3/R4); the floored
        # arrays keep the caps finite when a scenario trace drives a
        # device's resources to zero (the cap then collapses to b_i = 1)
        f = self.lat._f
        r_up = self.lat._r_up
        r_down = self.lat._r_down
        mem = np.array([dv.memory for dv in self.devices])
        psi_cum, chi_cum = np.cumsum(p.psi), np.cumsum(p.chi)
        opt_bits = p.delta[j] * (1 + sfl.optimizer_state_mult)
        kap_mem = (mem - opt_bits) / np.maximum(psi_cum[j] + chi_cum[j], 1e-30)
        kap_t3 = t3 / np.maximum(p.rho[j] / f + p.psi[j] / r_up, 1e-30)
        kap_t4 = t4 / np.maximum(p.chi[j] / r_down + p.bwd[j] / f, 1e-30)
        kappa = np.minimum(
            np.minimum(kap_mem, kap_t3),
            np.minimum(kap_t4, float(sfl.max_batch))
        )
        return BSProblem(
            a=a, b_const=b_const, c=c, d=d, kappa=kappa,
            theta_gap=self.conv.theta_gap, gamma=sfl.lr
        )

    def theta(self, b: np.ndarray, cuts: np.ndarray) -> float:
        l_c = int(np.max(cuts))
        return self.conv.theta_objective(self.lat.per_round_effective(b, cuts), b, l_c)

    # ------------------------------------------------------------------
    def solve(
        self, b0=None, cuts0=None, max_iter: int = 10,
        tol: float = 1e-6
    ) -> HASFLDecision:
        n, l = len(self.devices), self.profile.n_layers
        b = np.asarray(b0 if b0 is not None else np.full(n, 16), int)
        cuts = np.asarray(
            cuts0 if cuts0 is not None
            else np.full(n, max(1, l // 4)), int
        )
        history = [self.theta(b, cuts)]
        for _ in range(max_iter):
            # --- BS step (Proposition 1) --------------------------------
            with span("policy.solve.bs"):
                prob = self._bs_problem(cuts, b)
                b_new = solve_bs(prob, b0=np.asarray(b, float))
                # accept if it improves; also accept while infeasible
                # (inf->inf) so the caps can grow across iterations.
                if self.theta(b_new, cuts) <= history[-1] \
                        or not np.isfinite(history[-1]):
                    b = b_new
            # --- MS step (Dinkelbach, warm-started from current cuts) ---
            with span("policy.solve.ms"):
                ms = MSProblem(
                    self.profile, self.devices, self.sfl, self.conv,
                    np.asarray(b, float)
                )
                cuts_new = ms.solve(cuts0=np.asarray(cuts, int))
                if self.theta(b, cuts_new) <= self.theta(b, cuts):
                    cuts = cuts_new
            history.append(self.theta(b, cuts))
            if abs(history[-2] - history[-1]) <= tol * max(1.0, history[-2]):
                break
        count("bcd_iterations", len(history) - 1)
        rl = self.lat.round_latency(b, cuts)
        l_c = int(np.max(cuts))
        return HASFLDecision(
            b=np.asarray(b, int), cuts=np.asarray(cuts, int),
            theta=history[-1],
            rounds=self.conv.rounds_needed(b, l_c),
            t_split=rl.t_split, t_agg=rl.t_agg, history=history)
