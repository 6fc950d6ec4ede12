"""Convergence analysis of HASFL — Theorem 1 and Corollary 1.

Bound (16):

    (1/R) sum_t E||grad f(w^{t-1})||^2
      <= 2*theta/(gamma*R)
         + beta*gamma * sum_i sum_{j<=L} sigma_j^2 / b_i / N^2
         + 1{I>1} * 4 beta^2 gamma^2 I^2 * sum_{j<=L_c} G_j^2

Corollary 1 (27):  R >= 2*theta / (gamma * (eps - variance - drift)).

The BCD objective (43):  Theta(b, mu) = 2*theta*(T_S + T_A/I) / (gamma*A(b, mu))
with A = eps - variance(b) - drift(L_c).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import SFLConfig
from .profiles import LayerProfile


@dataclass
class ConvergenceModel:
    profile: LayerProfile
    sfl: SFLConfig
    beta: float = None          # smoothness (Assumption 1)
    theta_gap: float = None     # f(w0) - f*

    def __post_init__(self):
        if self.beta is None:
            self.beta = self.sfl.beta
        if self.theta_gap is None:
            self.theta_gap = self.sfl.theta_gap

    # -- bound terms --------------------------------------------------------
    def variance_term(self, b: np.ndarray) -> float:
        """beta*gamma*sum_i(sum_j sigma_j^2 / b_i) / N^2."""
        g = self.sfl.lr
        n = len(b)
        sig_total = self.profile.sigma_sq_total()
        inv_b = float(np.sum(1.0 / np.asarray(b, float)))
        return self.beta * g * sig_total * inv_b / n ** 2

    def drift_term(self, l_c: int) -> float:
        """1{I>1} * 4 beta^2 gamma^2 I^2 * sum_{j<=L_c} G_j^2."""
        i = self.sfl.agg_interval
        if i <= 1:
            return 0.0
        g = self.sfl.lr
        g_cum = self.profile.g_sq_cum()
        return 4 * self.beta ** 2 * g ** 2 * i ** 2 * float(g_cum[l_c - 1])

    def denominator(
        self, b: np.ndarray, l_c: int,
        eps: Optional[float] = None
    ) -> float:
        """A(b, mu) = eps - variance - drift (must be > 0 for feasibility)."""
        eps = self.sfl.epsilon if eps is None else eps
        return eps - self.variance_term(b) - self.drift_term(l_c)

    def rounds_needed(
        self, b: np.ndarray, l_c: int,
        eps: Optional[float] = None
    ) -> float:
        """Corollary 1: minimum R to reach eps (inf if infeasible)."""
        g = self.sfl.lr
        a = self.denominator(b, l_c, eps)
        if a <= 0:
            return float("inf")
        return 2 * self.theta_gap / (g * a)

    def theta_objective(
        self, per_round_latency: float, b: np.ndarray,
        l_c: int, eps: Optional[float] = None
    ) -> float:
        """Eqn (43): total-latency objective of the BCD problem."""
        r = self.rounds_needed(b, l_c, eps)
        return r * per_round_latency


# ---------------------------------------------------------------------------
# Online estimation of (beta, sigma_j^2, G_j^2) — Wang et al. [24] style
# ---------------------------------------------------------------------------

def estimate_constants(grad_samples: list, param_deltas=None, grad_deltas=None) -> dict:
    """Estimate Assumption-1/2 constants from per-layer gradient samples.

    grad_samples: list over minibatches of lists over layers of flat grads
                  (np arrays).  Returns dict with per-layer sigma_sq, g_sq
                  and (if deltas given) beta.
    """
    n_layers = len(grad_samples[0])
    g_sq = np.zeros(n_layers)
    sigma_sq = np.zeros(n_layers)
    for j in range(n_layers):
        stack = np.stack([np.asarray(g[j], np.float64).ravel() for g in grad_samples])
        g_sq[j] = float(np.mean(np.sum(stack ** 2, axis=1)))
        mean = stack.mean(axis=0)
        sigma_sq[j] = float(np.mean(np.sum((stack - mean) ** 2, axis=1)))
    out = {"g_sq": g_sq, "sigma_sq": sigma_sq}
    if param_deltas is not None and grad_deltas is not None:
        betas = [
            np.linalg.norm(gd) / max(np.linalg.norm(pd), 1e-12)
            for pd, gd in zip(param_deltas, grad_deltas)
        ]
        out["beta"] = float(np.median(betas))
    return out
