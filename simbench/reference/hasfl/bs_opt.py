"""Batch-size sub-problem (P1) — Proposition 1 + Newton–Jacobi.

Objective (fixed mu, T):

    Theta'(b) = 2*theta * (sum_i b_i*C_i + D) / (gamma * (A - sum_i B/b_i))

    A   = eps - 1{I>1} 4 beta^2 gamma^2 I^2 T1
    B   = beta*gamma*sum_j sigma_j^2 / N^2
    C_i = (rho_L - rho_{cut_i} + bwd_L - bwd_{cut_i}) / f_s
    D   = T3 + T4 + (T5 + T6)/I

The interior stationary point solves Xi_i(b) = 0 where

    Xi_i(b) = C_i (A - sum_k B/b_k) - (sum_k b_k C_k + D) B / b_i^2

(Xi_i is strictly increasing in b_i — proof in the paper), solved with a
damped Newton–Jacobi sweep; then integer rounding against the caps kappa_i
(Eqn 48).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BSProblem:
    a: float                 # A
    b_const: float           # B
    c: np.ndarray            # C_i, [N]
    d: float                 # D
    kappa: np.ndarray        # caps, [N]
    theta_gap: float = 1.0
    gamma: float = 1.0

    @property
    def n(self) -> int:
        return len(self.c)

    def objective(self, b: np.ndarray) -> float:
        b = np.asarray(b, float)
        den = self.a - np.sum(self.b_const / b)
        if den <= 0:
            return float("inf")
        num = float(np.dot(b, self.c)) + self.d
        return 2 * self.theta_gap * num / (self.gamma * den)

    def xi(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b, float)
        den = self.a - np.sum(self.b_const / b)
        num = float(np.dot(b, self.c)) + self.d
        return self.c * den - num * self.b_const / b ** 2

    def xi_prime(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b, float)
        num = float(np.dot(b, self.c)) + self.d
        return 2 * self.b_const * num / b ** 3


def newton_jacobi(
    prob: BSProblem, b0=None, max_iter: int = 200,
    tol: float = 1e-8
) -> np.ndarray:
    """Solve dTheta'/db = 0 (i.e. Xi = 0 coordinate-wise), continuous."""
    n = prob.n
    b = np.full(n, 32.0) if b0 is None else np.asarray(b0, float).copy()
    # ensure feasibility of the denominator at start
    for _ in range(60):
        if prob.a - np.sum(prob.b_const / b) > 1e-12:
            break
        b *= 2.0
    for _ in range(max_iter):
        xi = prob.xi(b)
        step = xi / np.maximum(prob.xi_prime(b), 1e-30)
        new_b = np.clip(b - step, 1e-3, 1e7)
        # keep denominator positive (damping)
        lam = 1.0
        for _ in range(40):
            cand = b + lam * (new_b - b)
            if prob.a - np.sum(prob.b_const / cand) > 1e-12:
                new_b = cand
                break
            lam *= 0.5
        if np.max(np.abs(new_b - b) / np.maximum(b, 1.0)) < tol:
            b = new_b
            break
        b = new_b
    return b


def round_bs(
    prob: BSProblem, b_hat: np.ndarray,
    exhaustive_limit: int = 8
) -> np.ndarray:
    """Integer projection per Proposition 1 / Eqn (48)."""
    n = prob.n
    kappa = np.maximum(prob.kappa, 1.0)

    def candidates(i):
        bh = b_hat[i]
        if bh <= 1:
            return [1]
        if bh >= kappa[i]:
            return [max(1, int(np.floor(kappa[i])))]
        cands = {int(np.floor(bh)), int(np.ceil(bh))}
        return sorted(max(1, min(c, int(np.floor(kappa[i])))) for c in cands)

    cand_lists = [candidates(i) for i in range(n)]
    # feasibility fallback: if every candidate corner violates C1 (the
    # denominator), take the largest allowed batch everywhere (minimum
    # variance); the BCD outer loop re-derives caps from it and recovers.
    fallback = np.asarray([max(1, int(np.floor(kappa[i]))) for i in range(n)], int)
    if n <= exhaustive_limit:
        # exact search over the <=3^N corner combinations
        best, best_val = None, float("inf")
        import itertools
        for combo in itertools.product(*cand_lists):
            v = prob.objective(np.asarray(combo, float))
            if v < best_val:
                best, best_val = combo, v
        if best is None or not np.isfinite(best_val):
            return fallback
        return np.asarray(best, int)
    # greedy independent rounding (paper's efficient variant)
    b = np.asarray([c[0] for c in cand_lists], float)
    for i in range(n):
        vals = []
        for c in cand_lists[i]:
            b[i] = c
            vals.append(prob.objective(b))
        b[i] = cand_lists[i][int(np.argmin(vals))]
    if not np.isfinite(prob.objective(b)):
        return fallback
    return b.astype(int)


def solve_bs(prob: BSProblem, b0=None) -> np.ndarray:
    """Proposition 1 end-to-end: continuous stationary point + rounding."""
    b_hat = newton_jacobi(prob, b0)
    return round_bs(prob, b_hat)
