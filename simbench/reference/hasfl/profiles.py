"""Per-layer computational profiles (paper notation ρ, ϖ, ψ, χ, δ).

For every cut point ``j`` (1-based, ``j = 1..L``) of a model we provide:

- ``rho[j]``    cumulative FP FLOPs of layers 1..j, per data sample
- ``bwd[j]``    cumulative BP FLOPs of layers 1..j, per data sample (ϖ)
- ``psi[j]``    activation bits at cut j, per data sample
- ``chi[j]``    activation-gradient bits at cut j, per data sample
- ``delta[j]``  client-side sub-model bits for cut j (cumulative params)
- ``g_sq[j]``   per-layer bounded 2nd moment G_j² (Assumption 2)
- ``sigma_sq[j]`` per-layer gradient-variance constant σ_j²

G²/σ² are *constants of the loss landscape*: the simulator estimates them
online (`convergence.estimate_constants`); the default prior scales them
with per-layer parameter counts, which preserves the optimizer's relative
trade-offs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import ModelConfig, CNN


@dataclass
class LayerProfile:
    """Arrays indexed 0..L-1 (cut j = index+1); cumulative where noted."""
    rho: np.ndarray        # cumulative fwd FLOPs / sample
    bwd: np.ndarray        # cumulative bwd FLOPs / sample
    psi: np.ndarray        # activation bits at cut / sample
    chi: np.ndarray        # activation-grad bits at cut / sample
    delta: np.ndarray      # cumulative client-side param bits
    params: np.ndarray     # per-layer param counts
    g_sq: np.ndarray       # per-layer G_j^2
    sigma_sq: np.ndarray   # per-layer sigma_j^2

    @property
    def n_layers(self) -> int:
        return len(self.rho)

    def g_sq_cum(self) -> np.ndarray:
        return np.cumsum(self.g_sq)

    def sigma_sq_total(self) -> float:
        return float(self.sigma_sq.sum())


BWD_MULT = 2.0          # standard: backward ~ 2x forward FLOPs
# Priors for the Assumption-2 constants: distributed over layers
# proportionally to parameter count and normalized so the variance and
# drift terms are commensurate with eps under the Table-I defaults
# (beta=0.05, gamma=5e-4, I=15, N=20, eps=0.1).  The simulator replaces
# them with online estimates (convergence.estimate_constants); the
# optimizer only depends on their *relative* layer distribution + scale.
_G_SQ_TOTAL = 9.0e4      # sum_j G_j^2 over the whole model
_SIGMA_SQ_TOTAL = 4.0e5  # sum_j sigma_j^2 over the whole model


def _assumption2_priors(params: "np.ndarray") -> tuple:
    w = params / max(params.sum(), 1.0)
    return _G_SQ_TOTAL * w, _SIGMA_SQ_TOTAL * w


def model_profile(
    cfg: ModelConfig, *, act_bytes: int = 4, param_bytes: int = 4
) -> LayerProfile:
    """Build the per-cut-point profile the HASFL optimizer consumes: the
    CNN profile, the only one a cell's HASFL decision needs (a token
    model's profile is the program's `core/profiles.py` to copy back
    when a cell runs HASFL on one)."""
    if cfg.family != CNN:
        raise NotImplementedError(
            f"{cfg.arch_id}: the reference profiles CNNs only")
    return _cnn_profile(cfg, act_bytes, param_bytes)


def _cnn_profile(cfg: ModelConfig, act_bytes: int, param_bytes: int) -> LayerProfile:
    from .config import _pool_after
    flops, params, psi = [], [], []
    spatial = cfg.image_size
    cin = 3
    for i, c in enumerate(cfg.conv_channels):
        stride2 = cfg.residual and i > 0 and c != cin
        if stride2:
            spatial = max(1, spatial // 2)
        f = 2 * 9 * cin * c * spatial * spatial
        p = 9 * cin * c + c
        if cfg.residual and stride2:
            f += 2 * cin * c * spatial * spatial
            p += 9 * cin * c + c  # 3x3 projection conv
        cin = c
        if _pool_after(cfg, i + 1):
            spatial = max(1, spatial // 2)
        flops.append(f)
        params.append(p)
        psi.append(c * spatial * spatial * 8 * act_bytes)
    flat = cin if cfg.residual else cin * spatial * spatial
    prev = flat
    for fdim in list(cfg.fc_dims) + [cfg.n_classes]:
        flops.append(2 * prev * fdim)
        params.append(prev * fdim + fdim)
        psi.append(fdim * 8 * act_bytes)
        prev = fdim
    flops, params, psi = map(np.asarray, (flops, params, psi))
    g_sq, sigma_sq = _assumption2_priors(params.astype(float))
    return LayerProfile(
        rho=np.cumsum(flops), bwd=np.cumsum(flops * BWD_MULT),
        psi=psi.astype(float), chi=psi.astype(float),
        delta=np.cumsum(params) * 8.0 * param_bytes, params=params.astype(float),
        g_sq=g_sq, sigma_sq=sigma_sq)
