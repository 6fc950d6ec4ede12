"""Online controllers: close the HASFL loop over time-varying scenarios.

A controller is a ``policy_fn(sim, rng) -> (b, cuts)`` — exactly the
callable `SFLEdgeSimulator.run` already invokes at every reconfiguration
boundary (Algorithm 1 line 23).  What makes the loop *closed* is that
under ``run(..., scenario=...)`` the simulator re-injects the current
trace state into ``sim.devices`` before each boundary, so the controller
re-decides (b, cuts) against the environment as it is *now*:

- `HASFLController` re-estimates the Assumption-2 constants G²/σ² online
  from gradients of the current aggregated model
  (`convergence.estimate_constants`), then re-runs the Algorithm-2 BCD
  (`HASFLOptimizer`) warm-started from the previous decision.
- `BaselineController` drives the Section-VII benchmark policies (and
  the fixed-BS / fixed-MS / fixed-uniform classics) through the *same*
  trace stream and boundary schedule, so comparisons are paired.

Host-side numpy on the CPU: decisions are identical across the three
simulator round engines, preserving the ulp-exact tri-engine equivalence
even under scenario-driven mid-run reconfiguration
(tests/test_scenarios.py).  On the card the estimate's gradient moments
are taken there (`kernels.grad_moments`); the rest stays host numpy.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from repro_torch.config import CNN, SFLConfig
from repro_torch.core import baselines
from repro_torch.core.bcd import HASFLOptimizer
from repro_torch.core.convergence import estimate_constants
from repro_torch.core.profiles import LayerProfile
from repro_torch.kernels.grad_moments import grad_moments_kernel
from repro_torch.trace import count, span
from repro_torch.utils.tree import tree_leaves


# ---------------------------------------------------------------------------
# Online G²/σ² estimation
# ---------------------------------------------------------------------------


def unit_layer_spans(cfg, n_layers: int, n_units: int) -> list:
    """Map each simulator *unit* to its span of profile layers.

    CNNs are exact 1:1 (one unit per conv/fc layer — the paper's VGG
    splitting).  Transformers map the embedding unit onto layer 0, each
    super-block repetition onto its ``period`` profile layers, and the
    head unit onto the last layer.  Returns ``[(lo, hi), ...]`` with
    half-open 0-based layer ranges, one per unit.
    """
    if cfg.family == CNN:
        return [(u, u + 1) for u in range(n_units)]
    reps = n_units - 2
    period = max(1, n_layers // max(reps, 1))
    spans = [(0, 1)]  # embed -> layer 0
    for r in range(reps):
        lo = min(r * period, n_layers - 1)
        hi = n_layers if r == reps - 1 else min((r + 1) * period, n_layers)
        spans.append((lo, max(hi, lo + 1)))
    spans.append((n_layers - 1, n_layers))  # head -> last layer
    return spans


def _flat_grad(g) -> np.ndarray:
    return np.concatenate([
        x.detach().cpu().double().numpy().ravel() for x in tree_leaves(g)])


def estimate_profile_constants(
    sim,
    *,
    n_batches: int = 4,
    batch_size: int = 16,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """Estimate per-profile-layer ``g_sq``/``sigma_sq`` from the live model.

    Draws ``n_batches`` minibatches from the full training pool (its own
    RNG — the simulator's authoritative sampling stream is untouched),
    computes gradients of the current aggregated model w̄ per unit, and
    takes each unit's moments; each unit's moments are then spread over
    its profile-layer span proportionally to the per-layer parameter
    counts (the same weighting the priors use).

    Gradients on the CPU go to the host as fp64 numpy copies, and
    `convergence.estimate_constants` takes the moments there.  Gradients on
    the card stay there: `kernels.grad_moments` takes the moments in one
    pass over the samples (fp64, the same sums in another order), and only
    the ``[units, 2]`` moments cross to the host.
    """
    rng = rng or np.random.default_rng(0)
    units = sim._aggregate_model()
    arrays = sim.sampler.arrays
    n_total = len(next(iter(arrays.values())))
    take = min(batch_size, n_total)

    grad_samples = []
    on_card = False
    for _ in range(n_batches):
        idx = rng.choice(n_total, size=take, replace=False)
        batch = {k: np.asarray(v)[idx] for k, v in arrays.items()}
        with span("policy.estimate.grad"):
            (_, _), grads = sim._grad_fn(units, batch)
        on_card = tree_leaves(grads)[0].is_cuda
        if on_card:
            grad_samples.append(grads)
            continue
        with span("policy.estimate.to_host"):
            grad_samples.append([_flat_grad(g) for g in grads])
        count("estimate_bytes_to_host", sum(
            x.numel() * x.element_size() for x in tree_leaves(grads)))

    with span("policy.estimate.stats"):
        if on_card:
            moments = grad_moments_kernel(grad_samples)
            with span("policy.estimate.to_host"):
                moments = moments.cpu().numpy()
            count("estimate_bytes_to_host", moments.nbytes)
            per_unit = {"g_sq": moments[:, 0], "sigma_sq": moments[:, 1]}
        else:
            per_unit = estimate_constants(grad_samples)
        prof = sim.profile
        n_layers = prof.n_layers
        spans = unit_layer_spans(sim.cfg, n_layers, len(units))
        g_sq = np.zeros(n_layers)
        sigma_sq = np.zeros(n_layers)
        w = np.maximum(prof.params, 1.0)
        for u, (lo, hi) in enumerate(spans):
            share = w[lo:hi] / w[lo:hi].sum()
            g_sq[lo:hi] += per_unit["g_sq"][u] * share
            sigma_sq[lo:hi] += per_unit["sigma_sq"][u] * share
    return {"g_sq": g_sq, "sigma_sq": sigma_sq}


def _rescaled(est: np.ndarray, prior_total: float) -> np.ndarray:
    """Keep the measured per-layer *distribution*, restore the prior's
    total mass.  The BCD objective was calibrated against the prior
    scale (profiles.py); raw magnitudes from a reduced-width CPU model
    would push the variance/drift terms out of the eps regime and
    degenerate every decision to the infeasibility fallback."""
    total = float(est.sum())
    if total <= 0.0:
        return est
    return est * (prior_total / total)


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------


class HASFLController:
    """The paper's adaptive controller, online.

    Per boundary: (1) optionally re-estimate G²/σ² from the live model
    and EMA-blend them into a private copy of the layer profile, (2)
    point the reused `HASFLOptimizer` at the *current* device pool
    (scenario state), (3) re-run the BCD warm-started from the previous
    decision (``solve_iters`` outer iterations suffice warm).
    """

    def __init__(
        self,
        profile: LayerProfile,
        sfl: SFLConfig,
        *,
        estimate: bool = True,
        est_batches: int = 3,
        est_batch_size: int = 16,
        mix: float = 0.5,
        solve_iters: int = 4,
        seed: int = 0,
    ):
        self.profile = copy.deepcopy(profile)  # private: constants mutate
        self.sfl = sfl
        self.estimate = estimate
        self.est_batches = est_batches
        self.est_batch_size = est_batch_size
        self.mix = mix
        self.solve_iters = solve_iters
        self.est_rng = np.random.default_rng(seed)
        self._g_total = float(self.profile.g_sq.sum())
        self._s_total = float(self.profile.sigma_sq.sum())
        self._opt: Optional[HASFLOptimizer] = None
        self._prev: Optional[tuple] = None
        self.decisions = 0

    def _update_constants(self, sim) -> None:
        est = estimate_profile_constants(
            sim,
            n_batches=self.est_batches,
            batch_size=self.est_batch_size,
            rng=self.est_rng,
        )
        m = self.mix
        g_new = _rescaled(est["g_sq"], self._g_total)
        s_new = _rescaled(est["sigma_sq"], self._s_total)
        self.profile.g_sq = (1 - m) * self.profile.g_sq + m * g_new
        self.profile.sigma_sq = (1 - m) * self.profile.sigma_sq + m * s_new

    def __call__(self, sim, rng):
        if self.estimate:
            with span("policy.estimate", self.decisions):
                self._update_constants(sim)
        if self._opt is None:
            self._opt = HASFLOptimizer(self.profile, sim.devices, self.sfl)
        else:
            self._opt.set_devices(sim.devices)
        b0 = cuts0 = None
        if self._prev is not None:
            b0, cuts0 = self._prev
        with span("policy.solve", self.decisions):
            d = self._opt.solve(b0=b0, cuts0=cuts0,
                                max_iter=self.solve_iters)
        self._prev = (d.b.copy(), d.cuts.copy())
        self.decisions += 1
        return d.b, d.cuts

    # -- crash-safe snapshot hooks (DESIGN.md §12) ----------------------
    #
    # The complete mutable cross-boundary state: the EMA-blended
    # Assumption-2 constants, the estimation RNG stream, the warm-start
    # decision, and the decision counter.  `_opt` is deliberately absent
    # — `HASFLOptimizer` carries no cross-solve state (warm starts flow
    # purely through b0/cuts0), so a fresh lazy rebuild is equivalent.

    def state_dict(self) -> dict:
        state = {
            "g_sq": np.asarray(self.profile.g_sq).tolist(),
            "sigma_sq": np.asarray(self.profile.sigma_sq).tolist(),
            "est_rng": self.est_rng.bit_generator.state,
            "decisions": int(self.decisions),
            "prev": None,
        }
        if self._prev is not None:
            b0, cuts0 = self._prev
            state["prev"] = {
                "b": np.asarray(b0).tolist(),
                "cuts": np.asarray(cuts0).tolist(),
            }
        return state

    def load_state_dict(self, state: dict) -> None:
        self.profile.g_sq = np.asarray(state["g_sq"], float)
        self.profile.sigma_sq = np.asarray(state["sigma_sq"], float)
        self.est_rng.bit_generator.state = state["est_rng"]
        self.decisions = int(state["decisions"])
        if state.get("prev") is None:
            self._prev = None
        else:
            self._prev = (
                np.asarray(state["prev"]["b"]),
                np.asarray(state["prev"]["cuts"]),
            )


class BaselineController:
    """Section-VII benchmark policies over the live scenario state.

    The wrapped `HASFLOptimizer` (needed by the heterogeneity-aware
    sub-policies) is reused across boundaries with its device pool
    re-injected, so fixed-BS / fixed-MS baselines adapt exactly the
    sub-problem they are allowed to and nothing else.
    """

    def __init__(self, name: str, profile: LayerProfile, sfl: SFLConfig,
                 *, b=None, cut=None):
        self.name = name
        self.profile = profile
        self.sfl = sfl
        # pinned uniform knobs for the fixed classics (parameterized
        # policy strings — `repro.api.policies.parse_policy`); None
        # keeps the baselines module defaults
        self.overrides = {"b": b, "cut": cut}
        self._opt: Optional[HASFLOptimizer] = None

    def __call__(self, sim, rng):
        if self._opt is None:
            self._opt = HASFLOptimizer(self.profile, sim.devices, self.sfl)
        else:
            self._opt.set_devices(sim.devices)
        return baselines.policy(self.name, self._opt, rng, **self.overrides)

    def state_dict(self) -> dict:
        # no cross-boundary mutable state (the lazily-built optimizer is
        # stateless across solves); kept for a uniform snapshot surface
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


def make_controller(
    policy: str,
    profile: LayerProfile,
    sfl: SFLConfig,
    *,
    estimate: bool = True,
    seed: int = 0,
    **kw,
):
    """Controller factory: ``"hasfl"`` -> `HASFLController`, any
    benchmark policy name -> `BaselineController`."""
    if policy.lower() == "hasfl":
        return HASFLController(
            profile, sfl, estimate=estimate, seed=seed, **kw
        )
    return BaselineController(policy, profile, sfl, **kw)
