"""Time-varying edge scenario traces (port of `repro.scenarios.traces`,
verbatim but for the imports).

A **scenario** evolves the per-device resource state (`DeviceProfile`
fields) round by round, so the HASFL controller can be exercised against
fading channels, compute jitter, straggler bursts, diurnal load cycles,
and client churn instead of the static Table-I pool (DESIGN.md §9).

Structure:

- a ``Trace`` is one stochastic (or deterministic) process over rounds;
  it owns a per-device state vector and produces *multipliers* on a
  subset of profile fields plus an availability vote.
- a ``Scenario`` composes traces over a base device pool: at round ``t``
  every trace steps once, the multipliers compose multiplicatively, and
  the result materializes as a fresh ``list[DeviceProfile]``.

Determinism: a ``Scenario`` is seeded once and steps its traces in a
fixed order, so two scenarios built with the same (base devices, traces,
seed) produce bitwise-identical round sequences.  This is what lets
HASFL and every baseline policy share one trace *stream*: each run
constructs its own ``Scenario`` from the same spec and sees the same
environment (the comparison is paired, not merely distribution-matched).

Rounds are 1-based like the simulator; ``profiles_at(0)`` is the initial
(pre-round-1) state the first policy decision observes.  The full round
history is retained (a few floats per device per round), so any already
generated round can be re-queried — the scan engine's segment scheduler
and the per-round engines query identical sequences.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config import DeviceProfile

# DeviceProfile fields a trace may modulate.
FIELDS = ("flops", "up_bw", "down_bw", "fed_up_bw", "fed_down_bw", "memory")
BANDWIDTH_FIELDS = ("up_bw", "down_bw", "fed_up_bw", "fed_down_bw")


class Trace:
    """One resource process.  Subclasses override ``init`` and ``step``.

    ``step`` returns ``(state, mults, available)`` where ``mults`` maps
    field name -> [N] multiplier and ``available`` is an [N] bool vote
    (AND-composed across traces).  ``t`` is the 1-based round being
    generated; ``init`` produces the round-0 state.
    """

    fields: Tuple[str, ...] = ()

    def init(self, n: int, rng: np.random.Generator):
        raise NotImplementedError

    def step(self, state, t: int, n: int, rng: np.random.Generator):
        raise NotImplementedError

    def _mults(self, n: int, gain: np.ndarray) -> Dict[str, np.ndarray]:
        return {f: gain for f in self.fields}


@dataclass
class RayleighFading(Trace):
    """Gauss-Markov Rayleigh channel on bandwidth fields.

    The complex gain h follows an AR(1) (Jakes-style coherence):
    ``h' = rho*h + sqrt(1-rho^2)*eps`` with unit-variance complex eps, so
    ``|h|^2`` is exponential in steady state.  The bandwidth multiplier
    is Shannon-normalized, ``log2(1+snr*|h|^2)/log2(1+snr)`` — mean ~1
    with deep fades — rather than raw ``|h|^2``.
    """

    fields: Tuple[str, ...] = ("up_bw",)
    coherence: float = 0.9
    snr_db: float = 10.0

    def init(self, n: int, rng: np.random.Generator):
        re, im = rng.standard_normal(n), rng.standard_normal(n)
        return (re + 1j * im) / np.sqrt(2.0)

    def step(self, h, t, n, rng):
        rho = self.coherence
        re, im = rng.standard_normal(n), rng.standard_normal(n)
        eps = (re + 1j * im) / np.sqrt(2.0)
        h = rho * h + np.sqrt(1.0 - rho * rho) * eps
        snr = 10.0 ** (self.snr_db / 10.0)
        gain = np.log2(1.0 + snr * np.abs(h) ** 2) / np.log2(1.0 + snr)
        return h, self._mults(n, gain), np.ones(n, bool)


@dataclass
class ComputeJitter(Trace):
    """AR(1) log-normal jitter on device compute speed (OS scheduling,
    thermal throttling, co-tenant load)."""

    fields: Tuple[str, ...] = ("flops",)
    sigma: float = 0.1
    rho: float = 0.8

    def init(self, n, rng):
        return rng.standard_normal(n) * self.sigma

    def step(self, x, t, n, rng):
        noise = rng.standard_normal(n) * self.sigma
        x = self.rho * x + np.sqrt(1.0 - self.rho**2) * noise
        return x, self._mults(n, np.exp(x)), np.ones(n, bool)


@dataclass
class MarkovBursts(Trace):
    """Two-state Markov bursts (normal <-> degraded) per device.

    In the degraded state the listed fields are multiplied by ``factor``
    — compute bursts model stragglers, bandwidth bursts model deep
    outages (``factor=0`` is legal: `core.latency` floors resources so
    the objective stays finite via the straggler max terms).
    """

    fields: Tuple[str, ...] = ("flops",)
    p_enter: float = 0.05
    p_exit: float = 0.3
    factor: float = 0.1

    def init(self, n, rng):
        # start in steady state so short runs see bursts too
        p_burst = self.p_enter / max(self.p_enter + self.p_exit, 1e-12)
        return rng.random(n) < p_burst

    def step(self, burst, t, n, rng):
        u = rng.random(n)
        burst = np.where(burst, u >= self.p_exit, u < self.p_enter)
        gain = np.where(burst, self.factor, 1.0)
        return burst, self._mults(n, gain), np.ones(n, bool)


@dataclass
class Diurnal(Trace):
    """Deterministic sinusoidal load cycle (shared network/compute tide)
    with a per-device phase offset."""

    fields: Tuple[str, ...] = ("up_bw", "down_bw", "flops")
    period: int = 200
    depth: float = 0.5  # min multiplier = 1 - depth
    phase_spread: float = 0.25  # fraction of a period across devices

    def init(self, n, rng):
        return rng.uniform(0.0, self.phase_spread, n) * 2.0 * np.pi

    def step(self, phase, t, n, rng):
        x = 2.0 * np.pi * t / max(self.period, 1) + phase
        gain = 1.0 - self.depth * 0.5 * (1.0 - np.cos(x))
        return phase, self._mults(n, gain), np.ones(n, bool)


@dataclass
class Churn(Trace):
    """Client churn/arrival as a two-state availability Markov chain.

    The cohort is fixed-N (the paper's formulation): a departed client
    stays in the stacked state but its bandwidths collapse by
    ``outage_factor``, so the latency model and the controller's
    straggler caps push its assigned work to the minimum until it
    rejoins.  The availability mask is also exposed on the scenario for
    controllers that want to react explicitly.
    """

    fields: Tuple[str, ...] = BANDWIDTH_FIELDS
    p_leave: float = 0.02
    p_join: float = 0.2
    outage_factor: float = 1e-6

    def init(self, n, rng):
        p_off = self.p_leave / max(self.p_leave + self.p_join, 1e-12)
        return rng.random(n) >= p_off  # True = online

    def step(self, online, t, n, rng):
        u = rng.random(n)
        online = np.where(online, u >= self.p_leave, u < self.p_join)
        gain = np.where(online, 1.0, self.outage_factor)
        return online, self._mults(n, gain), online.astype(bool)


@dataclass
class _Round:
    fields: Dict[str, np.ndarray]
    available: np.ndarray
    devices: list = field(default_factory=list)


class Scenario:
    """A composed, seeded, per-round device-pool process."""

    def __init__(
        self,
        base_devices: Sequence[DeviceProfile],
        traces: Sequence[Trace] = (),
        seed: int = 0,
        name: str = "custom",
    ):
        self.name = name
        self.base_devices = list(base_devices)
        self.n = len(self.base_devices)
        self.traces = list(traces)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._base = {
            f: np.array([getattr(d, f) for d in self.base_devices])
            for f in FIELDS
        }
        self._states = [tr.init(self.n, self.rng) for tr in self.traces]
        fields0 = {k: v.copy() for k, v in self._base.items()}
        first = _Round(fields0, np.ones(self.n, bool))
        first.devices = self.base_devices
        self._history = [first]  # index = round (0 = initial)

    # ------------------------------------------------------------------
    def _generate(self, t: int) -> None:
        """Extend the history up to round ``t`` (sequential Markov steps)."""
        while len(self._history) <= t:
            r = len(self._history)
            mult = {f: np.ones(self.n) for f in FIELDS}
            avail = np.ones(self.n, bool)
            for i, tr in enumerate(self.traces):
                state, mults, a = tr.step(self._states[i], r, self.n, self.rng)
                self._states[i] = state
                for f, g in mults.items():
                    mult[f] = mult[f] * g
                avail &= a
            fields = {f: self._base[f] * mult[f] for f in FIELDS}
            self._history.append(_Round(fields, avail))

    def profiles_at(self, t: int) -> list:
        """Device pool at round ``t`` (materialized ``DeviceProfile``s)."""
        self._generate(t)
        rec = self._history[t]
        if not rec.devices:
            rec.devices = [
                DeviceProfile(**{f: float(rec.fields[f][i]) for f in FIELDS})
                for i in range(self.n)
            ]
        return rec.devices

    def available_at(self, t: int) -> np.ndarray:
        self._generate(t)
        return self._history[t].available

    def multipliers_at(self, t: int) -> Dict[str, np.ndarray]:
        """field -> [N] multiplier (round-t fields over the base pool).

        The traffic plane composes scenarios with *per-user* device
        profiles: each slot's round-t resources are the slot's own base
        profile times the scenario's round-t multiplier (slot i inherits
        trace lane i), so churn-admitted users still ride the same
        diurnal/outage processes the fixed-cohort runs see.
        """
        self._generate(t)
        rec = self._history[t]
        return {
            f: rec.fields[f] / np.maximum(self._base[f], 1e-300)
            for f in FIELDS
        }

    def field_history(self, field_name: str, rounds: int) -> np.ndarray:
        """[rounds+1, N] trajectory of one profile field (round 0 first)."""
        self._generate(rounds)
        return np.stack(
            [self._history[t].fields[field_name] for t in range(rounds + 1)]
        )

    def restarted(self, seed: Optional[int] = None) -> "Scenario":
        """A fresh scenario with the same spec (same stream when seed
        is unchanged) — what paired policy comparisons use."""
        rng_seed = self.seed if seed is None else seed
        return Scenario(
            self.base_devices, self.traces, seed=rng_seed, name=self.name
        )

    def __repr__(self):
        kinds = ",".join(type(tr).__name__ for tr in self.traces) or "static"
        return f"Scenario({self.name!r}, n={self.n}, traces=[{kinds}])"
