"""Named scenario presets (port of `repro.scenarios.presets`, verbatim
but for the imports).

Each preset is a ~10-line trace composition; new "imagined scenarios"
are meant to be added here (one entry) rather than as new subsystems.
``make_scenario(name, base_devices, seed)`` returns a seeded, paired
`Scenario`: two calls with identical arguments yield bitwise-identical
round streams, so every policy in a sweep sees the same environment.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.config import DeviceProfile
from repro_torch.scenarios.traces import (
    Churn,
    ComputeJitter,
    Diurnal,
    MarkovBursts,
    RayleighFading,
    Scenario,
)


def _stable(base, seed):
    """Static Table-I pool — the paper's original setting (control)."""
    return Scenario(base, traces=(), seed=seed, name="stable")


def _diurnal(base, seed):
    """Slow shared tide on bandwidth and compute plus mild jitter —
    evening congestion / daytime co-tenant load."""
    return Scenario(
        base,
        traces=(
            Diurnal(
                fields=("up_bw", "down_bw", "flops"),
                period=120,
                depth=0.6,
                phase_spread=0.3,
            ),
            ComputeJitter(sigma=0.05, rho=0.8),
        ),
        seed=seed,
        name="diurnal",
    )


def _flaky_uplink(base, seed):
    """Rayleigh-fading access uplinks with deep Markov outage bursts —
    the regime where per-round activation upload dominates and fixed
    policies stall on whichever client is currently faded.  Only the
    edge-server link (r_i^U, the per-round activation path) fades; the
    federation link (r_{i,f}^U, the every-I sub-model path) is separate
    infrastructure in the paper's system model and stays clean — which is
    exactly what makes cut depth an effective control lever here."""
    return Scenario(
        base,
        traces=(
            RayleighFading(fields=("up_bw",), coherence=0.7, snr_db=5.0),
            MarkovBursts(
                fields=("up_bw",), p_enter=0.08, p_exit=0.25, factor=0.02
            ),
        ),
        seed=seed,
        name="flaky-uplink",
    )


def _churn_heavy(base, seed):
    """Clients leaving/rejoining at a high rate plus compute jitter."""
    return Scenario(
        base,
        traces=(
            Churn(p_leave=0.05, p_join=0.3),
            ComputeJitter(sigma=0.15, rho=0.9),
        ),
        seed=seed,
        name="churn-heavy",
    )


def _straggler_bursts(base, seed):
    """Intermittent 10x compute slowdowns (GC pauses, thermal events)."""
    return Scenario(
        base,
        traces=(
            MarkovBursts(
                fields=("flops",), p_enter=0.05, p_exit=0.3, factor=0.1
            ),
        ),
        seed=seed,
        name="straggler-bursts",
    )


PRESETS = {
    "stable": _stable,
    "diurnal": _diurnal,
    "flaky-uplink": _flaky_uplink,
    "churn-heavy": _churn_heavy,
    "straggler-bursts": _straggler_bursts,
}


def list_presets() -> list:
    return sorted(PRESETS)


def make_scenario(
    name: str, base_devices: Sequence[DeviceProfile], seed: int = 0
) -> Scenario:
    """Build a named preset over a base device pool."""
    if name not in PRESETS:
        raise KeyError(
            f"unknown scenario preset {name!r}; known: {list_presets()}"
        )
    return PRESETS[name](list(base_devices), seed)
