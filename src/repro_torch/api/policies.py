"""The policy registry: the one place controllers are built from.

Absorbs the `repro.core.baselines.policy` name dispatch: each Section-VII
benchmark policy (and the fixed classics) is registered as a factory
``(profile, sfl, *, estimate, seed, **kw) -> policy_fn`` returning the
``policy_fn(sim, rng) -> (b, cuts)`` callable `SFLEdgeSimulator.run`
invokes at every reconfiguration boundary.  The returned controllers are
the scenario-aware ones (`repro.scenarios.controller`): they re-inject
the live device pool each boundary, so the same policy object is correct
under static pools and time-varying scenarios alike.

Registering a custom policy:

    from repro_torch.api import register_policy

    def my_factory(profile, sfl, *, estimate=True, seed=0, **kw):
        def policy(sim, rng):
            n = len(sim.devices)
            return np.full(n, 8), np.full(n, 2)
        return policy

    register_policy("my-policy", my_factory)

Completeness against `baselines.POLICY_NAMES` is asserted in tier-1
(tests/test_api.py), so a new branch in `baselines.policy` without a
registry entry fails CI.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core import baselines
from repro_torch.scenarios.controller import BaselineController, HASFLController

_REGISTRY: Dict[str, Callable] = {}


def register_policy(name: str, factory: Callable) -> None:
    """Register ``factory(profile, sfl, *, estimate, seed, **kw)``."""
    _REGISTRY[name.lower()] = factory


def list_policies() -> list:
    return sorted(_REGISTRY)


def parse_policy(name: str) -> tuple:
    """Split a (possibly parameterized) policy string into
    ``(base_name, kwargs)``.

    ``ExperimentSpec.policy`` stays a plain JSON string, so figure-grid
    ablation axes are spelled inline: ``"fixed(b=8,cut=4)"``,
    ``"fixed-ms(cut=4)"``, ``"fixed-bs(b=16)"``.  Values parse as int,
    then float, then bare string; the base name resolves through the
    registry exactly like an unparameterized policy.
    """
    name = name.strip()
    if "(" not in name:
        return name.lower(), {}
    if not name.endswith(")"):
        raise ValueError(f"malformed policy string {name!r}")
    base, argstr = name[:-1].split("(", 1)
    kwargs = {}
    for part in argstr.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"policy arg {part!r} in {name!r} must be key=value"
            )
        k, v = (s.strip() for s in part.split("=", 1))
        for cast in (int, float, str):
            try:
                kwargs[k] = cast(v)
                break
            except ValueError:
                continue
    return base.lower(), kwargs


def make_policy(
    name: str,
    profile,
    sfl,
    *,
    estimate: bool = True,
    seed: int = 0,
    **kw,
):
    """Build the named policy's controller callable.

    Parameterized strings (``"fixed(b=8,cut=4)"``) parse through
    `parse_policy`; inline args merge over (and win against) ``kw``.
    """
    key, inline = parse_policy(name)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown policy {name!r}; known: {list_policies()}"
        )
    merged = {**kw, **inline}
    return _REGISTRY[key](
        profile, sfl, estimate=estimate, seed=seed, **merged
    )


def _hasfl_factory(profile, sfl, *, estimate=True, seed=0, **kw):
    return HASFLController(profile, sfl, estimate=estimate, seed=seed, **kw)


def _baseline_factory(name: str) -> Callable:
    def factory(profile, sfl, *, estimate=True, seed=0, **kw):
        # non-adaptive-constant policies ignore estimate/seed: their
        # randomness comes from the simulator's policy RNG stream; kw
        # carries the fixed classics' pinned b=/cut= knobs
        return BaselineController(name, profile, sfl, **kw)

    return factory


for _name in baselines.POLICY_NAMES:
    if _name == "hasfl":
        register_policy(_name, _hasfl_factory)
    else:
        register_policy(_name, _baseline_factory(_name))
del _name
