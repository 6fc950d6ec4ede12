"""Time-varying edge scenarios + the online HASFL control loop."""

from repro_torch.scenarios.traces import (
    Churn,
    ComputeJitter,
    Diurnal,
    MarkovBursts,
    RayleighFading,
    Scenario,
    Trace,
)
from repro_torch.scenarios.presets import PRESETS, list_presets, make_scenario
from repro_torch.scenarios.controller import (
    BaselineController,
    HASFLController,
    estimate_profile_constants,
    make_controller,
)

__all__ = [
    "Churn",
    "ComputeJitter",
    "Diurnal",
    "MarkovBursts",
    "RayleighFading",
    "Scenario",
    "Trace",
    "PRESETS",
    "list_presets",
    "make_scenario",
    "BaselineController",
    "HASFLController",
    "estimate_profile_constants",
    "make_controller",
]
