"""Online controllers (the scenario presets and traces are still to port)."""
from repro_torch.scenarios.controller import (  # noqa: F401
    BaselineController,
    HASFLController,
    estimate_profile_constants,
    make_controller,
)
