"""`repro_torch.api` — the declarative experiment layer on PyTorch.

`ExperimentSpec` (frozen, JSON round-trippable, the reference's form)
describes one simulation cell; `Session` assembles and runs it on the
card (or, when asked, the CPU), and `run_grid` runs many, folding the
compatible ones into one run (`group_cells`, `run_group`).
"""

from repro_torch.api.policies import (
    list_policies,
    make_policy,
    parse_policy,
    register_policy,
)
from repro_torch.api.grid import group_cells, run_group
from repro_torch.api.runners import (
    ExecutionChoice,
    apply_choice,
    pick,
    register_choice,
)
from repro_torch.api.session import Session, run_grid
from repro_torch.api.spec import (
    SPEC_VERSION,
    ExperimentSpec,
    load_specs,
    save_specs,
)
from repro_torch.traffic import TrafficSpec

__all__ = [
    "SPEC_VERSION",
    "ExecutionChoice",
    "ExperimentSpec",
    "Session",
    "TrafficSpec",
    "apply_choice",
    "group_cells",
    "pick",
    "register_choice",
    "run_grid",
    "run_group",
    "list_policies",
    "load_specs",
    "make_policy",
    "parse_policy",
    "register_policy",
    "save_specs",
]
