"""Arch-family x device execution table (port of `repro.api.runners`).

The reference keys its table on (arch family, JAX backend) and picks the
runner (grid or sequential) and the kernel impls measured fastest there;
its TPU CNN row turns on the batched-conv and fused clip+SGD kernels.  The
port's counterpart row is ``("cnn", "cuda")``: the grid runner, with both
hand-written kernels.  `Session.run_grid(..., runner="auto")` resolves
each compatible group through this table, and `apply_choice` only *fills*
knobs a spec leaves unset, so pinned specs replay exactly.

The ``("cnn", "cpu")`` row keeps the reference's core-count rule: grid
with two cores or more, sequential on one (`cpu_cores`,
``REPRO_CPU_CORES``).  It fills no kernel impl: the port's CPU conv is
always the im2col GEMM's plain version, whatever ``conv_impl`` says.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from repro_torch.api.spec import ExperimentSpec
from repro_torch.config import get_config


@dataclass(frozen=True)
class ExecutionChoice:
    """How one grid-compatible group of cells should execute."""

    runner: str = "grid"                 # "grid" | "sequential"
    conv_impl: Optional[str] = None      # None = the plain stacked conv
    update_impl: Optional[str] = None    # None = the inline plain update

    def __post_init__(self):
        if self.runner not in ("grid", "sequential"):
            raise ValueError(f"unknown runner {self.runner!r}")


_DEFAULT = ExecutionChoice()

_REGISTRY = {
    ("cnn", "cuda"): ExecutionChoice("grid", conv_impl="kernel",
                                     update_impl="kernel"),
    # the reference's ("token", "tpu") row: the fused clip+SGD update
    ("token", "cuda"): ExecutionChoice("grid", update_impl="kernel"),
}


def cpu_cores() -> int:
    """Cores the process can use (``REPRO_CPU_CORES`` overrides — tests and
    pinned-affinity launchers set it)."""
    env = os.environ.get("REPRO_CPU_CORES")
    if env:
        return max(1, int(env))
    return os.cpu_count() or 1


def _cnn_cpu_choice() -> ExecutionChoice:
    """The (cnn, cpu) row, resolved from the core count."""
    return ExecutionChoice("grid" if cpu_cores() >= 2 else "sequential")


def arch_family(arch: str) -> str:
    return "cnn" if get_config(arch).is_cnn else "token"


def pick(spec: ExperimentSpec, device_type: str) -> ExecutionChoice:
    """The table's choice for one cell on ``device_type`` ("cuda"/"cpu").

    A `register_choice` pin always wins; the (cnn, cpu) default is
    core-count-aware (`_cnn_cpu_choice`)."""
    key = (arch_family(spec.arch), device_type)
    if key in _REGISTRY:
        return _REGISTRY[key]
    if key == ("cnn", "cpu"):
        return _cnn_cpu_choice()
    return _DEFAULT


def apply_choice(spec: ExperimentSpec, device_type: str) -> ExperimentSpec:
    """Fill the spec's unset kernel knobs from the table."""
    choice = pick(spec, device_type)
    overrides = {}
    if spec.conv_impl is None and choice.conv_impl is not None:
        overrides["conv_impl"] = choice.conv_impl
    if spec.update_impl is None and choice.update_impl is not None:
        overrides["update_impl"] = choice.update_impl
    return spec.replace(**overrides) if overrides else spec


def register_choice(family: str, device_type: str,
                    choice: ExecutionChoice) -> None:
    """Override one (arch family, device type) row."""
    _REGISTRY[(family, device_type)] = choice
