"""Arch-family x device kernel table (port of `repro.api.runners`).

The reference keys its table on (arch family, JAX backend) and picks the
runner and the kernel impls measured fastest there; its TPU CNN row turns
on the batched-conv and fused clip+SGD kernels.  The port's counterpart
row is ``("cnn", "cuda")``: both hand-written kernels.  Only sequential
execution is ported (the grid runner is a ROADMAP.md item), so the table
holds kernel impls only, and it only *fills* knobs a spec leaves unset.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.api.spec import ExperimentSpec
from repro_torch.config import get_config


@dataclass(frozen=True)
class ExecutionChoice:
    """The kernel impls one cell should run with."""

    conv_impl: Optional[str] = None      # None = the plain stacked conv
    update_impl: Optional[str] = None    # None = the inline plain update


_DEFAULT = ExecutionChoice()

_REGISTRY = {
    ("cnn", "cuda"): ExecutionChoice(conv_impl="kernel",
                                     update_impl="kernel"),
}


def arch_family(arch: str) -> str:
    return "cnn" if get_config(arch).is_cnn else "token"


def pick(spec: ExperimentSpec, device_type: str) -> ExecutionChoice:
    """The table's choice for one cell on ``device_type`` ("cuda"/"cpu")."""
    return _REGISTRY.get((arch_family(spec.arch), device_type), _DEFAULT)


def apply_choice(spec: ExperimentSpec, device_type: str) -> ExperimentSpec:
    """Fill the spec's unset kernel knobs from the table."""
    choice = pick(spec, device_type)
    overrides = {}
    if spec.conv_impl is None and choice.conv_impl is not None:
        overrides["conv_impl"] = choice.conv_impl
    if spec.update_impl is None and choice.update_impl is not None:
        overrides["update_impl"] = choice.update_impl
    return spec.replace(**overrides) if overrides else spec

