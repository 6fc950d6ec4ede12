"""Carry model weights between the reference's numpy form and the port.

The reference initializes with ``jax.random.PRNGKey`` draws that torch
cannot reproduce, so parity runs hand the reference's initial unit list
(``[{name: np.ndarray}, ...]``, conv units with an optional nested
``"proj"`` dict) to the port through these two functions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def units_from_numpy(units, device) -> list:
    """Unit list of arrays -> unit list of fp32 tensors on ``device``
    (always copies)."""
    return tree_map(
        lambda a: torch.tensor(np.array(a, dtype=np.float32), device=device),
        list(units))


def units_to_numpy(units) -> list:
    """Unit list of tensors -> unit list of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), list(units))
