"""Carry model weights between the reference's numpy form and the port.

The reference initializes with ``jax.random.PRNGKey`` draws that torch
cannot reproduce, so parity runs hand the reference's weights to the port
as numpy: the CNN unit list (``[{name: np.ndarray}, ...]``, conv units
with an optional nested ``"proj"`` dict) through `units_from_numpy`, and
the token models' nested dict (``{"embed", "stack": {"l0": {"b0": ...}},
"final_norm"}``, leaves ``[R, ...]``-stacked) through `params_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map

# token-model leaves that stay fp32 whatever ``cfg.dtype`` is: the mLSTM
# gate projection, the sLSTM recurrence weights, and every norm scale
FP32_LEAVES = frozenset({"w_if", "b_if", "w_zifo", "r_zifo", "b_zifo"})


def units_from_numpy(units, device) -> list:
    """Unit list of arrays -> unit list of fp32 tensors on ``device``
    (always copies)."""
    return tree_map(
        lambda a: torch.tensor(np.array(a, dtype=np.float32), device=device),
        list(units))


def units_to_numpy(units) -> list:
    """Unit list of tensors -> unit list of numpy arrays (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), list(units))


def _leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    if name in FP32_LEAVES or name.startswith("norm") \
            or name.endswith("norm"):
        return torch.float32
    return dtype


def _named_map(fn, tree, name=""):
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def params_from_numpy(tree, cfg, device) -> dict:
    """The reference's token-model parameter dict (numpy leaves; bf16 as
    any array type numpy can turn into fp32) -> the port's, on ``device``.

    Norm scales, ``w_if``/``b_if`` and the sLSTM ``*_zifo`` weights are
    fp32; every other leaf takes ``cfg.dtype``, as the model's init does.
    Always copies.
    """
    from repro_torch.models.transformer import torch_dtype

    dtype = torch_dtype(cfg)
    return _named_map(
        lambda name, a: torch.tensor(np.asarray(a, dtype=np.float32),
                                     device=device).to(_leaf_dtype(name,
                                                                   dtype)),
        tree)


def params_to_numpy(params) -> dict:
    """The port's token-model parameters -> fp32 numpy host copies (bf16
    leaves widen exactly)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)
