"""Optimizers (SGD / momentum / Adam) as init/update pairs over tensor
trees.  Port of `repro.training.optim`, with its contract: ``init(params)
-> state`` and ``update(grads, state, params, step) -> (new_params,
new_state)``; the state's float leaves are kept in ``state_dtype``.

The arithmetic is the reference's, operation by operation (casts where it
casts, the Adam update in the state's type, bias corrections as fp32
scalars).  Where the reference returns new arrays, the port updates the
state and the parameters in place and returns them: at qwen3-1.7b's
width a functional step would hold a second copy of the fp32 moments
(2 × 4 bytes a parameter) during every update.  ``params`` must
therefore be plain tensors (not autograd leaves that require grad).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class Optimizer:
    init: Callable    # params -> state
    update: Callable  # (grads, state, params, step) -> (new_params, new_state)
    name: str = ""


def _zip_leaves(*trees):
    return zip(*(tree_leaves(t) for t in trees))


def make_optimizer(name: str = "adam", lr: float = 3e-4, *,
                   momentum: float = 0.9, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, weight_decay: float = 0.0,
                   state_dtype: str = "float32") -> Optimizer:
    sd = _DTYPES[state_dtype]
    name = name.lower()

    def zeros(p):
        return torch.zeros_like(p, dtype=sd if p.is_floating_point()
                                else p.dtype)

    if name == "sgd":
        def init(params):
            return ()

        @torch.no_grad()
        def update(grads, state, params, step):
            for p, g in _zip_leaves(params, grads):
                p.sub_(lr * (g + weight_decay * p).to(p.dtype))
            return params, state
        return Optimizer(init, update, "sgd")

    if name == "momentum":
        def init(params):
            return tree_map(zeros, params)

        @torch.no_grad()
        def update(grads, state, params, step):
            for p, m, g in _zip_leaves(params, state, grads):
                m.mul_(momentum).add_(g.to(m.dtype))
                p.sub_(lr * (m.to(p.dtype) + weight_decay * p))
            return params, state
        return Optimizer(init, update, "momentum")

    if name == "adam":
        def init(params):
            return {"m": tree_map(zeros, params),
                    "v": tree_map(zeros, params)}

        @torch.no_grad()
        def update(grads, state, params, step):
            # the elementwise math stays in the state's type; the bias
            # corrections are fp32 scalars, as in the reference
            t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
            corr1 = 1.0 / (1.0 - torch.pow(b1, t))
            corr2 = 1.0 / (1.0 - torch.pow(b2, t))
            lr_c = lr * corr1
            for p, m, v, g in _zip_leaves(params, state["m"], state["v"],
                                          grads):
                m.mul_(b1).add_((1 - b1) * g.to(m.dtype))
                v.mul_(b2).add_((1 - b2) * (g.to(v.dtype) ** 2))
                denom = torch.sqrt(v * corr2.to(v.device, v.dtype)) + eps
                step_ = lr_c.to(m.device, m.dtype) * m / denom.to(m.dtype)
                if weight_decay:
                    wd = lr * weight_decay * p
                    p.sub_(step_.to(p.dtype)).sub_(wd)
                else:
                    p.sub_(step_.to(p.dtype))
            return params, state
        return Optimizer(init, update, "adam")

    raise ValueError(f"unknown optimizer {name!r}")
