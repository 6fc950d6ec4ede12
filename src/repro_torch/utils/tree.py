"""Minimal pytree helpers over nested dicts / lists of tensors.

Parameter units are plain dicts (a conv unit is ``{"w", "b"}`` plus an
optional nested ``"proj"`` conv), so these helpers walk dicts in sorted
key order — the order `jax.tree_util` flattens dicts in — which keeps
leaf enumeration (clip norms, conversion, comparisons) aligned with the
reference package.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def map_leaves(fn, tree):
    return tree_map(fn, tree)


def param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_allfinite(tree) -> torch.Tensor:
    """A bool tensor: every floating leaf is finite (True when none is)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if x.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()
