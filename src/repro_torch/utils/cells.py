"""Cell-folded tensors of the grid runner.

`api.grid.run_group` folds the grid's G cells of N clients each into one
leading axis of ``G·N`` rows (cell ``g`` holds rows ``[g·N, (g+1)·N)``),
so every round runs once over all cells.  Each cell must still compute
exactly what its own run computes.  A library reduction or GEMM may pick
its plan (how many blocks share one output, which cuBLAS algorithm, how
rows are split over threads) from the leading extent, and so sum in
another order at G·N rows than at N; `by_cell` runs such an op once per
cell, on every device.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def apart(t, cell_size) -> bool:
    """Whether an op over ``t`` (``[G·N, ...]``) runs cell by cell: where
    a cell size splits the leading axis."""
    return cell_size is not None and t.shape[0] != cell_size


def cell_parts(t, size: int, count: int) -> list:
    """``count`` per-cell parts of ``t``: a tensor's ``[size, ...]`` row
    blocks (one `split`, so its backward is one concatenation), a dict's
    leaves split alike, None repeated."""
    if t is None:
        return [None] * count
    if isinstance(t, dict):
        parts = {k: cell_parts(v, size, count) for k, v in t.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(count)]
    return list(t.split(size))


def by_cell(fn, cell_size, *ts):
    """``fn(*ts)`` over the whole leading axis or, where `apart`, over each
    cell's ``[cell_size, ...]`` rows of every argument in ``ts`` (tensors,
    dicts of tensors, or None), the results — a tensor or a tuple of
    tensors — concatenated along the leading axis.

    Unsplit, ``fn`` takes a view of each tensor: autograd sums the
    gradients of a tensor's uses in the order they arrive, so where ``fn``
    uses an input more than once, its uses must reach the input through
    one node, as the split's parts do, for a cell's gradient sums to
    associate as its own run's."""
    lead = tree_leaves(ts[0])[0]
    if not apart(lead, cell_size):
        return fn(*(tree_map(lambda a: None if a is None
                             else a.view_as(a), t) for t in ts))
    count = lead.shape[0] // cell_size
    parts = [fn(*p) for p in zip(*(cell_parts(t, cell_size, count)
                                   for t in ts))]
    return tuple(fold(list(parts))) if isinstance(parts[0], tuple) \
        else torch.cat(parts)


def rows(tree, g: int, n: int):
    """Cell ``g``'s rows ``[g·n, (g+1)·n)`` of every leaf of ``tree``
    (views), or None for None."""
    return None if tree is None else tree_map(
        lambda a: a[g * n:(g + 1) * n], tree)


def fold(trees: list):
    """Same-structured per-cell trees of ``[n, ...]`` leaves -> one tree of
    ``[G·n, ...]`` leaves, cell after cell (new tensors)."""
    return tree_map(lambda *xs: torch.cat(xs), *trees)
