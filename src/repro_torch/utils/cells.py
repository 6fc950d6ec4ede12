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

from repro_torch.utils.tree import tree_map


def apart(t, cell_size) -> bool:
    """Whether an op over ``t`` (``[G·N, ...]``) runs cell by cell: where
    a cell size splits the leading axis."""
    return cell_size is not None and t.shape[0] != cell_size


def by_cell(fn, cell_size, *ts):
    """``fn(*ts)`` over the whole leading axis or, where `apart`, over each
    cell's ``[cell_size, ...]`` rows of every tensor in ``ts``, the results
    concatenated along the leading axis."""
    if not apart(ts[0], cell_size):
        return fn(*ts)
    return torch.cat([fn(*parts) for parts in
                      zip(*(t.split(cell_size) for t in ts))])


def rows(tree, g: int, n: int):
    """Cell ``g``'s rows ``[g·n, (g+1)·n)`` of every leaf of ``tree``
    (views), or None for None."""
    return None if tree is None else tree_map(
        lambda a: a[g * n:(g + 1) * n], tree)


def fold(trees: list):
    """Same-structured per-cell trees of ``[n, ...]`` leaves -> one tree of
    ``[G·n, ...]`` leaves, cell after cell (new tensors)."""
    return tree_map(lambda *xs: torch.cat(xs), *trees)
