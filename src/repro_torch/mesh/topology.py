"""Pure two-tier aggregation algebra (numpy; a verbatim copy of
`repro.mesh.topology`).

The contract the sharded runtime is gated against: summing per-edge
partial sums and dividing by the global survivor count is *the same
linear map* as the flat survivor-renormalized Eq. 4/7 mean — the only
freedom floating point has is reassociation, which the equivalence
tests bound at fp32 tolerance.
"""
from __future__ import annotations

import numpy as np


def edge_assignment(n_clients: int, n_edges: int) -> np.ndarray:
    """``[N]`` edge ids under the contiguous block layout: edge ``e``
    owns clients ``[e*C, (e+1)*C)`` with ``C = n_clients / n_edges``."""
    n_clients, n_edges = int(n_clients), int(n_edges)
    if n_edges < 1 or n_clients % n_edges != 0:
        raise ValueError(
            f"n_edges {n_edges} must divide n_clients {n_clients}")
    return np.repeat(np.arange(n_edges), n_clients // n_edges)


def edge_partials(values, weights, n_edges: int):
    """Per-edge partial sums: ``(sums [E, ...], counts [E])``.

    ``values`` is ``[N, ...]``, ``weights`` ``[N]`` (participation /
    staleness weights; ones for the uniform Eq. 4 mean).
    """
    v = np.asarray(values)
    w = np.asarray(weights, v.dtype)
    e = v.shape[0] // int(n_edges)
    if edge_assignment(v.shape[0], n_edges).shape[0] != v.shape[0]:
        raise ValueError("bad edge assignment")  # pragma: no cover
    wv = v * w.reshape((-1,) + (1,) * (v.ndim - 1))
    sums = wv.reshape((int(n_edges), e) + v.shape[1:]).sum(axis=1)
    counts = w.reshape(int(n_edges), e).sum(axis=1)
    return sums, counts


def two_tier_mean(values, weights, n_edges: int) -> np.ndarray:
    """Cloud combine of the per-edge partials: ``sum_e s_e / sum_e c_e``
    with the survivor-count guard (count 0 -> divide by 1, matching the
    ``where(cnt > 0, cnt, 1)`` fold in `split.hasfl_round_update`)."""
    sums, counts = edge_partials(values, weights, n_edges)
    cnt = counts.sum()
    return sums.sum(axis=0) / (cnt if cnt > 0 else 1.0)


def flat_mean(values, weights) -> np.ndarray:
    """The single-tier survivor-renormalized mean (the reference side of
    the equivalence contract)."""
    v = np.asarray(values)
    w = np.asarray(weights, v.dtype)
    cnt = w.sum()
    num = (v * w.reshape((-1,) + (1,) * (v.ndim - 1))).sum(axis=0)
    return num / (cnt if cnt > 0 else 1.0)
