"""The policy x scenario x seed grid runner (port of `repro.api.grid`,
DESIGN.md §10, §13).

`run_group` executes a list of *compatible* sessions — same
`ExperimentSpec.grid_key()`: same model architecture and data shapes,
same `SFLConfig`, same round segmentation, kernel impls and fault mode;
policy, scenario, seed and partition are free axes — as one run.  The
reference stacks the cells on a leading grid axis and dispatches each
segment as a ``vmap`` of the scan engine's body.  The port has no
``vmap``: it *folds* the cell axis into the client axis instead.  G cells
of N clients become one carry of ``[G·N, ...]`` leaves (cell g's clients
at rows ``[g·N, (g+1)·N)``), and each segment's rounds run once over it
(`SFLEdgeSimulator.run_rounds` with ``cells=G``): on the card every conv
is one GEMM launch for all cells and every round one clip+SGD launch (per
64 (cell, leaf) entries).

Seed crossing: cells built from different seeds carry different data,
model inits, device pools and host RNG streams.  All but the data are
per-cell state already (each `Session` is built alone before folding), so
a seed-crossing group lays its members' arrays end to end
(`DeviceClientStore.stack_arrays`) and offsets each cell's gather plan to
its own samples (`DeviceClientStore.fold_plan`); a same-seed group reads
the one store's arrays.

Bitwise contract (tests/test_torch_grid.py, ``chip_smoke.py``'s
``grid_cross``): each cell's decisions, simulated clock, eval losses and
accuracies and final parameters equal its own `Session.run()`'s to the
bit.  What makes it hold:

- per-cell arithmetic: every op of the folded round computes each cell
  as its own run does.  Elementwise ops and gathers do so by nature; the
  GEMM keeps each cell's split-K plan (``plan_n``); the clip+SGD kernel
  takes one table entry per (cell, leaf), each mean over its own N rows;
  the library reductions and GEMMs whose plan may follow the leading
  extent (clip norms, bias gradients, the FC layers, the loss means) run
  cell by cell (`utils.cells.by_cell`);
- host-side parity: clocks, policy decisions, participation plans and
  the RNG index streams advance through each cell's own simulator, on its
  own scenario's trace states, with the code `run()` uses
  (`_scenario_tick`, `_segment_participation`, `_advance_clock`,
  `DeviceClientStore.segment_indices`, the policies);
- bucket sub-grouping: a cell's gather plan is padded to its OWN
  ``pow2_bucket(b_max)`` (padding wider regroups the batch reduction), so
  cells whose b_max falls in different buckets run as separate folded
  sub-carries, gathered from the carry and scattered back after the
  segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.sfl import SimResult, pow2_bucket
from repro_torch.data.pipeline import DeviceClientStore
from repro_torch.utils.cells import fold, rows
from repro_torch.utils.tree import tree_map


def group_cells(specs) -> list:
    """Partition spec indices into grid-compatible groups, order-stable.

    Returns a list of index lists; specs with ``grid_key() is None``
    stay singletons and fall back to sequential `Session.run()` —
    non-scan engines, checkpointed cells, and traffic-enabled cells
    (the traffic plane's event walk rebinds store pools and rewrites
    parameter rows between scan dispatches: per-cell host state the
    vmapped mega-run cannot replay — the DESIGN.md §14 refuse-to-stack
    rule).
    """
    order, groups = [], {}
    for i, spec in enumerate(specs):
        key = spec.grid_key()
        if key is None:
            order.append([i])
            continue
        if key not in groups:
            groups[key] = []
            order.append(groups[key])
        groups[key].append(i)
    return order


@dataclass(frozen=True)
class Dispatch:
    """One folded segment of a group: rounds ``(t0, t0 + rounds]`` of the
    ``members`` (indices into the group), padded to ``b_pad``."""

    t0: int
    rounds: int
    b_pad: int
    members: Tuple[int, ...]


def run_group(sessions, *, verbose: bool = False) -> List[SimResult]:
    """Run grid-compatible sessions as one folded run.

    The walk is the segment scheduler of `SFLEdgeSimulator.run` lifted
    over a cell axis: one shared clock loop chops the round range at
    eval/reconfiguration boundaries, each segment dispatches once per
    b_max bucket, and all per-cell host state (clocks, policies, RNG
    streams, metric records) advances through the cells' own simulators,
    so single-spec semantics hold exactly.  At every boundary each cell's
    ``sim._stacked`` is pointed at its views of the carry before its
    policy and eval read it.  ``run_group.dispatches`` holds the last
    call's dispatches (`Dispatch` records), replaced at every call.
    """
    run_group.dispatches = dispatches = []
    sims = [s.sim for s in sessions]
    sim0 = sims[0]
    spec0 = sessions[0].spec
    if any(s.device != sim0.device for s in sims):
        raise ValueError("a grid's cells must share one device")
    n_cells, n = len(sessions), sim0.n
    rounds = spec0.rounds
    eval_every = spec0.eval_every
    reconf = spec0.resolved_reconfigure_every
    faulty = spec0.fault_mode != "soft"
    uniform_data = len({s.spec.seed for s in sessions}) == 1
    arrays_cache: dict = {}

    def arrays_for(members):
        """(arrays, n_train offset) of one member sub-group's dispatch:
        the shared store on the same-seed path, the members' own arrays
        end to end otherwise (cached: bucket partitions recur)."""
        if uniform_data:
            return sim0.store.arrays, None
        key = tuple(members)
        if key not in arrays_cache:
            arrays_cache[key] = DeviceClientStore.stack_arrays(
                [sims[g].store for g in members])
        n_train = len(next(iter(sim0.store.arrays.values())))
        return arrays_cache[key], n_train

    def plans(members, t, nxt, b_pad):
        """The members' folded gather plan and row mask, their [G, U]
        unit masks and (faulty modes) the [R, G·N] participation plan,
        each drawn through the cell's own simulator as `run()` draws it."""
        seg = nxt - t
        idx, rmask, masks, parts = [], [], [], []
        for g in members:
            b, cuts = decisions[g]
            masks.append(sims[g]._unit_masks(cuts))
            idx.append(sims[g].store.segment_indices(seg, b, b_pad))
            rmask.append(sims[g].store.row_mask(b, b_pad))
            if faulty:
                parts.append(sims[g]._segment_participation(
                    t, nxt, b, cuts, sessions[g].scenario))
        arrays, n_train = arrays_for(members)
        idx, rmask = DeviceClientStore.fold_plan(idx, rmask, n_train)
        masks = np.stack(masks)
        return (arrays, idx, rmask, masks if len(members) > 1 else masks[0],
                np.concatenate(parts, axis=1) if faulty else None)

    res = [SimResult() for _ in range(n_cells)]
    clocks = [0.0] * n_cells
    decisions = []
    for g, sess in enumerate(sessions):
        sims[g]._scenario_tick(sess.scenario, 0)
        b, cuts = sess.policy(sims[g], sims[g].rng)
        sims[g]._record_policy(res[g], b, cuts)
        decisions.append((np.asarray(b), np.asarray(cuts)))

    carry = fold([sim._stacked for sim in sims])
    for g in range(n_cells):
        sims[g]._stacked = rows(carry, g, n)

    t = 0
    while t < rounds:
        nxt = sim0._next_boundary(t, eval_every, reconf, rounds)
        buckets = {}
        for g, (b, _) in enumerate(decisions):
            buckets.setdefault(pow2_bucket(int(np.max(b))), []).append(g)

        seg_losses = [None] * n_cells
        for b_pad, members in sorted(buckets.items()):
            arrays, idx, rmask, masks, parts = plans(members, t, nxt, b_pad)
            whole = len(members) == n_cells
            sub = carry if whole else fold(
                [rows(carry, g, n) for g in members])
            sub, losses = sim0.run_rounds(
                sub, arrays, t, idx, rmask, masks, parts,
                cells=len(members))
            if whole:
                carry = sub
            else:
                for j, g in enumerate(members):
                    tree_map(lambda a, b: a.copy_(b), rows(carry, g, n),
                             rows(sub, j, n))
            for j, g in enumerate(members):
                seg_losses[g] = losses[:, j * n:(j + 1) * n]
            dispatches.append(Dispatch(t, nxt - t, b_pad, tuple(members)))

        for g, sess in enumerate(sessions):
            b, cuts = decisions[g]
            clocks[g] = sims[g]._advance_clock(clocks[g], t, nxt, b, cuts,
                                               sess.scenario)
        t = nxt

        at_reconf = t % reconf == 0 and t < rounds
        at_eval = t % eval_every == 0 or t == rounds
        if at_reconf or at_eval:
            # the policies (online G²/σ² estimation) and eval read the
            # live per-cell state through the cell's own simulator
            for g in range(n_cells):
                sims[g]._stacked = rows(carry, g, n)
        if at_reconf:
            for g, sess in enumerate(sessions):
                b, cuts = sess.policy(sims[g], sims[g].rng)
                sims[g]._record_policy(res[g], b, cuts)
                decisions[g] = (np.asarray(b), np.asarray(cuts))
        if at_eval:
            for g in range(n_cells):
                sims[g]._record_metrics(
                    res[g], t, clocks[g], seg_losses[g][-1], verbose)

    for g in range(n_cells):
        sims[g]._stacked = rows(carry, g, n)
    return res


run_group.dispatches = []
