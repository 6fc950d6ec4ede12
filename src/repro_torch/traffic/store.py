"""Resizable client store: pow2-padded slots over the segment data plane.
Port of `repro.traffic.store`.

`SlotClientStore` completes the participation-vector data plane
(DESIGN.md §14): the stacked ``[N, ...]`` state is sized to a fixed
pow2 slot *capacity*, clients are admitted/evicted by rebinding a slot's
data pool (`DeviceClientStore.set_pool`) and writing parameters into the
slot row — every tensor shape a segment sees (stacked leaves, gather
plans, row masks, weight plans) is a function of the capacity alone, so
cohort churn never changes a shape the kernels are launched at.

Empty slots are not holes: they carry the 1-sample dummy pool and a
batch of 1, so their per-round gradient is *finite* (a masked-out NaN
would still poison the weighted survivor mean through ``0 * NaN``), and
their aggregation weight is exactly 0.0 — they contribute nothing and
hold (or track the broadcast of) their parameters until re-admission.

The reference's slot surgery is functional (``a.at[slot].set``); here
`write_slot` copies into the slot row of the simulator's stacked tensors
in place, on their device, so nothing that holds those tensors (the
segment's carry) goes stale.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.pipeline import DeviceClientStore
from repro_torch.utils.tree import tree_leaves, tree_map

# every empty slot trains on this many real samples (weight 0 — the
# update is discarded; >=1 keeps the per-slot loss/grad finite)
DUMMY_BATCH = 1


def dummy_pool() -> np.ndarray:
    """The empty slot's data pool: sample 0, batch of 1."""
    return np.zeros(DUMMY_BATCH, np.int64)


class SlotClientStore(DeviceClientStore):
    """A `DeviceClientStore` whose N axis is slot capacity, not cohort.

    Construction binds every slot to the dummy pool; the traffic plane
    admits users by `set_pool(slot, user_shard)` and evicts by
    rebinding the dummy pool.  All gather-plan/row-mask machinery is
    inherited unchanged — the segment scheduler cannot tell a slot store
    from a fixed cohort store (which is the point).
    """

    def __init__(self, arrays: dict, n_slots: int,
                 rng: np.random.Generator, device=None):
        super().__init__(
            arrays, [dummy_pool() for _ in range(int(n_slots))], rng,
            device)

    @classmethod
    def from_sampler(cls, sampler, device=None) -> "SlotClientStore":
        """Adopt a sampler already built with slot-dummy pools (shares
        arrays and the RNG object, like the base class)."""
        store = cls.__new__(cls)
        DeviceClientStore.__init__(
            store, sampler.arrays, sampler.client_indices, sampler.rng,
            device)
        return store


# -- stacked-state slot surgery (host-side, between segments) ---------------

@torch.no_grad()
def write_slot(stacked: list, slot: int, values: list) -> list:
    """Write one client's unit values into slot ``slot``, in place.

    ``stacked`` is the simulator's list of [N, ...]-stacked unit trees;
    ``values`` a matching list of *unstacked* unit trees (e.g. the live
    mean from `live_mean` — what an admitted client downloads).  Shapes
    and storage are untouched; returns ``stacked``.
    """
    slot = int(slot)
    for u, vu in zip(stacked, values):
        tree_map(lambda a, v: a[slot].copy_(v), u, vu)
    return stacked


@torch.no_grad()
def live_mean(stacked: list, live: np.ndarray) -> list:
    """Unweighted mean of every unit over the live slots — the aggregate
    model a joining client pulls (falls back to the all-slot mean when
    nothing is live: every slot then still tracks the last broadcast)."""
    live = np.asarray(live, bool)
    if live.all() or not live.any():
        return [tree_map(lambda a: a.mean(dim=0), u) for u in stacked]
    sel = torch.as_tensor(np.flatnonzero(live),
                          device=tree_leaves(stacked)[0].device)
    return [tree_map(lambda a: a.index_select(0, sel).mean(dim=0), u)
            for u in stacked]
