"""Host-side cohort bank: a logical population behind fixed device slots.

Logical clients ``0..population-1`` exist only as seeded derivations
(data pool + device profile per id, the `repro.traffic.population`
idiom); exactly ``n_resident`` of them occupy device slots at a time.
At every aggregation boundary (``t % agg_interval == 0``) the bank
rotates the resident cohort:

- *scatter-back* is implicit — the boundary is agg-aligned, so the
  departing cohort's client-side state was just folded into the Eq. 7
  broadcast and every row already holds the aggregate;
- *gather on admit* is the broadcast download of that aggregate (row 0,
  which IS the aggregate — taking a mean over the identical rows would
  re-round it) to the incoming cohort, plus the slot surgery
  (`store.set_pool`) rebinding each slot's data shard and a
  `set_devices` rebind of the profiles.  Nothing changes shape.

Port of `repro.mesh.bank`; the per-id derivations and the rotation
stream are the reference's numpy, verbatim.  Under a process group each
rank holds the same bank (the host plane is replicated) and rebroadcasts
row 0 of its own client slice: after Eq. 7 that row holds the same
all-reduced aggregate on every rank.
"""
from __future__ import annotations

import numpy as np

import repro_torch.core.split as SP
from repro_torch.core.latency import sample_devices
from repro_torch.utils.tree import tree_map

_TAG_PROFILE = 0xE1
_TAG_SHARD = 0xE2


class CohortBank:
    """Samples ``n_resident``-sized cohorts from a logical population.

    ``rng`` (seeded by ``mesh.cohort_seed``) drives only the rotation
    stream — the simulator's own decision streams are untouched, and the
    gather plans draw once per (round, client) regardless of the bound
    pool, so resident-slot decisions stay comparable across cohorts.
    """

    def __init__(self, mspec, *, n_resident: int, n_train: int):
        mspec.validated()
        if mspec.population is None:
            raise ValueError("CohortBank needs mesh.population set")
        self.mspec = mspec
        self.population = int(mspec.population)
        self.n_resident = int(n_resident)
        self.n_train = int(n_train)
        if self.population < self.n_resident:
            raise ValueError(
                f"population {self.population} < resident cohort "
                f"{self.n_resident}")
        # per-id shards cover the dataset at population scale
        self.shard_size = max(1, -(-self.n_train // self.population))
        self.rng = np.random.default_rng(mspec.cohort_seed)
        self.resident: np.ndarray | None = None
        self.rotations = 0

    # -- per-id derivations (lazy, seeded, no per-id state) -------------

    def pool(self, lid: int) -> np.ndarray:
        """Logical client ``lid``'s data shard (sample indices)."""
        r = np.random.default_rng((self.mspec.cohort_seed, _TAG_SHARD, lid))
        return np.sort(r.choice(self.n_train, size=self.shard_size,
                                replace=False)).astype(np.int64)

    def profile(self, lid: int):
        """Logical client ``lid``'s device profile."""
        r = np.random.default_rng((self.mspec.cohort_seed, _TAG_PROFILE, lid))
        return sample_devices(1, r)[0]

    def sample_cohort(self) -> np.ndarray:
        return np.sort(self.rng.choice(self.population,
                                       size=self.n_resident, replace=False))

    # -- slot surgery ----------------------------------------------------

    def _bind(self, sim) -> None:
        for slot, lid in enumerate(self.resident):
            sim.store.set_pool(slot, self.pool(int(lid)))
        sim.set_devices([self.profile(int(lid)) for lid in self.resident])

    def attach(self, sim) -> None:
        """Admit the initial cohort (params are the shared init already —
        every logical client starts from the same broadcast)."""
        if sim.n != self.n_resident:
            raise ValueError(
                f"simulator has {sim.n} slots but the bank is sized "
                f"{self.n_resident}")
        self.resident = self.sample_cohort()
        self._bind(sim)

    def rotate(self, sim, t: int) -> None:
        """Swap the resident cohort at an agg-aligned segment boundary."""
        if t % sim.sfl.agg_interval != 0:
            raise ValueError(
                f"cohort rotation at t={t} is not agg-aligned "
                f"(interval {sim.sfl.agg_interval})")
        # row 0 is the aggregate every logical client holds post-Eq.7
        base = [tree_map(lambda a: a[0], u) for u in sim._stacked]
        self.resident = self.sample_cohort()
        self._bind(sim)
        sim._stacked = SP.replicate_units(base, sim.n_local)
        self.rotations += 1
