"""Population model: millions of registered users as *distributions*.
Port of `repro.traffic.population`, verbatim but for the imports.

The streaming traffic plane (DESIGN.md §14) never materializes the
registered population.  A user is an integer id in ``[0, n_users)``;
everything about them — device profile, local data shard, session
length — is derived on demand from a seeded per-user RNG
(``default_rng((seed, tag, uid))``), so a million-user population costs
O(active cohort) memory while staying bitwise reproducible.

Arrivals are a Poisson process on the virtual clock (exponential
inter-arrival gaps at ``arrival_rate``); each admitted session lives an
``Exponential(mean_dwell)`` dwell before departing.  Both streams come
from one seeded generator, drawn lazily in event order, so two runs of
the same `TrafficSpec` see identical user timelines (the AsyncFlow
request-generator idiom, SNIPPETS.md §1-2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.config import DeviceProfile
from repro_torch.core.latency import sample_devices

# per-user RNG stream tags (stable: changing them changes every derived
# profile/shard, i.e. the whole population)
_TAG_PROFILE = 0xB5
_TAG_SHARD = 0xD4


@dataclass(frozen=True)
class TrafficSpec:
    """Streaming-traffic recipe for one `ExperimentSpec` cell.

    Frozen and JSON round-trippable (scalars only) — it rides inside
    `ExperimentSpec.traffic` and is committed next to result CSVs.

    ``arrival_rate`` is expected user arrivals per virtual *second* (the
    latency model's unit), ``mean_dwell`` the mean session length in
    virtual seconds.  ``buffer_frac`` sets the semi-async server's
    aggregation trigger: a server round closes after
    ``max(1, ceil(buffer_frac * n_live))`` client update deliveries
    (FedBuff-style buffered aggregation).  ``staleness_alpha`` is the
    alpha of the staleness weight ``w(tau) = 1/(1+tau)^alpha``; 0 gives
    every delivery weight 1.0 — the synchronous survivor mean, bitwise
    (tests/test_torch_traffic.py).  ``shard_size`` is the number of
    training samples in each user's local shard, ``seed`` the traffic
    plane's own stream (independent of the cell seed so the same
    population can be replayed across model seeds).
    """

    n_users: int = 1_000_000
    arrival_rate: float = 0.05
    mean_dwell: float = 2000.0
    buffer_frac: float = 0.5
    staleness_alpha: float = 0.5
    shard_size: int = 150
    seed: int = 11

    def validated(self) -> "TrafficSpec":
        if self.n_users < 1:
            raise ValueError("traffic.n_users must be >= 1")
        if not self.arrival_rate > 0:
            # the arrival stream is what keeps the event walk live when
            # every slot is empty — a rate of 0 could deadlock the round
            raise ValueError("traffic.arrival_rate must be > 0")
        if not self.mean_dwell > 0:
            raise ValueError("traffic.mean_dwell must be > 0")
        if not 0.0 < self.buffer_frac <= 1.0:
            raise ValueError("traffic.buffer_frac must be in (0, 1]")
        if self.staleness_alpha < 0:
            raise ValueError("traffic.staleness_alpha must be >= 0")
        if self.shard_size < 1:
            raise ValueError("traffic.shard_size must be >= 1")
        return self


def staleness_weight(tau: int, alpha: float) -> float:
    """``w(tau) = 1/(1+tau)^alpha`` — the semi-async aggregation weight.

    ``tau`` is the number of server rounds that closed while the client
    was computing (0 = delivered against the round it pulled).  alpha=0
    degenerates to 1.0 for every tau: the synchronous survivor mean.
    """
    return float((1.0 + max(0, int(tau))) ** -float(alpha))


class Population:
    """The registered user population behind one traffic plane.

    Owns the seeded arrival stream and the per-user derivations.  The
    arrival stream is consumed lazily (`next_arrival`), so the object
    stays O(1) regardless of how far the virtual clock runs.
    """

    def __init__(self, tspec: TrafficSpec, n_train: int):
        self.tspec = tspec.validated()
        self.n_train = int(n_train)
        self.rng = np.random.default_rng(tspec.seed)
        self._t_next = float(self.rng.exponential(1.0 / tspec.arrival_rate))

    # -- arrival/departure stream ------------------------------------------

    def peek_arrival(self) -> float:
        """Absolute time of the next (unconsumed) arrival."""
        return self._t_next

    def next_arrival(self):
        """Consume one arrival: ``(time, uid, dwell)``.

        Times are absolute virtual seconds and strictly increasing;
        ``dwell`` is the session length measured from *admission* (a
        user waiting for a free slot doesn't burn dwell).
        """
        t = self._t_next
        uid = int(self.rng.integers(self.tspec.n_users))
        dwell = float(self.rng.exponential(self.tspec.mean_dwell))
        self._t_next = t + float(
            self.rng.exponential(1.0 / self.tspec.arrival_rate))
        return t, uid, dwell

    def initial_cohort(self, k: int):
        """``k`` seed users present at virtual time 0: ``[(uid, dwell)]``.

        Drawn from the same stream as arrivals so the whole population
        timeline stays a single seeded sequence.
        """
        out = []
        for _ in range(int(k)):
            uid = int(self.rng.integers(self.tspec.n_users))
            dwell = float(self.rng.exponential(self.tspec.mean_dwell))
            out.append((uid, dwell))
        return out

    # -- per-user derived state (never materialized population-wide) -------

    def _user_rng(self, tag: int, uid: int) -> np.random.Generator:
        return np.random.default_rng((self.tspec.seed, tag, int(uid)))

    def user_profile(self, uid: int) -> DeviceProfile:
        """The user's device resources — a Table-I draw keyed by uid."""
        return sample_devices(1, self._user_rng(_TAG_PROFILE, uid))[0]

    def user_shard(self, uid: int) -> np.ndarray:
        """The user's local data: ``shard_size`` sample indices keyed by
        uid (without replacement when the train set allows)."""
        rng = self._user_rng(_TAG_SHARD, uid)
        k = min(self.tspec.shard_size, self.n_train)
        return np.sort(rng.choice(self.n_train, size=k, replace=False))
