"""The traffic plane: semi-async rounds over a live user population.

Port of `repro.traffic.plane`: the same numpy event walk, with the slot
surgery of `repro_torch.traffic.store` on torch tensors.

`TrafficPlane` sits between the population model and the segment
scheduler (DESIGN.md §14).  It owns the virtual clock, the event queue, and the
per-slot session state; the simulator's segment scheduler asks it for

- ``plan_segment`` — walk the event timeline across a segment of server
  rounds and return the ``[R, capacity]`` float32 *staleness-weight
  plan* that rides the existing participation-vector lane into
  `split.hasfl_round_update` (weight 0 = slot contributed nothing this
  round, fractional = stale delivery down-weighted by
  ``w(tau) = 1/(1+tau)^alpha``);
- ``apply_boundary`` — admit/evict users by slot surgery between
  segments (pool rebind + parameter row write), which never changes a
  tensor shape.

Semi-async semantics: every live slot computes continuously at its own
pace (per-client unbarriered durations from
`LatencyModel.per_client_round`); the server closes round ``r`` after
``max(1, ceil(buffer_frac * n_live))`` update *deliveries* (FedBuff-
style buffered aggregation — counting deliveries rather than distinct
slots cannot livelock when one fast slot keeps delivering while the
rest sit in an outage).  A delivery's staleness ``tau`` is the number
of server rounds closed since that slot last pulled; the slot pulls
and restarts immediately after delivering.  The delivered gradient is
computed against the slot's *held* client-side parameters and the
*current* server-side parameters — exactly the split-learning dataflow,
where the server-side forward/backward runs server-side at delivery
time while the client-side sub-model is whatever the client last
pulled.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.config import DeviceProfile
from repro_torch.scenarios.traces import FIELDS
from repro_torch.traffic.events import KINDS, EventLog, EventQueue
from repro_torch.traffic.population import Population, TrafficSpec, staleness_weight
from repro_torch.traffic.store import dummy_pool, live_mean, write_slot


class TrafficPlane:
    """Event-driven scheduler for one semi-async training run.

    ``capacity`` is the slot count (the simulator's N — pow2-padded by
    the session so churn stays shape-stable); ``cohort`` caps how many
    users may be admitted concurrently (the small active cohort
    sampled from the population, <= capacity).
    """

    def __init__(self, tspec: TrafficSpec, n_train: int, cohort: int,
                 capacity: int):
        self.tspec = tspec.validated()
        self.pop = Population(tspec, n_train)
        self.cohort = int(cohort)
        self.capacity = int(capacity)
        if not 0 < self.cohort <= self.capacity:
            raise ValueError(
                f"cohort {cohort} must be in [1, capacity {capacity}]")
        self.clock = 0.0
        self.queue = EventQueue()
        self.log = EventLog()
        # per-slot session state (host-side, tiny)
        self.live = np.zeros(self.capacity, bool)
        self.busy = np.zeros(self.capacity, bool)
        self.user = np.full(self.capacity, -1, np.int64)
        self.last_sync = np.zeros(self.capacity, np.int64)
        self.t_done = np.full(self.capacity, np.inf)
        self.base_profile: list = [None] * self.capacity
        self._fallback: Optional[list] = None       # construction-time pool
        self._pending_admit: list = []              # [(uid, dwell)]
        self._pending_evict: list = []              # [(slot, uid)]
        self._round = 0

    # -- wiring ---------------------------------------------------------

    def attach(self, sim, scenario=None, resume=False) -> None:
        """Bind to a scan-engine simulator and admit the initial cohort.

        ``resume=True`` (a restored run) only validates the wiring and
        re-derives the construction-time fallback pool — the slot state,
        event heap, and population cursor were already restored onto
        this plane (`restore`), and the snapshot round's admit surgery
        already happened before the snapshot was taken.
        """
        if sim.engine != "scan":
            raise ValueError("traffic mode needs engine='scan'")
        if sim.fault_mode != "soft":
            raise ValueError(
                "traffic mode owns its own fault semantics — the simulator "
                "must run fault_mode='soft'")
        if sim.n != self.capacity:
            raise ValueError(
                f"simulator has {sim.n} slots but the plane expects "
                f"capacity {self.capacity}")
        if scenario is not None and scenario.n != self.capacity:
            raise ValueError(
                f"scenario models {scenario.n} lanes but the plane expects "
                f"capacity {self.capacity}")
        self._fallback = list(sim.devices)
        if resume:
            return
        self._pending_admit.extend(self.pop.initial_cohort(self.cohort))
        self.apply_boundary(sim, 0)

    def live_mask(self) -> np.ndarray:
        return self.live.copy()

    def effective_batches(self, b) -> np.ndarray:
        """Per-slot batch plan: the policy's b_i on live slots, the
        1-sample dummy batch on empty ones (finite grads at weight 0)."""
        return np.where(self.live, np.asarray(b, int), 1)

    # -- environment injection ------------------------------------------

    def inject_profiles(self, sim, scenario, t: int) -> None:
        """Install round ``t``'s per-slot device pool into the simulator.

        Slot i's resources = its admitted user's base profile (the
        construction pool for empty slots) times the scenario's round-t
        multiplier on lane i — churn-admitted users ride the same trace
        processes the fixed-cohort runs see.
        """
        mult = scenario.multipliers_at(t) if scenario is not None else None
        profiles = []
        for i in range(self.capacity):
            base = self.base_profile[i] or self._fallback[i]
            if mult is None:
                profiles.append(base)
            else:
                profiles.append(DeviceProfile(**{
                    f: float(getattr(base, f) * mult[f][i]) for f in FIELDS
                }))
        sim.set_devices(profiles)

    # -- event walk ------------------------------------------------------

    def _step_external(self) -> float:
        """Process the earliest queued departure or population arrival;
        returns that event's absolute time."""
        if self.queue.peek_time() <= self.pop.peek_arrival():
            t_ev, kind, payload = self.queue.pop()
            if kind == "depart":
                slot, uid = payload
                if self.live[slot] and self.user[slot] == uid:
                    self._depart(t_ev, slot, uid)
            return t_ev
        t_ar, uid, dwell = self.pop.next_arrival()
        self.log.append(t_ar, self._round, "arrival", user=uid)
        if len(self._pending_admit) + int(self.live.sum()) < self.cohort:
            self._pending_admit.append((uid, dwell))
        return t_ar

    def _depart(self, t_ev: float, slot: int, uid: int) -> None:
        self.log.append(t_ev, self._round, "depart", slot=slot, user=uid)
        self.live[slot] = False
        self.busy[slot] = False
        self.t_done[slot] = np.inf
        self.user[slot] = -1
        self._pending_evict.append((slot, uid))

    def plan_segment(self, sim, scenario, t0: int, nxt: int,
                     b_eff, cuts) -> np.ndarray:
        """Walk rounds (t0, nxt] on the virtual clock.

        Returns the ``[nxt - t0, capacity]`` staleness-weight plan the
        segment consumes as its participation input.  Mutates the plane's
        clock/slot state and the simulator's injected device pool (the
        last injected state is round ``nxt``'s — what a reconfiguration
        policy firing at the boundary should observe).
        """
        alpha = self.tspec.staleness_alpha
        R = nxt - t0
        plan = np.zeros((R, self.capacity), np.float32)
        for k in range(R):
            r = t0 + k + 1
            self._round = r
            self.inject_profiles(sim, scenario, r)
            dur = sim.lat.per_client_round(b_eff, cuts)
            # launch every idle live slot (fresh admits after a boundary;
            # within a segment deliverers restart themselves)
            start = self.live & ~self.busy
            self.busy |= start
            self.t_done[start] = self.clock + dur[start]

            delivered = 0
            while True:
                n_live = int(self.live.sum())
                if n_live == 0:
                    if delivered:
                        break          # close the round on what arrived
                    # nobody can deliver: the server idles until an
                    # arrival is waiting for the next admission boundary
                    # and closes the round empty at that instant (the
                    # clock never moves backwards — a backlogged past
                    # arrival admits "now")
                    while not self._pending_admit:
                        self.clock = max(self.clock, self._step_external())
                    break
                k_target = max(
                    1, math.ceil(self.tspec.buffer_frac * n_live))
                if delivered >= k_target:
                    break
                t_next = float(np.min(self.t_done[self.busy])) \
                    if self.busy.any() else np.inf
                t_ext = min(self.queue.peek_time(), self.pop.peek_arrival())
                if t_ext < t_next:
                    # external events advance the clock too (a departure
                    # observed at t means time reached t); deliveries
                    # below stay monotone because externals only run
                    # while t_ext < the next delivery time
                    self.clock = max(self.clock, self._step_external())
                    continue
                i = int(np.argmin(np.where(self.busy, self.t_done, np.inf)))
                self.clock = float(self.t_done[i])
                tau = max(0, (r - 1) - int(self.last_sync[i]))
                plan[k, i] = staleness_weight(tau, alpha)
                delivered += 1
                self.last_sync[i] = r
                self.log.append(self.clock, r, "deliver", slot=i,
                                user=int(self.user[i]))
                # pull fresh params and restart at this round's duration
                self.t_done[i] = self.clock + dur[i]
            self.log.append(self.clock, r, "round")
        return plan

    # -- boundary slot surgery ------------------------------------------

    def apply_boundary(self, sim, t: int) -> None:
        """Admit/evict between segments (host-side, shape-stable).

        Evicted slots get the dummy pool back; admitted users get their
        derived shard + base profile, and their parameter row is set to
        the *pre-admit* live mean — the aggregate model a joining client
        downloads (the init broadcast when nothing is live yet).
        """
        for slot, uid in self._pending_evict:
            sim.store.set_pool(slot, dummy_pool())
            self.base_profile[slot] = None
            self.log.append(self.clock, t, "evict", slot=slot, user=uid)
        self._pending_evict.clear()

        if not self._pending_admit:
            return
        free = [i for i in range(self.capacity) if not self.live[i]]
        take = min(len(free),
                   self.cohort - int(self.live.sum()),
                   len(self._pending_admit))
        if take <= 0:
            return
        pulled = live_mean(sim._stacked, self.live)
        for slot in free[:take]:
            uid, dwell = self._pending_admit.pop(0)
            write_slot(sim._stacked, slot, pulled)
            sim.store.set_pool(slot, self.pop.user_shard(uid))
            self.base_profile[slot] = self.pop.user_profile(uid)
            self.live[slot] = True
            self.busy[slot] = False
            self.t_done[slot] = np.inf
            self.last_sync[slot] = t
            self.user[slot] = uid
            self.queue.push(self.clock + dwell, "depart", (slot, uid))
            self.log.append(self.clock, t, "admit", slot=slot, user=uid)

    # -- snapshot round-trip (rides the Session checkpoint, §14/§15) ----

    def state(self, store) -> tuple:
        """``(arrays, meta)`` capturing the plane's full host state.

        Everything the event walk depends on: per-slot session state,
        the event heap (entries + insertion counter — tie-breaks are
        part of determinism), pending admit/evict surgery, the event
        log columns, the store's per-slot pool bindings (flattened +
        offsets: ragged), and the population's RNG/arrival cursor.
        ``arrays`` rides the snapshot npz via `ckpt.atomic_savez`,
        ``meta`` the json marker via `ckpt.atomic_json` — both through
        the Session's existing atomic writers.
        """
        heap = sorted(self.queue._heap)
        pools = [np.asarray(p, np.int64) for p in store.client_indices]
        arrays = {
            "tr_live": self.live.copy(),
            "tr_busy": self.busy.copy(),
            "tr_user": self.user.copy(),
            "tr_last_sync": self.last_sync.copy(),
            "tr_t_done": self.t_done.copy(),
            "tr_q_time": np.asarray([h[0] for h in heap], np.float64),
            "tr_q_seq": np.asarray([h[1] for h in heap], np.int64),
            "tr_q_kind": np.asarray(
                [KINDS.index(h[2]) for h in heap], np.int64),
            "tr_q_slot": np.asarray([h[3][0] for h in heap], np.int64),
            "tr_q_uid": np.asarray([h[3][1] for h in heap], np.int64),
            "tr_admit_uid": np.asarray(
                [u for u, _ in self._pending_admit], np.int64),
            "tr_admit_dwell": np.asarray(
                [d for _, d in self._pending_admit], np.float64),
            "tr_evict_slot": np.asarray(
                [s for s, _ in self._pending_evict], np.int64),
            "tr_evict_uid": np.asarray(
                [u for _, u in self._pending_evict], np.int64),
            "tr_log_time": np.asarray(self.log.time, np.float64),
            "tr_log_round": np.asarray(self.log.round, np.int64),
            "tr_log_kind": np.asarray(self.log.kind, np.int64),
            "tr_log_slot": np.asarray(self.log.slot, np.int64),
            "tr_log_user": np.asarray(self.log.user, np.int64),
            "tr_pool_flat": (np.concatenate(pools) if pools
                             else np.zeros(0, np.int64)),
            "tr_pool_len": np.asarray([len(p) for p in pools], np.int64),
        }
        meta = {
            "clock": float(self.clock),
            "round": int(self._round),
            "queue_n": int(self.queue._n),
            "pop_rng": self.pop.rng.bit_generator.state,
            "pop_t_next": float(self.pop._t_next),
        }
        return arrays, meta

    def restore(self, sim, arrays: dict, meta: dict) -> None:
        """Inverse of `state`, onto a freshly-constructed plane + sim.

        Rebinds the simulator's store pools (slot surgery — the same
        `set_pool` path churn uses, so shapes stay stable) and leaves
        the plane exactly as the snapshot's event walk left it; the
        parameter rows themselves ride the Session snapshot.
        """
        import heapq

        self.clock = float(meta["clock"])
        self._round = int(meta["round"])
        self.live = np.asarray(arrays["tr_live"]).astype(bool).copy()
        self.busy = np.asarray(arrays["tr_busy"]).astype(bool).copy()
        self.user = np.asarray(arrays["tr_user"], np.int64).copy()
        self.last_sync = np.asarray(
            arrays["tr_last_sync"], np.int64).copy()
        self.t_done = np.asarray(arrays["tr_t_done"], np.float64).copy()
        self.queue = EventQueue()
        self.queue._heap = [
            (float(t), int(s), KINDS[int(k)], (int(sl), int(u)))
            for t, s, k, sl, u in zip(
                arrays["tr_q_time"], arrays["tr_q_seq"],
                arrays["tr_q_kind"], arrays["tr_q_slot"],
                arrays["tr_q_uid"])
        ]
        heapq.heapify(self.queue._heap)
        self.queue._n = int(meta["queue_n"])
        self._pending_admit = [
            (int(u), float(d)) for u, d in zip(
                arrays["tr_admit_uid"], arrays["tr_admit_dwell"])]
        self._pending_evict = [
            (int(s), int(u)) for s, u in zip(
                arrays["tr_evict_slot"], arrays["tr_evict_uid"])]
        self.log = EventLog()
        self.log.time = [float(x) for x in arrays["tr_log_time"]]
        self.log.round = [int(x) for x in arrays["tr_log_round"]]
        self.log.kind = [int(x) for x in arrays["tr_log_kind"]]
        self.log.slot = [int(x) for x in arrays["tr_log_slot"]]
        self.log.user = [int(x) for x in arrays["tr_log_user"]]
        # population cursor: generator state + the peeked arrival time
        self.pop.rng.bit_generator.state = meta["pop_rng"]
        self.pop._t_next = float(meta["pop_t_next"])
        # slot surgery: rebind every pool exactly as the snapshot held it
        offsets = np.cumsum(
            np.concatenate([[0], np.asarray(arrays["tr_pool_len"])]))
        flat = np.asarray(arrays["tr_pool_flat"], np.int64)
        for slot in range(self.capacity):
            sim.store.set_pool(
                slot, flat[offsets[slot]:offsets[slot + 1]])
        # base profiles re-derive from the admitted users (seeded)
        self.base_profile = [
            self.pop.user_profile(int(u)) if self.live[i] else None
            for i, u in enumerate(self.user)
        ]
