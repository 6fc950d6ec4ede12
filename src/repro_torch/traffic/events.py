"""Virtual-clock event machinery for the traffic plane.

``EventQueue`` is a deterministic min-heap over (time, insertion-order)
— ties break by insertion, never by payload comparison, so two runs of
the same seeded streams pop identical sequences.

``EventLog`` records the plane's full timeline (arrivals, admits,
evictions, departures, update deliveries, round closes) as parallel
numpy columns, and persists it with `training.checkpoint`'s atomic
tmp-then-rename + commit-marker helpers — the ``.json`` sidecar commits
the ``.npz``, and a crash mid-write leaves no half-readable log.  The
npz is written through a *file object* (`checkpoint.atomic_savez`):
``np.savez`` given a bare tmp filename would append ``.npz`` and break
the rename, which is why this module reuses the helper instead of
writing its own.  Port of `repro.traffic.events`, verbatim but for the
imports.
"""
from __future__ import annotations

import heapq
import os

import numpy as np

from repro_torch.training import checkpoint as ckpt

# event kinds, in stable id order (ids are persisted in the log npz)
KINDS = ("arrival", "admit", "evict", "depart", "deliver", "round")
_KIND_ID = {k: i for i, k in enumerate(KINDS)}

EVENT_LOG_VERSION = 1


class EventQueue:
    """Deterministic time-ordered heap: push(time, kind, payload)."""

    def __init__(self):
        self._heap = []
        self._n = 0

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, time: float, kind: str, payload) -> None:
        heapq.heappush(self._heap, (float(time), self._n, kind, payload))
        self._n += 1

    def peek_time(self) -> float:
        """Earliest queued time (+inf when empty)."""
        return self._heap[0][0] if self._heap else float("inf")

    def pop(self):
        """(time, kind, payload) of the earliest event."""
        time, _, kind, payload = heapq.heappop(self._heap)
        return time, kind, payload


class EventLog:
    """Append-only timeline of one traffic run.

    Rows: ``(time, round, kind, slot, user)`` with ``slot``/``user`` =
    -1 where not applicable.  Kept as python lists while recording (a
    few ints per event), converted to columns on save/summary.
    """

    def __init__(self):
        self.time: list = []
        self.round: list = []
        self.kind: list = []
        self.slot: list = []
        self.user: list = []

    def __len__(self) -> int:
        return len(self.time)

    def append(self, time: float, rnd: int, kind: str,
               slot: int = -1, user: int = -1) -> None:
        if kind not in _KIND_ID:
            raise ValueError(f"unknown event kind {kind!r}; known: {KINDS}")
        self.time.append(float(time))
        self.round.append(int(rnd))
        self.kind.append(_KIND_ID[kind])
        self.slot.append(int(slot))
        self.user.append(int(user))

    def counts(self) -> dict:
        """kind -> number of recorded events (admit/evict/deliver/...)."""
        kinds = np.asarray(self.kind, np.int64)
        return {k: int(np.sum(kinds == i)) for i, k in enumerate(KINDS)}

    # -- persistence (atomic, commit-markered) --------------------------

    def save(self, path: str) -> None:
        """Write ``<path>.npz`` + ``<path>.json`` (marker written last).

        Readers (`load`) only accept a log whose marker exists, so a
        crash between the two writes is indistinguishable from no log.
        """
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        ckpt.atomic_savez(path + ".npz", {
            "time": np.asarray(self.time, np.float64),
            "round": np.asarray(self.round, np.int64),
            "kind": np.asarray(self.kind, np.int64),
            "slot": np.asarray(self.slot, np.int64),
            "user": np.asarray(self.user, np.int64),
        })
        ckpt.atomic_json(path + ".json", {
            "event_log_version": EVENT_LOG_VERSION,
            "n_events": len(self),
            "kinds": list(KINDS),
        })

    @classmethod
    def load(cls, path: str) -> "EventLog":
        import json

        with open(path + ".json") as f:
            meta = json.load(f)
        if meta.get("event_log_version") != EVENT_LOG_VERSION:
            raise ValueError(
                f"event log version {meta.get('event_log_version')!r} != "
                f"supported {EVENT_LOG_VERSION}")
        log = cls()
        with np.load(path + ".npz") as data:
            log.time = [float(x) for x in data["time"]]
            log.round = [int(x) for x in data["round"]]
            log.kind = [int(x) for x in data["kind"]]
            log.slot = [int(x) for x in data["slot"]]
            log.user = [int(x) for x in data["user"]]
        if len(log) != meta["n_events"]:
            raise ValueError(
                f"event log npz holds {len(log)} events but the marker "
                f"committed {meta['n_events']}")
        return log
