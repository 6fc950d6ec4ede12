"""Streaming traffic plane (DESIGN.md §14), port of `repro.traffic`.

Event-driven arrivals over a million-user population, a resizable
slot store on the simulator's stacked state, and semi-async
staleness-weighted rounds — `TrafficPlane` ties the three together.
"""
from repro_torch.traffic.events import KINDS, EventLog, EventQueue
from repro_torch.traffic.plane import TrafficPlane
from repro_torch.traffic.population import (
    Population,
    TrafficSpec,
    staleness_weight,
)
from repro_torch.traffic.store import (
    DUMMY_BATCH,
    SlotClientStore,
    dummy_pool,
    live_mean,
    write_slot,
)

__all__ = [
    "KINDS",
    "EventLog",
    "EventQueue",
    "TrafficPlane",
    "Population",
    "TrafficSpec",
    "staleness_weight",
    "DUMMY_BATCH",
    "SlotClientStore",
    "dummy_pool",
    "live_mean",
    "write_slot",
]
