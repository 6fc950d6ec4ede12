"""repro_torch.traffic — the slot-store pieces mesh mode needs.

Only the empty-slot dummy pool is ported (the cohort bank binds every
resident slot to it before admitting its first cohort); the traffic
plane, population and events are a later slice (ROADMAP.md queue 1).
"""
from repro_torch.traffic.store import DUMMY_BATCH, dummy_pool

__all__ = ["DUMMY_BATCH", "dummy_pool"]
