"""Empty-slot data pools (port of `repro.traffic.store`: `DUMMY_BATCH`
and `dummy_pool` only).

Empty slots are not holes: they carry the 1-sample dummy pool and a
batch of 1, so their per-round gradient is *finite* (a masked-out NaN
would still poison the weighted survivor mean through ``0 * NaN``).
"""
from __future__ import annotations

import numpy as np

# every empty slot trains on this many real samples (weight 0 — the
# update is discarded; >=1 keeps the per-slot loss/grad finite)
DUMMY_BATCH = 1


def dummy_pool() -> np.ndarray:
    """The empty slot's data pool: sample 0, batch of 1."""
    return np.zeros(DUMMY_BATCH, np.int64)
