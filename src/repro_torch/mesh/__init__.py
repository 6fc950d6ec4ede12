"""repro_torch.mesh — shard the stacked client axis over a process group.

Port of `repro.mesh`.  Two-tier (client -> edge server -> cloud)
topology for the segment scheduler (DESIGN.md §15): `MeshSpec` declares
the tier layout, `sharded` runs the segment on one process per device so
each rank owns an N/d slice of client units, `topology` holds the pure
edge-assignment/partial-sum algebra, and `bank.CohortBank` keeps only
the sampled active cohort resident so the logical population grows on
fixed device memory.
"""
from repro_torch.mesh.bank import CohortBank
from repro_torch.mesh.spec import MeshSpec

__all__ = ["CohortBank", "MeshSpec"]
