"""MeshSpec: the declarative two-tier topology knob on ExperimentSpec.

A verbatim copy of `repro.mesh.spec` (dataclasses only), so spec files
written for the reference load here; the executable side lives in
`repro_torch.mesh.sharded`, where ``devices`` is the size of the
`torch.distributed` process group (one process per device).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MeshSpec:
    """Two-tier client -> edge-server -> cloud layout for one experiment.

    ``n_edges`` edge servers each own a contiguous block of
    ``n_clients / n_edges`` client slots; the device mesh shards the
    slot axis into ``devices`` equal slices, each holding whole edges
    (``n_edges % devices == 0``), so per-edge partial aggregation never
    crosses a shard.  ``population`` switches on the host-side cohort
    bank: logical clients 0..population-1 exist as seeded pool/profile
    derivations and only ``n_clients`` of them are resident per
    aggregation segment.

    - ``devices``: mesh size ``d`` (None = the process group's world
      size).
    - ``axis``: the mesh axis name the client dimension shards over
      (a label in the port: the process group is the axis).
    - ``n_edges``: edge-server count (1 = the flat paper topology).
    - ``population``: logical cohort size for the bank (None = off).
    - ``cohort_seed``: seeds the bank's rotation stream and the per-id
      pool/profile derivations (independent of ``ExperimentSpec.seed``
      so the resident-slot decision streams stay comparable).
    - ``edge_flops`` / ``edge_bw``: edge-server aggregation throughput
      (bit-adds/s) and edge->cloud relay bandwidth (bit/s) for the
      tiered clock; 0 = co-located (no extra term — the Eq. 38/39
      degenerate case stays bitwise).
    - ``tiered_latency``: account the clock per tier (straggler max per
      edge, then across edges) instead of the flat Eq. 38/39 barrier.
    """

    devices: Optional[int] = None
    axis: str = "clients"
    n_edges: int = 1
    population: Optional[int] = None
    cohort_seed: int = 23
    edge_flops: float = 0.0
    edge_bw: float = 0.0
    tiered_latency: bool = True

    def validated(self) -> "MeshSpec":
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"mesh.devices must be >= 1, got {self.devices}")
        if not self.axis or not isinstance(self.axis, str):
            raise ValueError("mesh.axis must be a non-empty axis name")
        if self.n_edges < 1:
            raise ValueError(f"mesh.n_edges must be >= 1, got {self.n_edges}")
        if self.devices is not None and self.n_edges % self.devices != 0:
            raise ValueError(
                f"mesh.n_edges {self.n_edges} must be a multiple of "
                f"mesh.devices {self.devices} — each device shard holds "
                "whole edge servers")
        if self.population is not None and self.population < 1:
            raise ValueError(
                f"mesh.population must be >= 1, got {self.population}")
        if self.edge_flops < 0 or self.edge_bw < 0:
            raise ValueError("mesh.edge_flops / mesh.edge_bw must be >= 0")
        return self

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        return cls(**d)
