"""Declarative experiment descriptions (DESIGN.md §10).  Port of
`repro.api.spec`: the same fields, the same JSON form and the same
checks, so a spec file written for the reference loads here and runs on
the engine it names.

An `ExperimentSpec` is the *complete* recipe for one simulation cell —
model architecture, data partition, cohort size, `SFLConfig`, scenario
preset, policy name, seed, and run schedule.  It is frozen (hashable,
usable as a grouping key) and round-trips losslessly through JSON, so
the exact spec that produced a CSV can be committed next to it in
``experiments/`` and replayed bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional

from repro_torch.config import SFLConfig
from repro_torch.mesh.spec import MeshSpec
from repro_torch.traffic.population import TrafficSpec

# Bumped when fields change incompatibly; `from_dict` accepts any dict
# whose version matches and rejects unknown keys, so stale spec files
# fail loudly instead of silently dropping knobs.
SPEC_VERSION = 1

PARTITIONS = ("iid", "noniid-shards")
ENGINES = (None, "legacy", "vectorized", "scan")
# the reference's kernel impl names, so its spec files load; the port
# runs its kernels on the card and their plain versions on the CPU, and
# reads only update_impl (on the CPU: None = the inline update algebra)
CONV_IMPLS = (None, "kernel", "interpret", "im2col", "ref")
UPDATE_IMPLS = (None, "kernel", "interpret", "ref")
# fault_mode (DESIGN.md §12): "soft" = resource-floor degradation (full
# participation, the historical bitwise behavior); "dropout" = offline
# clients excluded from the round; "deadline" = dropout + straggler
# dropping at deadline_factor x the cohort median phase latency.
FAULT_MODES = ("soft", "dropout", "deadline")


@dataclass(frozen=True)
class ExperimentSpec:
    """One simulation cell, declaratively.

    ``sfl.n_devices`` is always overridden by ``n_clients`` at build
    time (one source of truth for the cohort size); every other
    `SFLConfig` knob (agg interval, lr, clip, server resources, the
    Assumption-2 priors) is taken verbatim.

    ``engine=None`` picks the round-scan engine, the only one
    `Session.run_grid` folds; ``"vectorized"`` and ``"legacy"`` run the
    reference's per-round engines of the same names.
    ``estimate`` enables the online G²/σ² re-estimation inside the
    HASFL controller (ignored by the non-adaptive policies).

    ``seq_len`` only applies to non-CNN (token) architectures, which
    train on synthetic LM data and support ``partition="iid"`` only.
    """

    arch: str = "vgg9-cifar-small"
    n_clients: int = 8
    partition: str = "noniid-shards"
    n_train: int = 1200
    n_test: int = 300
    seq_len: int = 32
    seed: int = 0
    policy: str = "hasfl"
    estimate: bool = True
    scenario: Optional[str] = None
    scenario_seed: int = 7
    rounds: int = 60
    eval_every: int = 10
    reconfigure_every: Optional[int] = None
    engine: Optional[str] = None
    # kernel knobs (DESIGN.md §11): part of the recipe because they
    # change the executable (and, for conv_impl, the numerics at fp32
    # tolerance), so committed spec files pin them.  On the card the port
    # runs both kernels whatever they say (`repro_torch.api.runners`).
    conv_impl: Optional[str] = None
    update_impl: Optional[str] = None
    # fault semantics (DESIGN.md §12): how the round treats unavailable /
    # straggling clients.  deadline_factor only applies to "deadline".
    fault_mode: str = "soft"
    deadline_factor: float = 2.0
    # crash-safe snapshots: every `checkpoint_every` rounds the scan
    # engine writes a full Session snapshot (params + RNG streams +
    # controller state + clock) to `checkpoint_dir`; `Session.resume`
    # continues bitwise-identically from the latest one.  0 disables.
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    # streaming traffic (DESIGN.md §14): a `TrafficSpec` switches the
    # cell to semi-async rounds over a live population — the simulator
    # is built at pow2 slot capacity and `n_clients` becomes the active
    # cohort cap.  None is the synchronous path, bit-for-bit unchanged.
    traffic: Optional[TrafficSpec] = None
    # device-mesh scale-out (DESIGN.md §15): a `MeshSpec` shards the
    # client axis of the stacked units over a process group (one process
    # per device) with hierarchical edge->cloud aggregation;
    # `mesh.population` adds
    # the host-side cohort bank (logical N beyond resident slots).
    # None is the single-device path, bit-for-bit unchanged.
    mesh: Optional[MeshSpec] = None
    sfl: SFLConfig = SFLConfig(lr=0.05)

    # -- validation ---------------------------------------------------------

    def validated(self) -> "ExperimentSpec":
        """Raise ``ValueError`` on structurally invalid field values.

        Name resolution that needs registries (arch, policy, scenario
        preset) happens at `Session` build time, where the registries
        are already imported; this check is dependency-free so specs
        can be validated wherever they are authored.
        """
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"unknown partition {self.partition!r}; known: {PARTITIONS}"
            )
        if self.engine not in ENGINES:
            raise ValueError(
                f"unknown engine {self.engine!r}; known: {ENGINES}"
            )
        if self.n_clients < 1:
            raise ValueError("n_clients must be >= 1")
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if self.eval_every < 1:
            raise ValueError("eval_every must be >= 1")
        if self.reconfigure_every is not None and self.reconfigure_every < 1:
            raise ValueError("reconfigure_every must be >= 1 or None")
        if self.conv_impl not in CONV_IMPLS:
            raise ValueError(
                f"unknown conv_impl {self.conv_impl!r}; known: {CONV_IMPLS}"
            )
        if self.update_impl not in UPDATE_IMPLS:
            raise ValueError(
                f"unknown update_impl {self.update_impl!r}; "
                f"known: {UPDATE_IMPLS}"
            )
        if self.fault_mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault_mode {self.fault_mode!r}; known: {FAULT_MODES}"
            )
        if not self.deadline_factor > 0:
            raise ValueError("deadline_factor must be > 0")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if self.checkpoint_every and self.checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every > 0 needs a checkpoint_dir to write to"
            )
        if self.checkpoint_every and self.resolved_engine != "scan":
            raise ValueError(
                "checkpointing is a segment-boundary feature — "
                "engine='scan' (or None) only"
            )
        if not isinstance(self.sfl, SFLConfig):
            raise ValueError("sfl must be an SFLConfig")
        if self.traffic is not None:
            if not isinstance(self.traffic, TrafficSpec):
                raise ValueError("traffic must be a TrafficSpec or None")
            self.traffic.validated()
            if self.resolved_engine != "scan":
                raise ValueError(
                    "traffic mode is a segment-boundary feature — "
                    "engine='scan' (or None) only")
            if self.fault_mode != "soft":
                raise ValueError(
                    "traffic mode owns its fault semantics — "
                    "fault_mode='soft' only")
            if self.n_clients > 64:
                raise ValueError(
                    "traffic mode caps the active cohort at 64 slots")
        if self.mesh is not None:
            if not isinstance(self.mesh, MeshSpec):
                raise ValueError("mesh must be a MeshSpec or None")
            self.mesh.validated()
            if self.resolved_engine != "scan":
                raise ValueError(
                    "mesh mode shards the scan carry — "
                    "engine='scan' (or None) only")
            if self.fault_mode != "soft":
                raise ValueError(
                    "mesh mode supports fault_mode='soft' only (the "
                    "dropout/deadline participation plans are not yet "
                    "shard-aware)")
            if self.traffic is not None:
                raise ValueError(
                    "mesh and traffic modes are mutually exclusive — "
                    "both own the slot axis")
            if self.checkpoint_every:
                raise ValueError(
                    "mesh mode does not support checkpointing yet "
                    "(sharded carry snapshots)")
            if self.n_clients % self.mesh.n_edges != 0:
                raise ValueError(
                    f"n_clients {self.n_clients} must be divisible by "
                    f"mesh.n_edges {self.mesh.n_edges}")
            if (self.mesh.population is not None
                    and self.mesh.population < self.n_clients):
                raise ValueError(
                    f"mesh.population {self.mesh.population} must be >= "
                    f"n_clients {self.n_clients} (the resident cohort)")
            if self.mesh.population is not None and self.scenario is not None:
                raise ValueError(
                    "cohort-bank runs (mesh.population) cannot ride a "
                    "scenario preset — traces are per resident slot, not "
                    "per logical client")
        return self

    # -- derived views ------------------------------------------------------

    @property
    def resolved_engine(self) -> str:
        return self.engine or "scan"

    @property
    def resolved_sfl(self) -> SFLConfig:
        """The run's `SFLConfig` with ``n_devices`` pinned to the cohort."""
        return dataclasses.replace(self.sfl, n_devices=self.n_clients)

    @property
    def resolved_reconfigure_every(self) -> int:
        return self.reconfigure_every or self.sfl.agg_interval

    def replace(self, **overrides) -> "ExperimentSpec":
        return dataclasses.replace(self, **overrides)

    def grid_key(self):
        """Hashable compatibility key for grid grouping (`Session.run_grid`,
        `repro_torch.api.grid.group_cells`).

        Cells sharing this key execute the same program on the same
        shapes and round segmentation.  ``None`` means the cell cannot
        be grouped (non-scan engine, or per-cell host side effects).
        """
        if self.resolved_engine != "scan":
            return None
        if self.checkpoint_every:
            # snapshot side effects are per-cell host state
            return None
        if self.traffic is not None:
            # the traffic plane mutates per-cell host state between
            # segments — DESIGN.md §14
            return None
        if self.mesh is not None:
            # refuse to stack: the sharded segment runs on one process
            # group, and the cohort bank rotates slot bindings host-side
            # between segments — DESIGN.md §15
            return None
        return (
            self.arch,
            self.n_clients,
            self.n_train,
            self.n_test,
            self.seq_len,
            self.resolved_sfl,
            self.rounds,
            self.eval_every,
            self.resolved_reconfigure_every,
            # different kernel impls are different executables (and
            # different numerics) — never stack them in one grid
            self.conv_impl,
            self.update_impl,
            # fault semantics change the participation plan fed to the
            # segment — never stack different fault modes in one grid
            self.fault_mode,
            self.deadline_factor,
        )

    # -- JSON round-trip ----------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spec_version"] = SPEC_VERSION
        return d

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        version = d.pop("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(
                f"spec version {version} != supported {SPEC_VERSION}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown spec fields: {sorted(unknown)}")
        if isinstance(d.get("sfl"), dict):
            d["sfl"] = SFLConfig(**d["sfl"])
        if isinstance(d.get("mesh"), dict):
            d["mesh"] = MeshSpec(**d["mesh"])
        if isinstance(d.get("traffic"), dict):
            d["traffic"] = TrafficSpec(**d["traffic"])
        return cls(**d).validated()

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())


def save_specs(path: str, specs) -> None:
    """Write a JSON array of specs (one sweep's grid) next to its CSV."""
    with open(path, "w") as f:
        json.dump([s.to_dict() for s in specs], f, indent=2, sort_keys=True)
        f.write("\n")


def load_specs(path: str) -> list:
    with open(path) as f:
        return [ExperimentSpec.from_dict(d) for d in json.load(f)]
