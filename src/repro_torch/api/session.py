"""`Session`: assemble and run one `ExperimentSpec` on one device.

Port of `repro.api.session.Session` with the reference's assembly order:
one host RNG seeded from ``spec.seed`` feeds the partition, the sampler
and the device pool, in that order, and the simulator's own
``default_rng(seed)`` is the policy stream — so decisions, clocks and
gather plans match the reference bitwise for the same spec.

Sessions are single-shot: the simulator they wrap is stateful, so build a
fresh `Session` per run.  `Session.run_grid` runs many specs, folding each
grid-compatible group into one run (`repro_torch.api.grid`).

A spec with ``mesh`` runs on the default `torch.distributed` process
group, one process per device.  At ``mesh.devices`` 1 (or None) with no
group initialised, the session makes a world of one on its own device
from an in-memory store (NCCL on the card, gloo on the CPU); for d > 1
the caller starts d processes and calls ``init_process_group`` in each
with an explicit address, port, world size and rank (see
`repro_torch.mesh.launch`), and the session raises if the world size is
not ``mesh.devices``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.api import policies as policy_registry
from repro_torch.api import runners
from repro_torch.api.grid import group_cells, run_group
from repro_torch.api.spec import ExperimentSpec
from repro_torch.config import get_config
from repro_torch.core.latency import sample_devices
from repro_torch.core.profiles import model_profile
from repro_torch.core.sfl import SFLEdgeSimulator, SimResult
from repro_torch.data import (
    ClientSampler,
    make_cifar_like,
    partition_iid,
    partition_noniid_shards,
)
from repro_torch.device import disable_tf32, resolve
from repro_torch.mesh import sharded as SH
from repro_torch.models import build_model


class Session:
    """One runnable simulation cell, assembled from an `ExperimentSpec`.

    ``device=None`` runs on the card (raising without one); pass
    ``device="cpu"`` for the plain PyTorch paths.  On the card, TF32 is
    switched off for matmuls and convolutions process-wide, so every fp32
    product stays full fp32.  ``init_units`` (a unit list of numpy arrays
    or tensors, e.g. `repro_torch.convert.units_from_numpy` of the
    reference's ``Session(spec).sim.units``) replaces the port's own
    seeded init.
    """

    def __init__(self, spec: ExperimentSpec, device=None,
                 init_units: Optional[list] = None):
        spec = spec.validated()
        self.spec = spec
        self.device = resolve(device)
        if spec.mesh is not None:
            self.device = SH.join_group(spec.mesh, self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.cfg = get_config(spec.arch)
        base_policy, _ = policy_registry.parse_policy(spec.policy)
        if base_policy not in policy_registry.list_policies():
            raise KeyError(
                f"unknown policy {spec.policy!r}; "
                f"known: {policy_registry.list_policies()}"
            )

        self.model = build_model(self.cfg)
        rng = np.random.default_rng(spec.seed)
        train, test, shard_labels = self._build_data(spec)
        self._bank = None
        if spec.mesh is not None and spec.mesh.population is not None:
            # cohort-bank scale-out (DESIGN.md §15): the resident
            # simulator holds only the active cohort; every slot's data
            # pool is bound by the bank at attach/rotate time, so the
            # static partition over the logical population is never
            # materialized
            from repro_torch.mesh.bank import CohortBank
            from repro_torch.traffic.store import dummy_pool

            self.sampler = ClientSampler(
                train, [dummy_pool() for _ in range(spec.n_clients)], rng)
            self._bank = CohortBank(spec.mesh, n_resident=spec.n_clients,
                                    n_train=spec.n_train)
        else:
            if spec.partition == "iid":
                shards = partition_iid(spec.n_train, spec.n_clients, rng)
            else:
                shards = partition_noniid_shards(
                    shard_labels, spec.n_clients, rng)
            self.sampler = ClientSampler(train, shards, rng)
        self.sfl = spec.resolved_sfl
        self.profile = model_profile(self.cfg, seq_len=spec.seq_len)
        self.devices = sample_devices(spec.n_clients, rng)
        if init_units is not None:
            from repro_torch.convert import units_from_numpy

            init_units = units_from_numpy(init_units, self.device)
        self.sim = SFLEdgeSimulator(
            self.model,
            self.sampler,
            test,
            self.devices,
            self.sfl,
            self.profile,
            seed=spec.seed,
            update_impl=spec.update_impl,
            fault_mode=spec.fault_mode,
            deadline_factor=spec.deadline_factor,
            device=self.device,
            init_units=init_units,
            mesh=spec.mesh,
            cohort_bank=self._bank,
        )
        self.policy = policy_registry.make_policy(
            spec.policy,
            self.profile,
            self.sfl,
            estimate=spec.estimate,
            seed=spec.seed,
        )
        self._ran = False

    def _build_data(self, spec: ExperimentSpec):
        """(train arrays, test batch, labels for non-IID sharding)."""
        (xtr, ytr), (xte, yte) = make_cifar_like(
            self.cfg.n_classes,
            spec.n_train,
            spec.n_test,
            self.cfg.image_size,
            seed=spec.seed,
        )
        train = {"images": xtr, "labels": ytr}
        test = {"images": xte, "labels": yte}
        return train, test, ytr

    def _consume(self) -> None:
        """Mark this session as run (single-shot) or raise if it was."""
        if self._ran:
            raise RuntimeError(
                "Session already ran; sessions are single-shot — build a "
                "fresh Session from the spec to rerun"
            )
        self._ran = True

    def run(self, *, verbose: bool = False) -> SimResult:
        """Run this cell (single-shot)."""
        self._consume()
        return self.sim.run(
            self.policy,
            rounds=self.spec.rounds,
            eval_every=self.spec.eval_every,
            reconfigure_every=self.spec.reconfigure_every,
            verbose=verbose,
        )

    @classmethod
    def run_grid(
        cls,
        specs: Sequence[Union[ExperimentSpec, "Session"]],
        *,
        runner: Optional[str] = None,
        device=None,
        verbose: bool = False,
    ) -> List[SimResult]:
        """Run a grid of cells, folding compatible ones (DESIGN.md §10).

        Cells sharing `ExperimentSpec.grid_key()` — same model, data
        shapes, `SFLConfig`, round segmentation, kernel impls and fault
        mode; policy, seed and partition free — run as one folded run
        (`repro_torch.api.grid.run_group`).  Incompatible cells fall back
        to sequential `run()`.  Results come back in input order, each
        bitwise equal to running that cell alone.

        ``specs`` may hold built Sessions (one device for a group);
        specs are built on ``device`` (None: the card).  ``runner``:
        ``None``/``"grid"`` folds every compatible group; ``"sequential"``
        runs each cell alone; ``"auto"`` consults `api.runners` per group
        — it fills unset kernel impls (specs only: a built Session's are
        pinned) and picks grid or sequential per arch family and device.
        """
        if runner not in (None, "grid", "sequential", "auto"):
            raise ValueError(f"unknown runner {runner!r}")
        if runner == "auto":
            if any(isinstance(s, Session) for s in specs):
                raise ValueError(
                    "runner='auto' needs ExperimentSpecs (a built "
                    "Session's kernel impls are already pinned)")
            dev = resolve(device).type
            specs = [runners.apply_choice(s, dev) for s in specs]
        sessions = [s if isinstance(s, Session) else cls(s, device=device)
                    for s in specs]
        results: List[Optional[SimResult]] = [None] * len(sessions)
        for idxs in group_cells([s.spec for s in sessions]):
            members = [sessions[i] for i in idxs]
            lead = members[0]
            sequential = (
                len(members) == 1
                or runner == "sequential"
                or (runner == "auto" and runners.pick(
                    lead.spec, lead.device.type).runner == "sequential")
            )
            if sequential:
                for i, sess in zip(idxs, members):
                    results[i] = sess.run(verbose=verbose)
                continue
            for sess in members:
                sess._consume()
            for i, r in zip(idxs, run_group(members, verbose=verbose)):
                results[i] = r
        return results


def run_grid(
    specs: Sequence[Union[ExperimentSpec, Session]],
    *,
    runner: Optional[str] = None,
    device=None,
    verbose: bool = False,
) -> List[SimResult]:
    """Module-level alias for `Session.run_grid`."""
    return Session.run_grid(specs, runner=runner, device=device,
                            verbose=verbose)
