"""`Session`: assemble and run one `ExperimentSpec` on one device.

Port of `repro.api.session.Session` with the reference's assembly order:
one host RNG seeded from ``spec.seed`` feeds the partition, the sampler
and the device pool, in that order, and the simulator's own
``default_rng(seed)`` is the policy stream — so decisions, clocks and
gather plans match the reference bitwise for the same spec.

Sessions are single-shot: the simulator they wrap is stateful, so build a
fresh `Session` per run.  `Session.run_grid` runs many specs, folding each
grid-compatible group into one run (`repro_torch.api.grid`).  A spec with
``scenario`` runs on that preset's time-varying device pool; with
``checkpoint_every`` it writes crash-safe snapshots, and `Session.resume`
rebuilds a session from one that continues the run bitwise; with
``traffic`` it runs the semi-async streaming plane
(`repro_torch.traffic`), the plane's state folded into the snapshots.

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

import dataclasses
import json
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api import policies as policy_registry
from repro_torch.api import runners
from repro_torch.api.grid import group_cells, run_group
from repro_torch.api.spec import ExperimentSpec
from repro_torch.config import get_config
from repro_torch.core.latency import sample_devices
from repro_torch.core.profiles import model_profile
from repro_torch.core.sfl import SFLEdgeSimulator, SimResult, pow2_bucket
from repro_torch.data import (
    ClientSampler,
    make_cifar_like,
    make_lm_data,
    partition_iid,
    partition_noniid_shards,
)
from repro_torch.device import disable_tf32, resolve
from repro_torch.mesh import sharded as SH
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.utils.tree import tree_leaves


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
        self.cfg = get_config(spec.arch)
        if spec.mesh is not None:
            self.device = SH.join_group(spec.mesh, self.device)
        if self.device.type == "cuda":
            disable_tf32()
        base_policy, _ = policy_registry.parse_policy(spec.policy)
        if base_policy not in policy_registry.list_policies():
            raise KeyError(
                f"unknown policy {spec.policy!r}; "
                f"known: {policy_registry.list_policies()}"
            )
        if spec.scenario is not None:
            from repro_torch.scenarios import list_presets

            if spec.scenario not in list_presets():
                raise KeyError(
                    f"unknown scenario preset {spec.scenario!r}; "
                    f"known: {list_presets()}"
                )

        self.model = build_model(self.cfg)
        rng = np.random.default_rng(spec.seed)
        train, test, shard_labels = self._build_data(spec)
        self._bank = None
        self._plane = None
        self.sfl = spec.resolved_sfl
        n_slots = spec.n_clients
        if spec.traffic is not None:
            # streaming traffic (DESIGN.md §14): the simulator is built at
            # pow2 slot capacity with every slot bound to the dummy pool;
            # the plane admits the initial cohort (and every later
            # arrival's derived shard/profile) by slot surgery, so the
            # static partition is skipped entirely
            from repro_torch.traffic import TrafficPlane, dummy_pool

            n_slots = pow2_bucket(spec.n_clients)
            self.sampler = ClientSampler(
                train, [dummy_pool() for _ in range(n_slots)], rng)
            self.sfl = dataclasses.replace(self.sfl, n_devices=n_slots)
            self._plane = TrafficPlane(
                spec.traffic, n_train=spec.n_train,
                cohort=spec.n_clients, capacity=n_slots)
        elif spec.mesh is not None and spec.mesh.population is not None:
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
        self.profile = model_profile(self.cfg, seq_len=spec.seq_len)
        self.devices = sample_devices(n_slots, rng)
        if init_units is not None:
            from repro_torch.convert import units_from_numpy

            init_units = units_from_numpy(init_units, self.device, self.cfg)
        self.sim = SFLEdgeSimulator(
            self.model,
            self.sampler,
            test,
            self.devices,
            self.sfl,
            self.profile,
            seed=spec.seed,
            engine=spec.resolved_engine,
            update_impl=spec.update_impl,
            fault_mode=spec.fault_mode,
            deadline_factor=spec.deadline_factor,
            device=self.device,
            init_units=init_units,
            mesh=spec.mesh,
            cohort_bank=self._bank,
        )
        self.scenario = None
        if spec.scenario is not None:
            from repro_torch.scenarios import make_scenario

            self.scenario = make_scenario(
                spec.scenario, self.devices, seed=spec.scenario_seed)
        self.policy = policy_registry.make_policy(
            spec.policy,
            self.profile,
            self.sfl,
            estimate=spec.estimate,
            seed=spec.seed,
        )
        self._ran = False
        self._resume: Optional[dict] = None

    def _build_data(self, spec: ExperimentSpec):
        """(train arrays, test batch, labels for non-IID sharding)."""
        if self.cfg.is_cnn:
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
        if spec.partition != "iid":
            raise ValueError(
                "token architectures use synthetic LM data with no class "
                "labels; only partition='iid' is supported"
            )
        tokens, labels = make_lm_data(
            self.cfg.vocab_size,
            spec.n_train + spec.n_test,
            spec.seq_len,
            seed=spec.seed,
        )
        train = {
            "tokens": tokens[: spec.n_train],
            "labels": labels[: spec.n_train],
        }
        test = {
            "tokens": tokens[spec.n_train :],
            "labels": labels[spec.n_train :],
        }
        return train, test, None

    @property
    def engine(self) -> str:
        return self.sim.engine

    @property
    def plane(self):
        """The cell's `TrafficPlane` (None on synchronous specs) — the
        event log and slot state live here after `run()`."""
        return self._plane

    def _consume(self) -> None:
        """Mark this session as run (single-shot) or raise if it was."""
        if self._ran:
            raise RuntimeError(
                "Session already ran; sessions are single-shot — build a "
                "fresh Session from the spec to rerun"
            )
        self._ran = True

    # -- crash-safe snapshots (DESIGN.md §12) --------------------------------

    def _snapshot_cb(self, t: int, clock: float, b, cuts, res: SimResult):
        """Write the full run state at round ``t`` (atomic, tmp-then-
        rename — `training.checkpoint.save_snapshot`).

        Everything the resumed loop touches is captured: the stacked
        parameters (device tensors copied to the host), the decision in
        force, the metric/decision history, the two host RNG streams
        (sampling and policy), the controller's cross-boundary state and,
        on traffic cells, the plane's host state.  The scenario is *not*
        snapshotted — it regenerates its trace deterministically from
        ``spec.scenario_seed``.
        """
        leaves = tree_leaves(self.sim._stacked)
        arrays = {f"param_leaf_{i}": ckpt.to_numpy(x)
                  for i, x in enumerate(leaves)}
        arrays.update(
            b=np.asarray(b),
            cuts=np.asarray(cuts),
            res_rounds=np.asarray(res.rounds, np.int64),
            res_clock=np.asarray(res.clock, np.float64),
            res_train_loss=np.asarray(res.train_loss, np.float64),
            res_test_loss=np.asarray(res.test_loss, np.float64),
            res_test_acc=np.asarray(res.test_acc, np.float64),
            res_b_history=np.asarray(res.b_history),
            res_cut_history=np.asarray(res.cut_history),
        )
        meta = {
            "clock": float(clock),
            "structure": ckpt.structure(self.sim._stacked),
            "n_param_leaves": len(leaves),
            "rng_sampler": self.sampler.rng.bit_generator.state,
            "rng_sim": self.sim.rng.bit_generator.state,
            "spec": self.spec.to_dict(),
        }
        state_fn = getattr(self.policy, "state_dict", None)
        if state_fn is not None:
            meta["controller"] = state_fn()
        if self._plane is not None:
            # fold the plane's host state — slot sessions, event heap,
            # pool bindings, population cursor — into the same snapshot,
            # so `resume` replays the event walk bitwise
            tr_arrays, tr_meta = self._plane.state(self.sim.store)
            arrays.update(tr_arrays)
            meta["traffic"] = tr_meta
        ckpt.save_snapshot(self.spec.checkpoint_dir, t, arrays, meta)

    @torch.no_grad()
    def _restore_state(self, arrays: dict, meta: dict) -> None:
        """Load a snapshot back onto this (freshly built) session.  The
        parameters are copied into the stacked tensors the simulator
        already holds, so nothing that refers to them goes stale."""
        leaves = tree_leaves(self.sim._stacked)
        if meta["structure"] != ckpt.structure(self.sim._stacked):
            raise ValueError(
                "snapshot parameter tree does not match the spec's model "
                f"({meta['n_param_leaves']} leaves vs {len(leaves)})")
        for i, leaf in enumerate(leaves):
            leaf.copy_(ckpt.from_numpy(arrays[f"param_leaf_{i}"], leaf))
        self.sampler.rng.bit_generator.state = meta["rng_sampler"]
        self.sim.rng.bit_generator.state = meta["rng_sim"]
        if "controller" in meta:
            self.policy.load_state_dict(meta["controller"])
        if self._plane is not None:
            self._plane.restore(self.sim, arrays, meta["traffic"])
        res = SimResult(
            rounds=[int(x) for x in arrays["res_rounds"]],
            clock=[float(x) for x in arrays["res_clock"]],
            train_loss=[float(x) for x in arrays["res_train_loss"]],
            test_loss=[float(x) for x in arrays["res_test_loss"]],
            test_acc=[float(x) for x in arrays["res_test_acc"]],
            b_history=[np.asarray(r) for r in arrays["res_b_history"]],
            cut_history=[np.asarray(r) for r in arrays["res_cut_history"]],
        )
        self._resume = {
            "t": int(meta["step"]),
            "clock": float(meta["clock"]),
            "b": np.asarray(arrays["b"]),
            "cuts": np.asarray(arrays["cuts"]),
            "res": res,
        }

    @classmethod
    def resume(cls, spec: ExperimentSpec,
               checkpoint_dir: Optional[str] = None,
               step: Optional[int] = None, device=None) -> "Session":
        """Rebuild a session from the latest (or given) snapshot under
        ``checkpoint_dir`` (default: ``spec.checkpoint_dir``) on
        ``device`` (None: the card); its `run()` then continues
        bitwise-identically to an uninterrupted run of the same spec —
        same decision stream, clock floats, eval losses, and final
        parameters.  A snapshot written by a different spec is refused.
        """
        spec = spec.validated()
        path = checkpoint_dir or spec.checkpoint_dir
        if path is None:
            raise ValueError("no checkpoint_dir on the spec or the call")
        arrays, meta = ckpt.load_snapshot(path, step)
        saved = dict(meta["spec"])
        # the dir itself may legitimately differ (moved snapshots); the
        # json round-trip normalizes containers so the comparison sees
        # exactly what the snapshot recorded
        saved.pop("checkpoint_dir", None)
        ours = json.loads(json.dumps(spec.to_dict()))
        ours.pop("checkpoint_dir", None)
        if saved != ours:
            raise ValueError(
                "snapshot was written by a different spec; refusing to "
                "resume (diff keys: "
                f"{sorted(k for k in ours if saved.get(k) != ours[k])})")
        sess = cls(spec, device=device)
        sess._restore_state(arrays, meta)
        return sess

    # -- execution ----------------------------------------------------------

    def run(self, *, verbose: bool = False) -> SimResult:
        """Run this cell (single-shot)."""
        self._consume()
        snapshot_cb = self._snapshot_cb if self.spec.checkpoint_every \
            else None
        return self.sim.run(
            self.policy,
            rounds=self.spec.rounds,
            eval_every=self.spec.eval_every,
            reconfigure_every=self.spec.reconfigure_every,
            verbose=verbose,
            scenario=self.scenario,
            checkpoint_every=self.spec.checkpoint_every,
            snapshot_cb=snapshot_cb,
            resume=self._resume,
            traffic=self._plane,
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
        mode; policy, scenario, seed and partition free — run as one folded run
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
