"""The SFL/HASFL edge simulator in PyTorch.  Port of
`repro.core.sfl.SFLEdgeSimulator` with its three round engines.

N heterogeneous clients with per-client batch b_i and cut c_i; the
server-common sub-model is aggregated every round (Eq. 4), the
client-specific sub-models every I rounds (Eq. 7); the wall clock
advances by the Eq. 28-40 latency model and metrics come from a held-out
set.  Within a round, split execution computes exactly the gradients of
full-model execution, so the simulator computes per-client full-model
gradients and applies HASFL's per-component update rules (DESIGN.md §2).

The engines share the host plane (policy calls, clock, draws, metrics)
and the update rule; they differ in how a round reaches the device:

- ``scan``: `run()` is a segment scheduler, as the reference's scan
  engine: the round range is chopped at eval / reconfiguration
  boundaries, each segment's gather plan is pre-drawn from the
  authoritative host RNG, and the segment's rounds run as a Python loop
  on the device.  Per round: gather the padded per-client batch
  (`DeviceClientStore.device_batch`), one backward of the *sum* of the
  stacked per-client losses (every conv through the client-batched
  GEMM), the per-client fp32 clip factor, and the fused HASFL update.
  The stacked parameter tensors are updated in place — the analogue of
  the reference's donated scan carry — and the per-round losses stay on
  the device until the segment's eval fetches them.
- ``vectorized`` (the default when ``engine`` is unset, as in the
  reference): one round at a time over the same ``[N, ...]`` stack and
  the same round body; each round's batches are drawn on the host with
  `ClientSampler.sample` in client order, padded to that round's
  ``b_max``, stacked and uploaded once.
- ``legacy``: the reference's per-client loop over N separate unit
  lists: each client's clipped gradient of the single-model loss, then
  the update as the reference's loop algebra (`_legacy_round`).

A scenario (``run(scenario=)``, DESIGN.md §9) prices each round and
draws its participation on that round's trace state, on every engine.
The rest is the scan engine's alone, as in the reference:
``checkpoint_every`` adds segment boundaries at which ``snapshot_cb``
fires, and ``resume`` continues a run from a restored snapshot bitwise
(DESIGN.md §12); a traffic plane (``run(traffic=)``, DESIGN.md §14) turns
the run into semi-async rounds over a live population (`_run_traffic`).

Mesh mode (``mesh=``, DESIGN.md §15) runs the scan scheduler on every
rank of a `torch.distributed` process group: each rank holds an ``N/d``
slice of the stacked units, replicates the host plane, and combines the
Eq. 4/7 mean across ranks (`core.split.two_tier_common`); the clock
follows the tiered Eq. 28-39 model and an optional `mesh.CohortBank`
rotates a logical population through the resident slots.

A token arch runs on its unit list (embedding, one unit a super-block
repetition, head): the stacked engines through the model's
client-stacked ``stacked_loss``, whose per-client losses carry the MoE
load-balance term, the legacy engine through its ``loss``; its eval is
per token.  `make_hasfl_train_step` is the reference's SPMD HASFL step on
one device, for every token family.

The scheduler, each round's phases and the eval are marked by
`repro_torch.trace.span`s (a flag check when no profiler runs), and each
segment or per-round round counts its padded and useful rows
(`count_rows`).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import SFLConfig, DeviceProfile
from repro_torch.core import split as SP
from repro_torch.core.latency import LatencyModel
from repro_torch.core.profiles import LayerProfile
from repro_torch.data.pipeline import DeviceClientStore
from repro_torch.device import resolve
from repro_torch.models.factory import Model
from repro_torch.trace import count, span
from repro_torch.training.optim import make_optimizer
from repro_torch.utils.cells import by_cell
from repro_torch.utils.tree import tree_leaves, tree_map


def count_rows(rounds: int, pad: int, real, parts=None) -> None:
    """Count ``rounds`` rounds' rows: every client's batch padded to ``pad``
    rows is computed (``rows_computed``); of those, the real rows (``real``,
    [N] a client each round) of the clients that the participation plan
    ``parts`` ([rounds, N]; None: every client) keeps are useful
    (``rows_useful``)."""
    real = np.asarray(real)
    count("rows_computed", rounds * real.size * pad)
    count("rows_useful", rounds * real.sum() if parts is None
          else ((np.asarray(parts) > 0) * real).sum())


def pow2_bucket(n: int) -> int:
    """Round a segment's batch maximum up to the next power of two (the
    reference's scan-engine padding, kept so gather plans and padded
    shapes match it; the extra columns carry loss-mask zeros)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass
class SimResult:
    rounds: List[int] = field(default_factory=list)
    clock: List[float] = field(default_factory=list)      # simulated seconds
    train_loss: List[float] = field(default_factory=list)
    test_acc: List[float] = field(default_factory=list)
    test_loss: List[float] = field(default_factory=list)
    b_history: List[np.ndarray] = field(default_factory=list)
    cut_history: List[np.ndarray] = field(default_factory=list)

    def converged_time(self, window: int = 5, tol: float = 0.0002) -> float:
        """Paper's criterion: accuracy improves < tol over `window` evals."""
        acc = self.test_acc
        for k in range(window, len(acc)):
            if max(acc[k - window:k + 1]) - acc[k - window] < tol:
                return self.clock[k]
        return self.clock[-1] if self.clock else float("inf")


EVAL_LOGITS = 1 << 28   # fp32 logits a chunk of a token model's eval


def clip_scale_from_norm(norm, clip: float):
    """min(1, clip/norm) — the clip rule."""
    return torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, clip: float):
    """Scale a gradient tree so its global L2 norm is at most ``clip``
    (``clip=0`` disables)."""
    if not clip:
        return grads
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    scale = clip_scale_from_norm(norm, clip)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def _with_grad(tree):
    """Fresh autograd leaves sharing storage with ``tree``'s tensors."""
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


def _grads(tree):
    """The gradients of `_with_grad` leaves after a backward.  An empty
    leaf (the stack of a prefix or suffix of no repetitions) takes no part
    in the loss: its gradient is an empty tensor, as ``jax.grad``'s."""
    return tree_map(lambda a: torch.zeros_like(a) if a.numel() == 0
                    else a.grad, tree)


class SFLEdgeSimulator:
    """Paper-faithful edge simulation on one device, with three equivalent
    round engines (``engine``: ``"scan"``, ``"vectorized"`` — the default
    when unset, as in the reference — or ``"legacy"``; the module's note
    says how they differ).  The pre-scan ``vectorized`` bool is deprecated
    (`DeprecationWarning`): it still maps to ``"vectorized"``/``"legacy"``
    when ``engine`` is unset.

    ``device`` picks the card (default) or, when asked, the CPU; on the
    card every conv and every stacked engine's update leaf runs through
    the hand-written kernels whatever ``update_impl`` says.  On the CPU the
    convs take the GEMM's plain version, and ``update_impl=None`` keeps
    the inline plain update algebra (any other value: the fused op's plain
    version).  The legacy engine has no stacked state and ignores
    ``update_impl``, as the reference's: its update is the reference's
    per-client loop algebra (`_legacy_round`).
    ``init_units`` (a unit list of tensors) replaces the port's own seeded
    init — how parity tests carry the reference's weights across.

    ``mesh`` (a `MeshSpec`) shards the client axis over the initialised
    default process group (soft faults only); ``cohort_bank`` (a
    `mesh.CohortBank`, mesh mode only) rotates its logical population
    through the ``N`` resident slots at agg-aligned segment boundaries.
    """

    def __init__(
        self, model: Model, sampler, test_batch: dict,
        devices: Sequence[DeviceProfile], sfl: SFLConfig,
        profile: LayerProfile, seed: int = 0,
        vectorized: Optional[bool] = None,
        engine: Optional[str] = None,
        update_impl: Optional[str] = None,
        fault_mode: str = "soft",
        deadline_factor: float = 2.0,
        device=None,
        init_units: Optional[list] = None,
        mesh=None,
        cohort_bank=None,
    ):
        self.device = resolve(device)
        self.model = model
        self.cfg = model.cfg
        self.sampler = sampler
        self.test_batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                           for k, v in test_batch.items()}
        self.devices = list(devices)
        self.sfl = sfl
        self.profile = profile
        self.lat = LatencyModel(profile, devices, sfl)
        self.n = len(devices)
        self.available = np.ones(self.n, bool)
        self.rng = np.random.default_rng(seed)
        if vectorized is not None:
            # the pre-scan bool, kept as an alias so old drivers run; the
            # engine name is the real API
            warnings.warn(
                "SFLEdgeSimulator(vectorized=...) is deprecated; pass "
                "engine='vectorized'/'legacy' (or leave engine unset for "
                "the default) instead",
                DeprecationWarning, stacklevel=2)
            if engine is None:
                engine = "vectorized" if vectorized else "legacy"
        if engine is None:
            engine = "vectorized"
        if engine not in ("legacy", "vectorized", "scan"):
            raise ValueError(f"unknown round engine {engine!r}")
        self.engine = engine
        self.vectorized = engine != "legacy"
        # Mesh mode (DESIGN.md §15): shard the stacked client axis over a
        # process group with two-tier Eq. 4/7 aggregation; scan engine
        # and soft faults only (the dropout/deadline planners reason over
        # the flat barrier, not the tiered one).
        self.mesh_spec = mesh
        self._shard = None
        self._group = None
        self._edge_size = None
        self._bank = None
        if mesh is not None:
            mesh.validated()
            if engine != "scan":
                raise ValueError("mesh mode needs engine='scan'")
            if fault_mode != "soft":
                raise ValueError(
                    "mesh mode v1 runs fault_mode='soft' — tiered "
                    "dropout/deadline planning is not implemented")
            if self.n % mesh.n_edges != 0:
                raise ValueError(
                    f"n_edges {mesh.n_edges} must divide the cohort "
                    f"size {self.n}")
        elif cohort_bank is not None:
            raise ValueError("cohort_bank rides mesh mode; pass mesh=")
        # Fault semantics (DESIGN.md §12): "soft" = full participation;
        # "dropout" excludes unavailable clients; "deadline" also drops
        # clients whose Eq. 38 phase latency exceeds deadline_factor x the
        # cohort median, and advances the clock at the deadline.
        if fault_mode not in ("soft", "dropout", "deadline"):
            raise ValueError(f"unknown fault_mode {fault_mode!r}")
        if fault_mode == "deadline" and not deadline_factor > 0:
            raise ValueError("deadline_factor must be > 0")
        self.fault_mode = fault_mode
        self.deadline_factor = float(deadline_factor)
        self._update_ops_impl = ("kernel" if self.device.type == "cuda"
                                 else update_impl)

        if init_units is None:
            gen = torch.Generator().manual_seed(seed)
            params = model.init(gen, self.device)
        else:
            # each leaf keeps its type (a token model's bf16 weights)
            params = SP.from_units(self.cfg, tree_map(
                lambda a: a.to(self.device), list(init_units)))
        self.units, self.rebuild = SP.to_units(self.cfg, params)
        self._segment_fn = self._run_segment
        self.n_local = self.n
        if mesh is not None:
            from repro_torch.mesh.sharded import (build_process_mesh,
                                                  make_sharded_segment)

            self._shard = build_process_mesh(mesh, self.n)
            self._group = self._shard.group
            self._edge_size = self.n // mesh.n_edges
            self.n_local = self._shard.n_local
            self._segment_fn = make_sharded_segment(self, self._shard)
        if self.vectorized:
            self._stacked = SP.replicate_units(self.units, self.n_local)
        else:
            # one list of units a client, each in storage of its own
            self._client_units = [tree_map(torch.clone, self.units)
                                  for _ in range(self.n)]
        if engine == "scan":
            # the per-round engines draw through ``sampler`` itself: a
            # store sharing its RNG must never draw for them
            self.store = DeviceClientStore.from_sampler(sampler, self.device)
        if cohort_bank is not None:
            self._bank = cohort_bank
            cohort_bank.attach(self)

    @property
    def client_units(self):
        """Per-client unit lists of this rank's clients.

        On the stacked engines a read-only snapshot: nested tuples of
        views into the ``[N, ...]`` tensors, so item assignment (which
        could never write back to the stacked state) raises.  On the
        legacy engine the mutable lists themselves: construct with
        ``engine="legacy"`` to patch client parameters.  No two clients
        share a tensor there, so an in-place edit of one client's leaf
        leaves the others alone.
        """
        if self.vectorized:
            return tuple(tuple(units) for units in
                         SP.unstack_unit_trees(self._stacked, self.n_local))
        return self._client_units

    # -- single-model loss / grad / eval ------------------------------------
    def _grad_fn(self, units, batch):
        """((loss, aux), clipped grads) of the single-model loss at
        ``units`` on a host ``batch`` — what the HASFL controller's online
        G²/σ² estimate reads."""
        units = _with_grad(list(units))
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                 for k, v in batch.items()}
        loss, aux = self.model.loss(self.rebuild(units), batch)
        loss.backward()
        grads = tree_map(lambda a: a.grad, units)
        return ((loss.detach(), aux),
                clip_by_global_norm(grads, self.sfl.clip_norm))

    @torch.no_grad()
    def _eval(self, units, batch):
        """(mean test loss, accuracy) of one model: per image, or per
        token for a token model's ``[B, S, V]`` logits.  A token model's
        test set goes through the model `EVAL_LOGITS` logits at a time
        (whole sequences; at least one), the sums added chunk by chunk:
        smollm-135m's 512 × 128 test tokens are 12.9 GB of fp32 logits at
        once."""
        params = self.rebuild(units)
        labels = batch["labels"]
        if labels.dim() == 1:
            return self._eval_terms(params, batch)
        per_row = labels[0].numel() * self.cfg.vocab_size
        step = max(1, EVAL_LOGITS // per_row)
        loss = acc = 0.0
        for r0 in range(0, labels.shape[0], step):
            part = {k: v[r0:r0 + step] for k, v in batch.items()}
            lc, ac = self._eval_terms(params, part, mean=False)
            loss, acc = loss + lc, acc + ac
        return loss / labels.numel(), acc / labels.numel()

    def _eval_terms(self, params, batch, mean: bool = True):
        """The (loss, accuracy) means of ``batch`` — or, with ``mean``
        off, their sums."""
        logits, _ = self.model.apply(params, batch)
        labels = batch["labels"].long()
        hit = (logits.argmax(-1) == labels).float()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])
        if mean:
            return nll.mean(), hit.mean()
        return nll.sum(), hit.sum()

    # -- unit-space helpers ---------------------------------------------------
    def _unit_cuts(self, cuts_layers: np.ndarray) -> np.ndarray:
        return np.asarray([
            SP.layer_cut_to_unit_cut(self.cfg, int(c))
            for c in cuts_layers
        ], int)

    # -- the round ------------------------------------------------------------
    def _client_grads(self, stacked, batch, cells: int = 1):
        """Per-client (losses [N], raw grads, clip scale [N]): one backward
        of the sum of the stacked per-client losses (client i's slice only
        touches loss i), and the per-client fp32 global-norm clip factor
        returned separately so the update fuses it.  ``cells=G`` folds G
        cells of N clients into the leading axis; the loss's library ops
        and the clip norms then run cell by cell
        (`utils.cells.by_cell`)."""
        leaves = _with_grad(stacked)
        cell = None if cells == 1 \
            else tree_leaves(leaves[0])[0].shape[0] // cells
        with span("round.forward"):
            losses = self.model.stacked_loss(leaves, batch, cell_size=cell)
        with span("round.backward"):
            losses.sum().backward()
        grads = tree_map(lambda a: a.grad, leaves)
        scale = None
        if self.sfl.clip_norm:
            with span("round.clip"):
                norm = by_cell(lambda *gs: torch.sqrt(sum(
                    torch.sum(torch.square(g.float()),
                              dim=tuple(range(1, g.dim())))
                    for g in gs)), cell, *tree_leaves(grads))
                scale = clip_scale_from_norm(norm, self.sfl.clip_norm)
        return losses.detach(), grads, scale

    def _round(self, stacked, batch, masks, do_agg: bool, part=None,
               cells: int = 1):
        """One HASFL round over the stacked units; returns (the updated
        units, losses [N])."""
        losses, grads, scale = self._client_grads(stacked, batch, cells)
        with span("round.update"):
            stacked = SP.hasfl_round_update(
                stacked, grads, masks, do_agg, self.sfl.lr,
                grad_scale=scale, impl=self._update_ops_impl,
                participation=part, group=self._group,
                edge_size=self._edge_size, cells=cells)
        return stacked, losses

    def _run_segment(self, t0: int, idx, row_mask, masks, parts=None):
        """Rounds (t0, t0 + R] of this simulator's clients on the device;
        the losses come back as one [R, N] device tensor."""
        self._stacked, losses = self.run_rounds(
            self._stacked, self.store.arrays, t0, idx, row_mask, masks,
            parts)
        return losses

    def run_rounds(self, stacked, arrays, t0: int, idx, row_mask, masks,
                   parts=None, cells: int = 1):
        """Rounds (t0, t0 + R] over ``stacked`` on the device: the plan
        ``idx`` ([R, N, b_pad] indices into ``arrays``), the row mask and
        the participation ([R, N]) go up once, the losses come back as one
        [R, N] device tensor.  The every-I flag comes from the running
        counter.  Returns (the updated units, the losses).

        ``cells=G`` runs the grid runner's folded carry: G cells of N
        clients on one leading axis of G·N rows, with ``masks`` ``[G,
        U]``; every cell's rounds are computed as by its own run."""
        interval = self.sfl.agg_interval
        count_rows(idx.shape[0], idx.shape[2], np.asarray(row_mask).sum(1),
                   parts)
        with span("segment.upload"):
            idx_d = torch.as_tensor(idx).to(self.device, torch.long)
            mask_d = torch.as_tensor(row_mask).to(self.device)
            parts_d = None if parts is None else \
                torch.as_tensor(parts).to(self.device)
        losses = []
        t = t0
        for r in range(idx.shape[0]):
            t += 1
            with span("round", t):
                with span("round.gather"):
                    batch = DeviceClientStore.device_batch(arrays, idx_d[r],
                                                           mask_d)
                stacked, loss = self._round(
                    stacked, batch, masks, (t % interval) == 0,
                    None if parts_d is None else parts_d[r], cells)
            losses.append(loss)
        return stacked, torch.stack(losses)

    def _vectorized_round(self, b, cuts, do_agg: bool, part=None):
        """One round of the vectorized engine: every client's batch drawn
        with `ClientSampler.sample` in client order and padded to the
        round's ``b_max``, stacked and uploaded once, then the stacked
        round body (`_round`).  Returns the losses [N] on the device."""
        b_max = int(np.max(b))
        count_rows(1, b_max, self._real_rows(b),
                   None if part is None else [part])
        with span("round.gather"):
            per = [self.sampler.sample(i, int(b[i]), pad_to=b_max)
                   for i in range(self.n)]
            batch = {k: torch.as_tensor(np.stack([p[k] for p in per]))
                     .to(self.device) for k in per[0]}
            if part is not None:
                part = torch.as_tensor(part).to(self.device)
        self._stacked, losses = self._round(
            self._stacked, batch, self._unit_masks(cuts), do_agg, part)
        return losses

    def _legacy_round(self, b, cuts, do_agg: bool, part=None):
        """One round of the legacy engine: the reference's per-client loop.

        Each client draws its batch (`ClientSampler.sample`, client order,
        padded to ``b_max``) and takes its clipped gradient of the
        single-model loss (`_grad_fn`: on the card every conv through the
        client-batched GEMM at N = 1, a token model's attention and norms
        through their kernels).  Then, over the participating clients
        (``part`` [N] float, or None for all): the Eq. 4 step on each
        server-common unit (those `_unit_masks` leaves at 0) — the mean of the params minus γ times the mean
        of the grads, given to every client; the Eq. 5-6 SGD on each
        client's client-specific units; and on an aggregation round the
        Eq. 7 mean of those, given to every client.  A round with no
        participant holds the params.  The update is this loop's algebra
        in PyTorch, out of place; it launches no fused update kernel (the
        engine has no stacked state).  Every client is given a clone of a
        shared result.  The losses stay on the device: returns them [N].
        """
        gamma = self.sfl.lr
        client_idx = [int(u) for u in np.flatnonzero(self._unit_masks(cuts))]
        b_max = int(np.max(b))
        count_rows(1, b_max, self._real_rows(b),
                   None if part is None else [part])
        losses, grads_all = [], []
        for i in range(self.n):
            with span("round.gather"):
                batch = self.sampler.sample(i, int(b[i]), pad_to=b_max)
            (loss, _), g = self._grad_fn(self._client_units[i], batch)
            losses.append(loss)
            grads_all.append(g)
        if part is None:
            members = list(range(self.n))
        else:
            members = [i for i in range(self.n) if part[i] > 0]
        cnt = len(members)
        cu = self._client_units

        def sgd(p, g):
            return p - gamma * g.to(p.dtype)

        def mean(trees):
            return tree_map(lambda *xs: sum(xs) / cnt, *trees)

        def give_all(u, tree):
            for i in range(self.n):
                cu[i][u] = tree_map(torch.clone, tree)

        if cnt:
            # Eq. 4 from the client mean of the params: equal to any copy
            # while the units are in sync, and right when a reconfiguration
            # moves a still-diverged unit to the server side
            for u in range(len(self.units)):
                if u not in client_idx:
                    give_all(u, tree_map(
                        sgd, mean([cu[i][u] for i in members]),
                        mean([grads_all[i][u] for i in members])))
        for i in members:
            for u in client_idx:
                cu[i][u] = tree_map(sgd, cu[i][u], grads_all[i][u])
        if do_agg and cnt:
            # the survivors' mean; a dropped client re-syncs here
            for u in client_idx:
                give_all(u, mean([cu[i][u] for i in members]))
        return torch.stack(losses)

    # -- device pool ----------------------------------------------------------
    def set_devices(self, devices: Sequence[DeviceProfile], available=None) -> None:
        """Inject the current (possibly trace-evolved) device pool (size
        stays N: churn is modeled as outage — DESIGN.md §9); the latency
        model and any controller reading ``sim.devices`` see it."""
        if len(devices) != self.n:
            raise ValueError(f"device pool must stay size {self.n}, got {len(devices)}")
        self.devices = list(devices)
        self.lat.set_devices(self.devices)
        self.available = (
            np.ones(self.n, bool) if available is None
            else np.asarray(available, bool)
        )

    def _scenario_tick(self, scenario, t: int) -> None:
        """Advance the environment to round ``t``'s trace state."""
        if scenario is not None:
            self.set_devices(scenario.profiles_at(t), scenario.available_at(t))

    def _fault_round(self, b, cuts):
        """(participation, t_split, t_agg) for one round under the active
        fault mode; participation is None on the soft path."""
        if self.fault_mode == "soft":
            if self.mesh_spec is not None and self.mesh_spec.tiered_latency:
                ts, ta = self.lat.tiered_round(
                    b, cuts, self.mesh_spec.n_edges,
                    edge_flops=self.mesh_spec.edge_flops,
                    edge_bw=self.mesh_spec.edge_bw)
                return None, ts, ta
            return None, self.lat.t_split(b, cuts), self.lat.t_agg(b, cuts)
        if self.fault_mode == "dropout":
            part = np.asarray(self.available, bool)
            ts, ta = self.lat.masked_round(b, cuts, part)
            return part.astype(np.float32), ts, ta
        part, ts, ta = self.lat.deadline_round(
            b, cuts, np.asarray(self.available, bool), self.deadline_factor)
        return part.astype(np.float32), ts, ta

    # -- main loop ------------------------------------------------------------
    def run(
        self, policy_fn: Callable, rounds: int, eval_every: int = 10,
        reconfigure_every: Optional[int] = None, verbose: bool = False,
        scenario=None, checkpoint_every: int = 0, snapshot_cb=None,
        resume=None, traffic=None
    ) -> SimResult:
        """policy_fn(sim, rng) -> (b [N], cuts_layers [N]).

        On the scan engine, the segment scheduler: chops the round range
        at eval / reconfiguration / checkpoint boundaries (the every-I
        stage needs no boundary), pre-draws each segment's gather plan
        from the host RNG and runs the segment on the device.  The
        per-round engines walk the rounds one by one (`_run_per_round`).
        Metrics, clock accounting and policy calls follow the reference's
        engine of the same name exactly.

        ``scenario`` (a `repro_torch.scenarios.Scenario`) makes the
        environment time-varying: round t is priced and its participation
        drawn on round t's trace state, and the state is left injected
        when ``policy_fn`` fires at a boundary.  ``checkpoint_every``
        makes every multiple of it a segment boundary and fires
        ``snapshot_cb(t, clock, b, cuts, res)`` there, after the
        boundary's reconfigure/eval; ``resume`` (the dict
        `Session.resume` assembles) continues from a restored snapshot's
        round.  Segment boundaries do not change numerics, so a
        checkpointed or resumed run is bitwise the uninterrupted one.
        ``traffic`` (a `repro_torch.traffic.TrafficPlane`) switches to the
        semi-async streaming mode (`_run_traffic`); ``None`` leaves the
        synchronous path unchanged.  Snapshots, resume and traffic are the
        scan engine's alone (``ValueError`` on the others).
        """
        reconf = reconfigure_every or self.sfl.agg_interval
        if traffic is not None:
            if self.engine != "scan":
                raise ValueError("traffic mode needs engine='scan'")
            return self._run_traffic(
                policy_fn, rounds, eval_every, reconf, verbose, scenario,
                traffic, checkpoint_every, snapshot_cb, resume)
        if self.engine != "scan":
            if checkpoint_every or snapshot_cb or resume is not None:
                raise ValueError(
                    "checkpoint/resume snapshots are segment-boundary "
                    "objects — engine='scan' only")
            return self._run_per_round(policy_fn, rounds, eval_every,
                                       reconf, verbose, scenario)
        ckpt = int(checkpoint_every or 0)
        if resume is not None:
            res = resume["res"]
            clock = float(resume["clock"])
            t = int(resume["t"])
            b = np.asarray(resume["b"])
            cuts = np.asarray(resume["cuts"])
            # params and RNG streams were restored by the caller; re-inject
            # the snapshot round's trace state (the scenario regenerates
            # its history deterministically from its seed)
            self._scenario_tick(scenario, t)
        else:
            res = SimResult()
            clock = 0.0
            t = 0
            self._scenario_tick(scenario, 0)
            b, cuts = policy_fn(self, self.rng)
            self._record_policy(res, b, cuts)

        while t < rounds:
            with span("segment.plan"):
                nxt = self._next_boundary(t, eval_every, reconf, rounds, ckpt)
                masks = self._unit_masks(cuts)
                b_pad = pow2_bucket(int(np.max(b)))
                idx = self.store.segment_indices(nxt - t, b, b_pad)
                row_mask = self.store.row_mask(b, b_pad)
                parts = self._segment_participation(t, nxt, b, cuts,
                                                    scenario)
            seg_losses = self._segment_fn(t, idx, row_mask, masks, parts)

            # clock: accumulate round-by-round on host (the reference's
            # float summation order)
            with span("segment.clock"):
                clock = self._advance_clock(clock, t, nxt, b, cuts, scenario)
            t = nxt

            if self._bank is not None and t < rounds \
                    and t % self.sfl.agg_interval == 0:
                # cohort rotation at the agg-aligned boundary: the
                # departing cohort's state is already folded into the
                # Eq. 7 broadcast, so the bank swaps pools/profiles and
                # re-broadcasts the aggregate (DESIGN.md §15)
                with span("mesh.rotate"):
                    self._bank.rotate(self, t)
            b, cuts = self._maybe_reconfigure(
                res, policy_fn, t, reconf, rounds, b, cuts)
            if t % eval_every == 0 or t == rounds:
                # the eval round is the segment's last: its losses are the
                # final row, fetched here once
                self._record_metrics(res, t, clock, seg_losses[-1], verbose)
            if ckpt and snapshot_cb is not None and t % ckpt == 0:
                # after reconfigure/eval: the snapshot captures the
                # decisions and metrics exactly as the resumed loop needs
                snapshot_cb(t, clock, b, cuts, res)
        return res

    def _run_per_round(self, policy_fn: Callable, rounds: int,
                       eval_every: int, reconf: int, verbose: bool,
                       scenario=None) -> SimResult:
        """The per-round loop of the vectorized and legacy engines: round
        t is priced and its participation drawn on round t's trace state,
        run, and its ``t_split`` (then, on an aggregation round,
        ``t_agg``) added to the clock; then the boundary's reconfiguration
        and eval, as in the scan scheduler."""
        res = SimResult()
        clock = 0.0
        self._scenario_tick(scenario, 0)
        b, cuts = policy_fn(self, self.rng)
        self._record_policy(res, b, cuts)
        for t in range(1, rounds + 1):
            do_agg = t % self.sfl.agg_interval == 0
            self._scenario_tick(scenario, t)
            part, t_split, t_agg = self._fault_round(b, cuts)
            step = self._vectorized_round if self.vectorized \
                else self._legacy_round
            with span("round", t):
                losses = step(b, cuts, do_agg, part)
            clock += t_split
            if do_agg:
                clock += t_agg
            b, cuts = self._maybe_reconfigure(
                res, policy_fn, t, reconf, rounds, b, cuts)
            if t % eval_every == 0 or t == rounds:
                self._record_metrics(res, t, clock, losses, verbose)
        return res

    def _run_traffic(
        self, policy_fn: Callable, rounds: int, eval_every: int,
        reconf: int, verbose: bool, scenario, traffic,
        checkpoint_every: int = 0, snapshot_cb=None, resume=None
    ) -> SimResult:
        """Segment scheduler of the semi-async streaming mode.

        The structure of `run`, with three substitutions (DESIGN.md §14):
        the per-round participation plan comes from the plane's event walk
        (staleness weights, never None), the wall clock is the plane's
        virtual clock (no Eq. 38 barrier), and segment boundaries run the
        plane's admit/evict slot surgery before the policy fires.  Empty
        slots train the 1-sample dummy batch at weight zero, so every
        tensor shape matches the fixed-cohort run.  Snapshots fire after
        the boundary's surgery/injection/reconfigure; the Session folds
        the plane's host state (`TrafficPlane.state`) into the same
        snapshot, so a resumed run replays the identical event walk.
        """
        ckpt = int(checkpoint_every or 0)
        if resume is not None:
            res = resume["res"]
            t = int(resume["t"])
            b = np.asarray(resume["b"])
            cuts = np.asarray(resume["cuts"])
            # the plane's state was restored by the caller; attach only
            # validates the wiring and re-derives the construction pool
            traffic.attach(self, scenario, resume=True)
            traffic.inject_profiles(self, scenario, t)
        else:
            res = SimResult()
            traffic.attach(self, scenario)
            traffic.inject_profiles(self, scenario, 0)
            t = 0
            b, cuts = policy_fn(self, self.rng)
            self._record_policy(res, b, cuts)

        while t < rounds:
            with span("segment.plan"):
                nxt = self._next_boundary(t, eval_every, reconf, rounds, ckpt)
                masks = self._unit_masks(cuts)
                b_eff = traffic.effective_batches(b)
                b_pad = pow2_bucket(int(np.max(b_eff)))
                idx = self.store.segment_indices(nxt - t, b_eff, b_pad)
                row_mask = self.store.row_mask(b_eff, b_pad)
                parts = traffic.plan_segment(self, scenario, t, nxt, b_eff,
                                             cuts)
            seg_losses = self._segment_fn(t, idx, row_mask, masks, parts)
            t = nxt

            traffic.apply_boundary(self, t)
            # the policy observes round-t resources for the *new* cohort
            traffic.inject_profiles(self, scenario, t)
            b, cuts = self._maybe_reconfigure(
                res, policy_fn, t, reconf, rounds, b, cuts)
            if t % eval_every == 0 or t == rounds:
                self._record_metrics(
                    res, t, traffic.clock, seg_losses[-1], verbose,
                    live=traffic.live_mask())
            if ckpt and snapshot_cb is not None and t % ckpt == 0:
                snapshot_cb(t, traffic.clock, b, cuts, res)
        return res

    @staticmethod
    def _next_boundary(t: int, eval_every: int, reconf: int, rounds: int,
                       ckpt: int = 0) -> int:
        """The end of the segment starting after round ``t``: the next
        eval, reconfiguration or checkpoint multiple, or the last round."""
        nxt = min((t // eval_every + 1) * eval_every,
                  (t // reconf + 1) * reconf, rounds)
        if ckpt:
            nxt = min(nxt, (t // ckpt + 1) * ckpt)
        return nxt

    def _unit_masks(self, cuts) -> np.ndarray:
        """The [U] client-specific unit mask of the decision's deepest cut."""
        l_c_units = int(np.max(self._unit_cuts(np.asarray(cuts))))
        return SP.client_unit_mask(self.cfg, len(self.units), l_c_units)

    def _real_rows(self, b) -> np.ndarray:
        """Each client's real (unpadded) rows a round: min(b_i, |pool_i|)."""
        pools = [len(p) for p in self.sampler.client_indices]
        return np.minimum(np.asarray(b, int), pools)

    def _record_policy(self, res: SimResult, b, cuts) -> None:
        res.b_history.append(np.asarray(b).copy())
        res.cut_history.append(np.asarray(cuts).copy())

    def _maybe_reconfigure(
        self, res: SimResult, policy_fn: Callable,
        t: int, reconf: int, rounds: int, b, cuts
    ):
        """Reconfiguration (Algorithm 1 line 23)."""
        if t % reconf == 0 and t < rounds:
            b, cuts = policy_fn(self, self.rng)
            self._record_policy(res, b, cuts)
        return b, cuts

    def _advance_clock(self, clock: float, t: int, nxt: int, b, cuts,
                       scenario=None) -> float:
        """Walk rounds (t, nxt] on the host wall clock: a static pool
        hoists the per-round latency out of the loop, a scenario
        re-evaluates it on each round's trace state (the reference's
        float summation order either way)."""
        if scenario is None:
            _, t_split, t_agg = self._fault_round(b, cuts)
            for r in range(t + 1, nxt + 1):
                clock += t_split
                if r % self.sfl.agg_interval == 0:
                    clock += t_agg
        else:
            for r in range(t + 1, nxt + 1):
                self._scenario_tick(scenario, r)
                _, t_split, t_agg = self._fault_round(b, cuts)
                clock += t_split
                if r % self.sfl.agg_interval == 0:
                    clock += t_agg
        return clock

    def _record_metrics(
        self, res: SimResult, t: int, clock: float, losses, verbose: bool,
        live=None
    ) -> None:
        """Eval + metric append; the only host fetch of ``losses``.

        ``live`` ([N] bool, traffic mode) restricts both the aggregate
        model and the train-loss mean to occupied slots — empty slots
        train a weight-0 dummy batch whose loss is meaningless.
        """
        with span("eval.aggregate"):
            units = self._aggregate_model(live)
        with span("eval.forward"):
            tl, ta = self._eval(units, self.test_batch)
        with span("eval.fetch"):
            losses = losses.cpu().numpy()
        if live is not None and live.any():
            losses = losses[np.asarray(live, bool)]
        mean_loss = float(np.mean(losses))
        res.rounds.append(t)
        res.clock.append(clock)
        res.train_loss.append(mean_loss)
        res.test_loss.append(float(tl))
        res.test_acc.append(float(ta))
        if verbose:
            print(
                f"round {t:5d} clock {clock:9.1f}s "
                f"loss {mean_loss:.4f} "
                f"acc {float(ta):.4f}", flush=True
            )

    def _segment_participation(self, t: int, nxt: int, b, cuts,
                               scenario=None):
        """The ``[R, N]`` participation plan for rounds (t, nxt], each
        round drawn on its own trace state (the states and order
        `_advance_clock` re-walks — the scenario caches its history, so
        both see identical floats); None on the soft path."""
        if self.fault_mode == "soft":
            return None
        plan = []
        for r in range(t + 1, nxt + 1):
            self._scenario_tick(scenario, r)
            plan.append(self._fault_round(b, cuts)[0])
        return np.stack(plan)

    def _aggregate_model(self, live=None):
        """Virtual aggregated model w̄ (analysis object, Sec. IV); in mesh
        mode the global client mean, the same on every rank.  ``live``
        ([N] bool, traffic mode) means over occupied slots only (the
        all-slot mean when every or no slot is live)."""
        if self._shard is not None:
            return self._shard.client_mean(self._stacked)
        if not self.vectorized:
            return [tree_map(lambda *xs: sum(xs) / self.n,
                             *[cu[u] for cu in self._client_units])
                    for u in range(len(self.units))]
        if live is not None:
            live = np.asarray(live, bool)
            if live.any() and not live.all():
                sel = torch.as_tensor(np.flatnonzero(live),
                                      device=self.device)
                return [tree_map(lambda a: a.index_select(0, sel)
                                 .mean(dim=0), u) for u in self._stacked]
        return SP.mean_unit_trees(self._stacked)


# ---------------------------------------------------------------------------
# SPMD HASFL train step (one device)
# ---------------------------------------------------------------------------

def make_hasfl_train_step(
    model: Model, *, n_clients: int, cut_reps: int,
    agg_interval: int, optimizer_name: str = "adam",
    lr: float = 3e-4, optimizer_dtype: str = "float32",
    grad_accum: int = 1, remat: bool = True,
    shard_fn=None, unroll: bool = False,
    param_shardings=None, rep_shard_fn=None
):
    """Build ``(init_state, train_step)``: the reference's
    `repro.core.sfl.make_hasfl_train_step` on one device, with its GSPMD
    arguments.  ``shard_fn`` and ``rep_shard_fn`` are `dist.sharding`'s
    activation and per-repetition weight hooks, handed to the loss;
    ``param_shardings`` (``(client, server)`` `NamedSharding` trees) pins
    the accumulated gradients to the parameter layout between
    micro-batches.  On plain tensors (one card, the dry-run's ``meta``
    state) the hooks and the pin change nothing, so the step equals the
    step without them bitwise; on DTensors they redistribute.
    ``unroll`` is a no-op: the micro-batches and the stack are Python
    loops already.

    State: ``{"client": per-client stacked prefix [N, ...], "server":
    suffix, "opt": optimizer state, "step": int}``.  Batch: ``{"tokens",
    "labels": [N, b, S]}`` (an optional ``loss_mask``, and the family's
    stubs ``[N, b, ...]``: ``patch_embeddings``/``patch_mask``,
    ``frame_embeddings``), on the state's device.

    Semantics per HASFL: the loss is `Model.split_loss` (per-client
    prefix, one concatenated server batch), whose gradient gives the
    server part the client mean (Eq. 4, every step); the client parts
    take their own gradients (Eq. 5-6: ``gc * n_clients`` undoes the
    loss's 1/N) and are averaged every ``agg_interval`` steps (Eq. 7).
    ``grad_accum`` splits each client's batch into that many
    micro-batches whose gradients are summed in order and scaled by
    ``1/grad_accum``, as the reference's scan.  ``remat`` recomputes each
    super-block in the backward.  The optimizer updates the state in
    place (`training.optim`); ``train_step`` returns the state and
    ``{"loss": tensor}``.
    """
    opt = make_optimizer(optimizer_name, lr, state_dtype=optimizer_dtype)

    def init_state(gen, device=None):
        params = model.init(gen, resolve(device))
        client, server = SP.split_stacked(params, cut_reps)
        client = SP.replicate_client(client, n_clients)
        # the suffix in storage of its own: a view would keep the prefix's
        # repetitions alive beside their per-client copies (6.5 GB at
        # dbrx's width)
        server = tree_map(torch.clone, server)
        return {"client": client, "server": server,
                "opt": opt.init({"client": client, "server": server}),
                "step": 0}

    def mean_loss(client, server, batch):
        loss, _ = model.split_loss(client, server, batch, shard_fn=shard_fn,
                                   remat=remat, unroll=unroll,
                                   rep_shard_fn=rep_shard_fn)
        return loss

    def constrain(gc, gs):
        """The gradients laid out as the parameters (``param_shardings``):
        DTensors redistributed, plain tensors as they are."""
        if param_shardings is None:
            return gc, gs
        from torch.distributed.tensor import DTensor

        def pin(g, sh):
            return g.redistribute(g.device_mesh, sh.placements) \
                if isinstance(g, DTensor) else g
        return (tree_map(pin, gc, param_shardings[0]),
                tree_map(pin, gs, param_shardings[1]))

    def train_step(state, batch):
        client, server = _with_grad(state["client"]), \
            _with_grad(state["server"])
        if grad_accum > 1:
            loss = 0.0
            for k in range(grad_accum):
                mb = {key: v.reshape(v.shape[0], grad_accum,
                                     v.shape[1] // grad_accum,
                                     *v.shape[2:])[:, k]
                      for key, v in batch.items()}
                lk = mean_loss(client, server, mb)
                lk.backward()
                loss = loss + lk.detach()
            scale = 1.0 / grad_accum
            gc, gs = constrain(_grads(client), _grads(server))
            gc = tree_map(lambda g: g * scale, gc)
            gs = tree_map(lambda g: g * scale, gs)
            loss = loss * scale
        else:
            loss = mean_loss(client, server, batch)
            loss.backward()
            loss = loss.detach()
            gc, gs = _grads(client), _grads(server)
        # mean_loss scales each client's grad by 1/N; restore per-client SGD
        # (in place: a copy would hold a second client gradient tree)
        gc = tree_map(lambda g: g.mul_(n_clients), gc)
        params = {"client": state["client"], "server": state["server"]}
        new_params, new_opt = opt.update({"client": gc, "server": gs},
                                         state["opt"], params, state["step"])
        step1 = state["step"] + 1
        # every-I aggregation of the client-stacked prefix (Eq. 7)
        new_client = SP.aggregate_where(new_params["client"],
                                        step1 % agg_interval == 0)
        return {"client": new_client, "server": new_params["server"],
                "opt": new_opt, "step": step1}, {"loss": loss}

    return init_state, train_step
