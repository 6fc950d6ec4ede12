"""Process-group execution of the segment scheduler (port of
`repro.mesh.sharded`).

Where the reference wraps its scan segment in `shard_map` over a device
mesh, the port runs one process per device on a `torch.distributed`
process group: rank ``r`` of ``d`` owns the contiguous client slice
``[r*N/d, (r+1)*N/d)`` of the stacked units (whole edge servers), the
host plane (policy, clock, gather-plan RNG) is replicated on every rank,
and the only cross-rank traffic is the Eq. 4/7 combine inside
`core.split.hasfl_round_update` (two all-reduces per leaf), the client
mean of the aggregated model, and one all-gather of each segment's
losses.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_map


def join_group(mspec, device: torch.device) -> torch.device:
    """Make sure the default process group of ``mspec.devices`` ranks
    exists and return this rank's device.

    With no group initialised and ``devices`` 1 (or None) this makes a
    world of one from an in-memory store (NCCL on the card, gloo on the
    CPU); d > 1 needs the caller's ``init_process_group`` in each of d
    processes (`build_process_mesh` then refuses a world of another
    size).  On the card the device is ``cuda:<local rank>`` (one host, so
    the local rank is the rank) unless the caller pinned one.
    """
    if not dist.is_initialized():
        if mspec.devices not in (None, 1):
            raise RuntimeError(
                f"mesh.devices={mspec.devices} needs {mspec.devices} "
                "processes on an initialised process group: call "
                "torch.distributed.init_process_group(backend, "
                "init_method='tcp://<address>:<port>', world_size=d, "
                "rank=r) in each (see repro_torch.mesh.launch)")
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", dist.get_rank())
        torch.cuda.set_device(device)
    return device


@dataclass(frozen=True)
class ProcessMesh:
    """This rank's place on the clients-only mesh."""

    group: object          # the torch.distributed process group
    d: int                 # ranks (devices)
    rank: int
    n: int                 # global client slots

    @property
    def n_local(self) -> int:
        return self.n // self.d

    @property
    def lo(self) -> int:
        return self.rank * self.n_local

    def local_plan(self, idx):
        """This rank's columns of a segment's ``[R, N, ...]`` plan: the
        gather plan (every rank draws the whole plan from the replicated
        host RNG, one draw per (round, client), so the streams agree) or
        the participation plan."""
        return idx[:, self.lo:self.lo + self.n_local]

    def local_rows(self, a):
        """This rank's rows of an ``[N, ...]`` array."""
        return a[self.lo:self.lo + self.n_local]

    def gather_losses(self, losses):
        """``[R, N/d]`` local losses -> the ``[R, N]`` losses, on every
        rank."""
        parts = [torch.empty_like(losses) for _ in range(self.d)]
        dist.all_gather(parts, losses.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def client_mean(self, stacked: list) -> list:
        """The global client mean of every unit (the aggregated model
        w̄): the fp32 sum of the local slice, one all-reduce, divided by N
        and rounded once to the leaf's type (the reference's mean of a
        bf16 leaf) — identical on every rank, so controllers and eval
        agree."""
        def mean(a):
            s = a.float().sum(dim=0)
            dist.all_reduce(s, group=self.group)
            return (s / self.n).to(a.dtype)

        return [tree_map(mean, u) for u in stacked]


def build_process_mesh(mspec, n_clients: int) -> ProcessMesh:
    """The process-group counterpart of the reference's
    ``build_device_mesh`` on the default group: ``d`` is
    ``mspec.devices`` (default: the world size) and must equal the world
    size; the edge blocks
    must tile the ranks (``n_edges % d == 0``) so per-edge partial sums
    never cross a rank."""
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh mode runs on a torch.distributed process group: start "
            "one process per device and call init_process_group(backend, "
            "init_method='tcp://<address>:<port>', world_size=d, rank=r) "
            "in each before building the simulator")
    group = dist.group.WORLD
    world = dist.get_world_size(group)
    d = int(mspec.devices) if mspec.devices is not None else world
    if d != world:
        raise ValueError(
            f"mesh.devices={d} but the process group has {world} ranks "
            "(one process per device)")
    if mspec.n_edges % d != 0:
        raise ValueError(
            f"n_edges {mspec.n_edges} must be a multiple of the mesh size "
            f"{d} (set mesh.devices explicitly to pin a divisor)")
    if n_clients % d != 0:
        raise ValueError(
            f"n_clients {n_clients} must be divisible by the mesh size {d}")
    return ProcessMesh(group=group, d=d, rank=dist.get_rank(group),
                       n=int(n_clients))


def make_sharded_segment(sim, pm: ProcessMesh):
    """The mesh replacement for the simulator's segment function.

    Call-compatible with ``sim._run_segment``: ``(t0, idx, row_mask,
    masks, parts) -> [R, N] losses``.  The body is the unmodified
    `_run_segment` on this rank's columns of the plan (and rows of the
    row mask and participation); the losses are gathered back.
    """
    def wrapped(t0, idx, row_mask, masks, parts=None):
        losses = sim._run_segment(
            t0, pm.local_plan(idx), pm.local_rows(row_mask), masks,
            None if parts is None else pm.local_plan(parts))
        return pm.gather_losses(losses)

    return wrapped
