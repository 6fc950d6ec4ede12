"""Model partitioning: cut a model's parameters into client-side and
server-side sub-models (paper Sec. III-A).  Port of `repro.core.split`.

Two granularities:

- **unit lists** (edge simulator): a model is a list of cuttable units.
  CNNs: one unit per conv/fc layer (exactly the paper's VGG-16
  splitting).  Token models: one unit per super-block repetition, plus
  the embedding (always client-side — it touches raw data) and the head
  (always server).  Client-stacked units carry a leading ``N`` axis, and
  the HASFL update is expressed once per unit over all clients.
- **stacked split** (SPMD path): the first ``c`` repetitions of the
  ``[R, ...]``-stacked decoder are replicated per client ``[N, c, ...]``;
  the rest stay a single server copy.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, CNN
from repro_torch.models.transformer import (layer_program, stack_params,
                                            unstack_params)
from repro_torch.utils.cells import fold, rows
from repro_torch.utils.tree import tree_leaves, tree_map


def to_units(cfg: ModelConfig, params) -> Tuple[list, Callable]:
    """Returns (units, rebuild) where rebuild(units) -> params."""
    if cfg.family == CNN:
        return list(params), lambda us: list(us)
    program, repeats = layer_program(cfg)
    reps = unstack_params(params["stack"], repeats)
    head_unit = {"final_norm": params["final_norm"]}
    if "head" in params:
        head_unit["head"] = params["head"]
    if cfg.is_enc_dec:
        head_unit["enc_stack"] = params["enc_stack"]
        head_unit["enc_final_norm"] = params["enc_final_norm"]
    units = [{"embed": params["embed"]}] + reps + [head_unit]
    return units, _rebuild


def _rebuild(us: list) -> dict:
    """A token model's parameters from its unit list."""
    out = {
        "embed": us[0]["embed"],
        "stack": stack_params(us[1:-1]),
        "final_norm": us[-1]["final_norm"],
    }
    if "head" in us[-1]:
        out["head"] = us[-1]["head"]
    if "enc_stack" in us[-1]:
        out["enc_stack"] = us[-1]["enc_stack"]
        out["enc_final_norm"] = us[-1]["enc_final_norm"]
    return out


def from_units(cfg: ModelConfig, units: list):
    """The parameters of a unit list (what `to_units`'s rebuild gives)."""
    return list(units) if cfg.family == CNN else _rebuild(units)


def n_cut_units(cfg: ModelConfig, units: list) -> int:
    """Number of valid cut positions in unit space."""
    if cfg.family == CNN:
        return len(units)           # cut after any layer
    return len(units) - 2           # embed fixed client, head fixed server


def layer_cut_to_unit_cut(cfg: ModelConfig, cut_layer: int) -> int:
    """Map a profile-granularity cut (1..L) to unit granularity."""
    if cfg.family == CNN:
        return cut_layer
    program, repeats = layer_program(cfg)
    period = len(program)
    return min(repeats, max(1, -(-cut_layer // period)))


def split_units(units: list, cut_units: int, cfg: ModelConfig):
    """Client keeps units [0, k); server keeps the rest.

    For token models k counts *repetitions*, so the client side is
    ``units[0 .. cut_units]`` (embedding + cut_units repetitions).
    """
    k = cut_units if cfg.family == CNN else cut_units + 1
    return units[:k], units[k:]


def merge_units(client_units: list, server_units: list) -> list:
    return list(client_units) + list(server_units)


# ---------------------------------------------------------------------------
# Stacked unit lists
# ---------------------------------------------------------------------------

def stack_unit_trees(client_units: list) -> list:
    """list[N] of list[U] unit trees -> list[U] of [N, ...]-stacked trees."""
    return [tree_map(lambda *xs: torch.stack(xs),
                     *[units[u] for units in client_units])
            for u in range(len(client_units[0]))]


def unstack_unit_trees(stacked: list, n: int) -> list:
    """Per-client unit lists (views into the stacked tensors)."""
    return [[tree_map(lambda a, i=i: a[i], u) for u in stacked]
            for i in range(n)]


def replicate_units(units: list, n: int) -> list:
    """N identical copies of a unit list along a leading client axis, each
    in its own contiguous storage (the simulator updates them in place)."""
    return [tree_map(lambda a: a.unsqueeze(0).repeat((n,) + (1,) * a.dim()),
                     u) for u in units]


def mean_unit_trees(stacked: list) -> list:
    """Client-mean of every unit — the virtual aggregated model w̄."""
    return [tree_map(lambda a: a.mean(dim=0), u) for u in stacked]


def client_unit_mask(cfg: ModelConfig, n_units: int, l_c_units: int):
    """1.0 for client-specific (every-I) units, 0.0 for server-common.

    CNNs: the first ``l_c_units`` layers.  Token models: the embedding
    plus the first ``l_c_units`` repetitions (the head unit is always
    server).
    """
    mask = np.zeros((n_units,), np.float32)
    mask[:l_c_units + (cfg.family != CNN)] = 1.0
    return mask


def two_tier_common(spec, w, edge_size, group):
    """Hierarchical Eq. 4/7 mean over a process group (DESIGN.md §15).

    ``spec`` is this rank's ``[n_local, ...]`` slice of per-client SGD
    results, ``w`` its participation weights.  Per-edge partial sums
    reduce on the rank (each rank holds whole edges, so no edge
    straddles ranks), their sum and the survivor count each take one
    ``all_reduce`` over ``group`` (the cloud combine).  Equal to the flat
    survivor-renormalized mean by linearity; floating point only
    reassociates.  The sums, the count and the division run in the leaf's
    type (a token model's bf16 leaves: the reference's arithmetic).
    Returns ``(common, global survivor count)``, the same on every rank.
    """
    n_local = spec.shape[0]
    e = int(edge_size or n_local)
    w = w.to(spec.dtype)
    w_col = w.reshape((-1,) + (1,) * (spec.dim() - 1))
    edge_sums = (spec * w_col).reshape(
        (n_local // e, e) + tuple(spec.shape[1:])).sum(dim=1)
    total = edge_sums.sum(dim=0)
    cnt = w.sum()
    dist.all_reduce(total, group=group)
    dist.all_reduce(cnt, group=group)
    return total / torch.where(cnt > 0, cnt, 1.0), cnt


def hasfl_round_update(
    stacked: list, grads: list, masks, do_agg: bool,
    gamma: float, grad_scale=None, impl=None, participation=None,
    group=None, edge_size=None, cells: int = 1
) -> list:
    """One HASFL parameter update over [N, ...]-stacked units.

    Applies the Eq. 4 server-common mean update, the Eq. 5-6
    client-specific updates and the Eq. 7 every-I aggregation, folded
    into one pass per leaf: every unit computes the per-client SGD result
    ``spec`` once, one client mean of it, and one select.  ``masks`` ([U],
    host) marks the client-specific units, ``do_agg`` (host bool) is the
    every-I flag, ``grad_scale`` ([N]) the per-client clip factor and
    ``participation`` ([N] float weights, or None for the full cohort) the
    survivor weights of a partial round.

    ``impl`` (any non-None value) sends every leaf of the round through
    one `kernels.ops.clip_sgd_leaves` call — on the card one launch of the
    fused kernel, which updates the leaves *in place*, so the caller's
    ``stacked`` tensors change — and ``None`` keeps the inline plain
    algebra below.

    ``group`` (a `torch.distributed` process group) switches the mean to
    the two-tier hierarchy of mesh mode: ``stacked``/``grads``/
    ``participation`` then hold this rank's client slice, and the Eq. 4/7
    combine goes through `two_tier_common` (per-edge partial sums of
    ``edge_size`` clients, then the cross-rank all-reduces).  The
    use-common flag comes from the replicated ``keep_spec`` and the
    global count, never from a rank-local ``any(keep)``, so every rank
    takes the same branch; the kernel receives the finished means.

    ``cells=G`` folds G cells of N clients (the grid runner): every leaf,
    ``grad_scale`` and ``participation`` hold ``G·N`` rows, cell ``g``'s
    rows ``[g·N, (g+1)·N)``, and ``masks`` is ``[G, U]``.  Each cell is
    updated as by its own call: through the op, one entry a (cell, leaf)
    in one call; inline, cell by cell on its rows, the results
    concatenated into new folded tensors.
    """
    first = tree_leaves(stacked[0])[0]
    n = first.shape[0]
    ones = torch.ones(n, device=first.device)
    if cells > 1 and group is not None:
        raise ValueError("mesh mode runs one cell")
    if cells > 1 and impl is None:
        size = n // cells
        return fold([hasfl_round_update(
            rows(stacked, g, size), rows(grads, g, size), masks[g], do_agg,
            gamma, grad_scale=rows(grad_scale, g, size),
            participation=rows(participation, g, size))
            for g in range(cells)])
    if impl is not None:
        from repro_torch.kernels import ops as KOPS

        scale = grad_scale if grad_scale is not None else ones
        cell_masks = [masks] if cells == 1 else masks
        ps, gs, keep_specs = [], [], [[] for _ in cell_masks]
        for u, (p_u, g_u) in enumerate(zip(stacked, grads)):
            for p, g in zip(tree_leaves(p_u), tree_leaves(g_u)):
                ps.append(p.reshape(n, -1).contiguous())
                gs.append(g.reshape(n, -1).contiguous())
                for ks, m in zip(keep_specs, cell_masks):
                    ks.append(bool(m[u] > 0) and not do_agg)
        commons = count = None
        if group is not None:
            # the collectives cannot run inside a kernel: combine here,
            # hand the kernel the finished means
            w = ones if participation is None else participation
            commons = []
            for pf, gf in zip(ps, gs):
                spec = pf - gamma * (gf * scale.reshape(-1, 1)).to(pf.dtype)
                common, count = two_tier_common(spec, w, edge_size, group)
                commons.append(common)
        outs = iter(KOPS.clip_sgd_leaves(
            ps, gs, scale, keep_specs[0] if cells == 1 else keep_specs,
            participation, gamma=gamma, commons=commons, count=count,
            cells=cells))
        return [tree_map(lambda p: next(outs).reshape(p.shape), p_u)
                for p_u in stacked]

    new_stacked = []
    for u, (p_u, g_u) in enumerate(zip(stacked, grads)):
        keep_spec = bool(masks[u] > 0) and not do_agg

        def upd(p, g, keep_spec=keep_spec):
            if grad_scale is not None:
                g = g * grad_scale.reshape((-1,) + (1,) * (g.dim() - 1))
            # Eq. 5-6: client-specific — per-client SGD
            spec = p - gamma * g.to(p.dtype)
            if group is not None:
                # two-tier combine (mesh mode): same selects as the flat
                # paths below, only the mean is hierarchical
                w = ones if participation is None else participation
                common, cnt = two_tier_common(spec, w, edge_size, group)
            elif participation is None:
                common = None
            else:
                w = participation.to(spec.dtype)
                w_col = w.reshape((-1,) + (1,) * (spec.dim() - 1))
                cnt = w.sum()
                # where, not maximum: fractional weights may sum below 1
                common = (spec * w_col).sum(dim=0) / torch.where(
                    cnt > 0, cnt, 1.0)
            if participation is None:
                # Eq. 4 == Eq. 7 aggregate: server-common units take the
                # mean update every round; client-specific units take it
                # exactly on aggregation rounds
                if keep_spec:
                    return spec
                if common is None:
                    common = spec.mean(dim=0)
                return common[None].expand_as(p).clone()
            # Partial round: survivor-renormalized mean, dropped clients
            # hold their params
            keep = ((participation > 0) & keep_spec).reshape(
                (-1,) + (1,) * (spec.dim() - 1))
            use_common = (cnt > 0) & (not keep_spec)
            fallback = torch.where(use_common, common[None].expand_as(p), p)
            return torch.where(keep, spec, fallback)

        new_stacked.append(tree_map(upd, p_u, g_u))
    return new_stacked


def aggregate_where(tree, do_agg: bool):
    """Every-I aggregation (Eq. 7): when ``do_agg``, each ``[N, ...]``
    leaf becomes its client mean broadcast back over N (new tensors);
    otherwise the tree is returned as it is."""
    if not do_agg:
        return tree
    return tree_map(lambda a: a.mean(dim=0, keepdim=True).expand_as(a)
                    .contiguous(), tree)


# ---------------------------------------------------------------------------
# Stacked split (SPMD path)
# ---------------------------------------------------------------------------

def split_stacked(params: dict, c_reps: int) -> Tuple[dict, dict]:
    """Split token-model params at super-block repetition ``c_reps``.

    client part: ``{"embed", "stack_prefix"}`` — per-client replicable.
    server part: ``{"stack_suffix", "final_norm"[, "head"]}`` (views).
    """
    prefix = tree_map(lambda a: a[:c_reps], params["stack"])
    suffix = tree_map(lambda a: a[c_reps:], params["stack"])
    client = {"embed": params["embed"], "stack_prefix": prefix}
    server = {k: v for k, v in params.items() if k not in ("embed", "stack")}
    server["stack_suffix"] = suffix
    return client, server


def merge_stacked(client: dict, server: dict) -> dict:
    params = {k: v for k, v in server.items() if k != "stack_suffix"}
    params["embed"] = client["embed"]
    params["stack"] = tree_map(lambda a, b: torch.cat([a, b], dim=0),
                               client["stack_prefix"], server["stack_suffix"])
    return params


def replicate_client(client: dict, n: int) -> dict:
    """N per-client copies along a leading client axis, each in its own
    contiguous storage."""
    return tree_map(lambda a: a.unsqueeze(0).repeat((n,) + (1,) * a.dim()),
                    client)


def mean_clients(client_stacked: dict) -> dict:
    return tree_map(lambda a: a.mean(dim=0), client_stacked)
