"""Sharding-rule inference for the HASFL SPMD runtime (port of
`repro.dist.sharding`).

One vocabulary for every mesh the launch layer builds (``make_host_mesh``,
``make_production_mesh`` single- and multi-pod):

- ``auto_param_spec`` — largest-divisible-axis `PartitionSpec` inference
  for a single parameter shape.  It never emits a spec whose mesh-axis
  product does not divide the dimension (odd head counts, tiny norm
  vectors and ragged vocab sizes all get a valid sharding).
- ``state_shardings`` — `NamedSharding` tree for a train state / params
  tree ({"client", "server", "opt", "step"} or a bare params dict).
  Client-stacked leaves put the leading N axis on the data axes (the
  HASFL client-to-data-parallel mapping); stacked decoder leaves keep the
  repetition axis unsharded; expert tensors go (E over model, d over
  data).
- ``batch_shardings`` — batch leaves sharded over data on the leading axis.
- ``cache_shardings`` — decode caches: batch over data, attention k/v
  head_dim over model.
- ``make_shard_fn`` / ``make_rep_shard_fn`` — the activation and
  per-repetition weight constraint hooks ``models/factory`` threads through
  the forward passes.

A `PartitionSpec` here is the reference's per-dimension axis assignment
as a tuple (``None``, an axis name, or a tuple of names per tensor
dimension), equal entry for entry to the reference's for the same shape
and mesh.  A `NamedSharding` pairs it with the mesh and gives the DTensor
placements (``Shard(dim)`` / ``Replicate()`` per mesh axis), the local
shard shape and bytes.

The constraint hooks act on DTensors (a redistribute to the spec's
placements).  On plain tensors — the one-card step, and the dry-run's
``meta`` tensors — there is no layout to constrain: a hook returns its
input unchanged (so on one card a step with the hooks equals the step
without them, bitwise) and records in ``hook.log`` how far it would shard
what it saw, which the dry-run reads for the per-device activation bytes
and the sequence-parallel all-gathers (`launch/dryrun.py`).

The module-level helpers ``_dp_axes`` / ``_axis_size`` / ``_tree_specs``,
and the functions themselves, are the extension points ``launch/perf.py``
experiments swap.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

from repro_torch.launch.mesh import axis_size, dp_axes, mesh_axes

# Leaf names holding per-expert weights (stacked [R, E, ...]).
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# Tree keys under which leaves carry a leading repetition stack axis.
STACK_KEYS = ("stack", "stack_prefix", "stack_suffix", "enc_stack")
# Tree keys under which leaves carry a leading per-client N axis.
CLIENT_KEYS = ("client", "client_units")


class PartitionSpec(tuple):
    """Per-dimension mesh-axis assignment: ``P(None, "model", ("pod",
    "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A `PartitionSpec` on a mesh."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and self.spec == other.spec \
            and mesh_axes(self.mesh) == mesh_axes(other.mesh)

    def __hash__(self):
        return hash(self.spec)

    def _axes_of(self, entry):
        return () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh axis: ``Shard(d)`` where the
        spec puts the axis on tensor dim ``d``, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        where = {a: d for d, e in enumerate(self.spec)
                 for a in self._axes_of(e)}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in mesh_axes(self.mesh))

    def shard_shape(self, shape) -> tuple:
        """The local shape of a ``shape`` tensor under this sharding."""
        return tuple(int(n) // axis_size(self.mesh, self._axes_of(e))
                     for n, e in zip(shape, self.spec))

    def local_bytes(self, shape, itemsize: int) -> int:
        return math.prod(self.shard_shape(shape)) * itemsize


def _dp_axes(mesh):
    return dp_axes(mesh)


def _axis_size(mesh, axes) -> int:
    return axis_size(mesh, axes)


def _model_size(mesh) -> int:
    return int(mesh_axes(mesh).get("model", 1))


def auto_param_spec(shape, mesh, *, expert: bool = False,
                    skip: Optional[int] = None, dp: bool = True,
                    tp: bool = True) -> P:
    """Infer a PartitionSpec for one parameter of ``shape``.

    Largest-divisible-axis rule: the biggest dim divisible by the model
    axis takes "model" (tensor parallel); the biggest remaining dim
    divisible by the data axes takes the dp axes (FSDP).  ``skip`` leading
    dims (stack / client axes) stay unsharded — they are the caller's
    to place.  ``expert`` switches to the MoE layout: E over model, the
    following dim over data.  Dims never get an axis whose size does not
    divide them, so odd head counts and ragged shapes always shard.
    """
    shape = tuple(int(s) for s in shape)
    if not shape:
        return P()
    n_tp = _model_size(mesh)
    dpax = _dp_axes(mesh)
    n_dp = _axis_size(mesh, dpax)
    spec = [None] * len(shape)
    if skip is None:
        skip = 1 if (expert and len(shape) >= 3) else 0
    dims = list(range(min(skip, len(shape)), len(shape)))
    if expert and dims:
        if tp and n_tp > 1 and shape[dims[0]] % n_tp == 0:
            spec[dims[0]] = "model"
        if dp and n_dp > 1 and len(dims) > 1 and shape[dims[1]] % n_dp == 0:
            spec[dims[1]] = dpax
        return P(*spec)
    by_size = sorted(dims, key=lambda d: shape[d], reverse=True)
    if tp and n_tp > 1:
        for d in by_size:
            if shape[d] % n_tp == 0 and shape[d] > 1:
                spec[d] = "model"
                by_size.remove(d)
                break
    if dp and n_dp > 1:
        for d in by_size:
            if shape[d] % n_dp == 0 and shape[d] > 1:
                spec[d] = dpax
                break
    return P(*spec)


def client_axis_spec(shape, mesh, axis: str) -> P:
    """PartitionSpec for an ``[N, ...]``-stacked client leaf on a client
    mesh: the leading axis takes ``axis``; inner dims go through the same
    largest-divisible-axis inference as everything else (unsharded when
    the mesh carries no data/model axes, as `repro_torch.mesh`'s
    clients-only mesh does).
    """
    shape = tuple(int(s) for s in shape)
    if not shape:
        return P()
    inner = list(auto_param_spec(shape, mesh, skip=1))
    inner[0] = axis
    return P(*inner)


# ---------------------------------------------------------------------------
# Tree-level inference
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts (sorted keys, as the port's
    `utils.tree`) and lists / tuples (indices as names)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, t, path + (str(i),))
                for i, t in enumerate(tree)]
    return fn(path, tree)


def _leaf_shape(leaf):
    return tuple(getattr(leaf, "shape", ()))


def _tree_specs(tree, mesh, leaf_fn: Callable):
    """Map ``leaf_fn("/".join(path), shape) -> NamedSharding`` over a tree
    of tensors.  The perf experiments override cache / param rules
    through this hook."""
    return _map_with_path(
        lambda path, leaf: leaf_fn("/".join(path), _leaf_shape(leaf)), tree)


def _state_leaf_spec(names: Tuple[str, ...], shape, mesh) -> P:
    if not shape or "step" in names:
        return P()
    client = any(n in CLIENT_KEYS for n in names)
    stacked = any(n in STACK_KEYS for n in names)
    expert = names[-1] in EXPERT_LEAVES
    skip = (1 if client else 0) + (1 if stacked else 0)
    if client:
        # leading N axis -> data axes (client i lives on dp slice i);
        # dp is consumed, so only model-shard the inner dims.
        spec = list(auto_param_spec(shape, mesh, expert=expert, skip=skip,
                                    dp=False))
        dpax = _dp_axes(mesh)
        n_dp = _axis_size(mesh, dpax)
        if n_dp > 1 and shape[0] % n_dp == 0:
            spec[0] = dpax
        return P(*spec)
    return auto_param_spec(shape, mesh, expert=expert, skip=skip)


def state_shardings(state, mesh):
    """NamedSharding tree for a train state ({"client","server","opt",
    "step"}) or a bare params dict (prefill/decode)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _state_leaf_spec(path, _leaf_shape(leaf), mesh)), state)


def batch_shardings(batch, mesh):
    """Batch leaves: leading axis over the data axes when divisible.

    Train batches are [N, b, ...] (client axis == data axis); prefill /
    decode batches are [B, ...].
    """
    dpax = _dp_axes(mesh)
    n_dp = _axis_size(mesh, dpax)

    def leaf_fn(pstr, shape):
        if shape and n_dp > 1 and shape[0] % n_dp == 0:
            return NamedSharding(mesh, P(dpax, *([None] * (len(shape) - 1))))
        return NamedSharding(mesh, P(*([None] * len(shape))))

    return _tree_specs(batch, mesh, leaf_fn)


def cache_shardings(cache, mesh):
    """Decode-cache tree [R, B, ...]: batch over data; attention k/v shard
    head_dim over model (the qk^T contraction psum layout — see the
    ``cache_replicated`` perf experiment for the alternative).  Integer
    bookkeeping leaves (ring positions) only shard batch.
    """
    dpax = _dp_axes(mesh)
    n_dp = _axis_size(mesh, dpax)
    n_tp = _model_size(mesh)

    def leaf_fn(pstr, shape):
        spec = [None] * len(shape)
        if len(shape) >= 2 and n_dp > 1 and shape[1] % n_dp == 0:
            spec[1] = dpax
        name = pstr.rsplit("/", 1)[-1]
        if name in ("k", "v") and len(shape) >= 3 and n_tp > 1 \
                and shape[-1] % n_tp == 0:
            spec[-1] = "model"
        return NamedSharding(mesh, P(*spec))

    return _tree_specs(cache, mesh, leaf_fn)


def cache_shardings_replicated(cache, mesh):
    """Decode-cache tree with k/v replicated across "model": batch over
    data only, no head_dim sharding.

    Removes the qk^T psum at the cost of redundant attention compute and
    higher per-device memory traffic — the trade the ``cache_replicated``
    experiment in launch/perf.py flips to.
    """
    dpax = _dp_axes(mesh)
    n_dp = _axis_size(mesh, dpax)

    def leaf_fn(pstr, shape):
        if not shape:
            return NamedSharding(mesh, P())
        spec = [None] * len(shape)
        if len(shape) >= 2 and n_dp > 1 and shape[1] % n_dp == 0:
            spec[1] = dpax
        return NamedSharding(mesh, P(*spec))

    return _tree_specs(cache, mesh, leaf_fn)


# ---------------------------------------------------------------------------
# Constraint hooks (threaded through the model forward passes)
# ---------------------------------------------------------------------------

def _constrain(x, mesh, spec, log: dict):
    """``x`` laid out as ``spec``: a DTensor is redistributed; a plain
    tensor comes back unchanged, and ``log`` keeps the largest shard
    factor asked for (``divisor``) and the calls."""
    sh = NamedSharding(mesh, spec)
    log["calls"] += 1
    log["divisor"] = max(log["divisor"], math.prod(
        axis_size(mesh, sh._axes_of(e)) for e in spec))
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, sh.placements)
    return x


def _new_log() -> dict:
    return {"calls": 0, "divisor": 1, "seq_gather_bytes": 0}


def make_shard_fn(mesh):
    """Activation constraint: batch axis over the data axes.

    Batch-only by design — the baseline; ``seq_parallel`` in
    launch/perf.py swaps in the sequence-sharded variant.
    """
    if mesh is None:
        return None
    dpax = _dp_axes(mesh)
    n_dp = _axis_size(mesh, dpax)

    def shard(x):
        if x.ndim < 2 or n_dp == 1:
            return x
        if x.shape[0] % n_dp == 0 and x.shape[0] >= n_dp:
            return _constrain(x, mesh, P(dpax, *([None] * (x.ndim - 1))),
                              shard.log)
        return x

    shard.log = _new_log()
    return shard


def make_seq_shard_fn(mesh):
    """Sequence-parallel activation constraint: batch over the data axes
    AND the sequence axis over "model" (for rank-3 activations).

    The alternative to `make_shard_fn`'s batch-only layout — less
    activation memory a device on long-sequence shapes at the cost of an
    all-gather of the sequence before the next layer consumes it (its
    local bytes are logged as ``seq_gather_bytes``).  The
    ``seq_parallel`` experiment in launch/perf.py installs it.
    """
    if mesh is None:
        return None
    n_tp = _model_size(mesh)
    dpax = _dp_axes(mesh)
    n_dp = _axis_size(mesh, dpax)

    def shard(x):
        if x.ndim != 3:
            return x
        batch = dpax if (x.shape[0] % n_dp == 0 and x.shape[0] >= n_dp
                         and n_dp > 1) else None
        seq = "model" if (x.shape[1] % n_tp == 0 and x.shape[1] >= n_tp
                          and n_tp > 1) else None
        if batch or seq:
            if seq:
                local = x.numel() * x.element_size() \
                    // (_axis_size(mesh, batch) * n_tp)
                shard.log["seq_gather_bytes"] += local
            return _constrain(x, mesh, P(batch, seq, None), shard.log)
        return x

    shard.log = _new_log()
    return shard


def make_rep_shard_fn(mesh):
    """Per-repetition weight constraint: pin each super-block's params
    (and hence their gradients) to the stacked parameter layout minus the
    repetition axis."""
    if mesh is None:
        return None

    def rep_shard(rep_params):
        def leaf(path, x):
            expert = path[-1] in EXPERT_LEAVES
            spec = auto_param_spec(x.shape, mesh, expert=expert, skip=0)
            return _constrain(x, mesh, spec, rep_shard.log)

        return _map_with_path(leaf, rep_params)

    rep_shard.log = _new_log()
    return rep_shard
