"""Roofline analysis of one dry-run step (port of `repro.launch.roofline`),
priced for the NVIDIA H100 (`config.H100_SXM`).

Three terms per (arch x shape x mesh):

    compute    = FLOPs_global  / (chips * peak_FLOP/s)
    memory     = bytes_global  / (chips * HBM_bw)
    collective = coll_bytes_perdev / link_bw

The reference reads FLOPs and bytes from XLA's cost analysis of the
compiled SPMD program and parses collectives from its HLO.  The port has
no HLO: `launch/dryrun.py` runs the step once, eagerly, on ``meta``
tensors at published widths (no memory, no card) and counts it.

- **FLOPs**: `torch.utils.flop_counter.FlopCounterMode` over the run (its
  formulas: ``2·m·n·k`` a product, convolutions and attention alike),
  plus what the shapes-only stand-ins of `kernels.meta` charge for the
  kernels and loops they stand in for (the same product count).
- **Bytes accessed**: `CostMode`, a `TorchDispatchMode` that adds each
  op's tensor operands and results, as XLA's "bytes accessed" does; view
  ops and allocations move nothing.  It also tracks the live bytes of
  every storage the step makes (freed when the storage dies) for the
  dry-run's memory estimate.
- **Collective bytes**: analytic, from the sharding plan
  (`plan_collectives`): the operands of the all-gathers, reduce-scatters,
  all-reduces and all-to-alls that the plan's FSDP, tensor-parallel,
  expert and cache layouts imply, times the reference's wire multipliers.
  Counting the ``c10d_functional`` ops of a DTensor run under the fake
  backend was the other way; it needs a sharding rule for every op the
  step runs (the MoE dispatch's index scatter, checkpointing, the
  kernels' autograd Functions), which the models' ops do not all have,
  whereas the plan names every collective's operand directly.

All counts are global (the whole mesh's work), as the reference scales
its per-device cost analysis to global; the collective term is per
device.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.config import H100_SXM, HWSpec
from repro_torch.kernels import meta as META

# bytes-on-the-wire multiplier vs operand size (ring algorithms)
_WIRE_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    def add(self, op: str, operand_bytes: float, count: int = 1) -> None:
        """``count`` collectives of ``op`` on operands of
        ``operand_bytes`` each (per device), at the op's wire multiple."""
        if count <= 0 or operand_bytes <= 0:
            return
        b = operand_bytes * count * _WIRE_MULT[op]
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b
        self.count_by_op[op] = self.count_by_op.get(op, 0) + count

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_op.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.count_by_op.values()))


@dataclass
class Roofline:
    flops: float               # global FLOPs of the step
    hbm_bytes: float           # global bytes accessed
    collective_bytes: float    # per-device wire bytes
    chips: int
    hw: HWSpec = H100_SXM
    collectives: CollectiveStats = None
    model_flops: float = 0.0   # 6*N*D analytic

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
        }


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the bytes each op reads and writes (``bytes``), and tracks the
    live bytes of the storages made under it, a storage of one of
    ``param_shapes`` (a gradient) as grad and any other as act: `peak`
    gives the largest ``act / act_div + grad · grad_ratio`` over the run,
    the divisors chosen after it (`launch/dryrun.py`: how far the
    activation hook sharded, and the plan's shard ratio of the
    parameters).  The stand-ins of `kernels.meta` charge their bytes (and
    FLOPs, into ``extra_flops``) through `charge`."""

    def __init__(self, param_shapes=(), count_bytes: bool = True):
        super().__init__()
        self.param_shapes = {tuple(s) for s in param_shapes}
        self.count_bytes = count_bytes
        self.bytes = 0.0
        self.extra_flops = 0.0
        self.act = self.grad = 0
        self.timeline = []        # (act, grad) after each new storage
        self._seen = set()

    def peak(self, act_div: float = 1.0, grad_ratio: float = 1.0) -> tuple:
        """(peak transient bytes, act and grad bytes at that moment) for
        these divisors."""
        best = (0.0, 0, 0)
        for act, grad in self.timeline:
            now = act / act_div + grad * grad_ratio
            if now > best[0]:
                best = (now, act, grad)
        return best

    def charge(self, flops: float, nbytes: float) -> None:
        self.extra_flops += flops
        if self.count_bytes:
            self.bytes += nbytes

    def __enter__(self):
        META._TALLIES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        META._TALLIES.remove(self)
        return super().__exit__(*exc)

    def _track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        grad = t.is_floating_point() and tuple(t.shape) in self.param_shapes
        self._seen.add(key)
        if grad:
            self.grad += n
        else:
            self.act += n

        def free(key=key, n=n, grad=grad, mode=weakref.ref(self)):
            m = mode()
            if m is not None:
                m._seen.discard(key)
                if grad:
                    m.grad -= n
                else:
                    m.act -= n

        weakref.finalize(st, free)
        self.timeline.append((self.act, self.grad))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        name = func.__name__
        if self.count_bytes and not func.is_view \
                and not name.startswith(("empty", "detach", "alias")):
            self.bytes += sum(map(_tensor_bytes, ins)) \
                + sum(map(_tensor_bytes, outs))
        if not func.is_view:
            # an in-place op's result is its input's storage, not new
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata not in held:
                    self._track(t)
        return out


def plan_collectives(*, kind: str, params, param_sh, mesh, tokens: int,
                     clients=None, client_sh=None, cache=None,
                     cache_sh=None, n_heads: int = 0, n_experts: int = 0,
                     remat: bool = False,
                     shard_logs=()) -> CollectiveStats:
    """Per-device collective operands of one step under the plan.

    ``params``/``param_sh`` are the parameters shared by every data slice
    (the server part of a train state, or a serving model's params) and
    their shardings; ``clients``/``client_sh`` the client-stacked prefix
    (train); ``cache``/``cache_sh`` a decode cache, whose attention has
    ``n_heads`` query heads.  ``tokens`` is the step's global token count;
    ``shard_logs`` the activation hooks' logs of the counted run.

    - FSDP: each shared leaf with a data-sharded dim is all-gathered
      (operand: its local shard) for each forward (train: forward and
      backward, and again under remat); its gradient is reduce-scattered
      (operand: the local shard times the data size), and a shared leaf
      kept whole over data is all-reduced (the Eq. 4 client mean).
    - Client leaves (dim 0 = clients on data): the Eq. 7 aggregation, one
      all-reduce of the local leaf a step (the reference's select runs it
      every step).
    - Tensor parallel: a leaf whose last two dims (its ``[in, out]``
      matrix) carry "model" costs one all-reduce of ``[tokens/dp, the
      other dim]`` activations a forward and one a backward, once per
      repetition of a stacked leaf; expert leaves (an axis of
      ``n_experts`` before the matrix) cost an all-to-all of
      ``[tokens/dp, d]`` there and back a forward per MoE block.
    - Decode caches whose k/v shard head_dim over "model": the scores'
      all-reduce, ``[B/dp, Hq, C]`` fp32, per attention layer and step.
    - Sequence parallelism: the activation hook's logged all-gathers
      (`dist.sharding.make_seq_shard_fn`).
    """
    from repro_torch.dist.sharding import EXPERT_LEAVES, STACK_KEYS
    from repro_torch.launch.mesh import axis_size, dp_axes

    stats = CollectiveStats()
    dpax = dp_axes(mesh)
    n_dp = axis_size(mesh, dpax)
    n_tp = axis_size(mesh, "model")
    train = kind == "train"
    passes = (3 if remat else 2) if train else 1   # forwards + backward
    tok_local = tokens / n_dp

    def axes(e):
        return () if e is None else ((e,) if isinstance(e, str) else e)

    def leaves(tree, sh, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], sh[k], path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, t in enumerate(tree):
                yield from leaves(t, sh[i], path + (str(i),))
        elif isinstance(tree, torch.Tensor):
            yield path, tree, sh

    def tensor_parallel(path, t, sh, reps):
        spec = sh.spec
        if t.dim() < 2 or n_tp == 1:
            return
        if path[-1] in EXPERT_LEAVES and n_experts and t.dim() >= 3 \
                and t.shape[-3] == n_experts:
            if path[-1] == "w_down" and any("model" in axes(e) for e in spec):
                d = t.shape[-1]
                stats.add("all-to-all", tok_local * d * t.element_size(),
                          2 * passes * reps)
            return
        inner, outer = axes(spec[-2]), axes(spec[-1])
        if "model" in inner or "model" in outer:
            other = t.shape[-1] if "model" in inner else t.shape[-2]
            stats.add("all-reduce", tok_local * other * t.element_size(),
                      passes * reps)

    for path, t, sh in leaves(params, param_sh):
        local = sh.local_bytes(t.shape, t.element_size())
        stacked = any(p in STACK_KEYS for p in path)
        reps = t.shape[0] if stacked and t.dim() > 2 else 1
        dp_sharded = any(set(axes(e)) & set(axes(dpax)) for e in sh.spec)
        if dp_sharded:
            stats.add("all-gather", local, passes)
            if train:
                stats.add("reduce-scatter", local * n_dp)
        elif train and n_dp > 1:
            stats.add("all-reduce", local)
        tensor_parallel(path, t, sh, reps)
    if clients is not None:
        for path, t, sh in leaves(clients, client_sh):
            if n_dp > 1:
                stats.add("all-reduce", sh.local_bytes(t.shape,
                                                       t.element_size()))
            stacked = "stack_prefix" in path
            reps = t.shape[1] if stacked and t.dim() > 3 else 1
            tensor_parallel(path, t, sh, reps)
    if cache is not None:
        for path, t, sh in leaves(cache, cache_sh):
            if path[-1] == "k" and t.dim() == 5 and "model" in axes(
                    sh.spec[-1]):
                r, b, c, _, _ = t.shape
                b_local = b // axis_size(mesh, axes(sh.spec[1]))
                stats.add("all-reduce", b_local * n_heads * c * 4, r)
    for log in shard_logs:
        stats.add("all-gather", log.get("seq_gather_bytes", 0))
    return stats


def analytic_model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); D = tokens."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze(flops: float, hbm_bytes: float, collectives: CollectiveStats,
            chips: int, model_flops: float = 0.0,
            hw: HWSpec = H100_SXM) -> Roofline:
    """The roofline of a counted step: ``flops`` and ``hbm_bytes`` global,
    ``collectives`` per device."""
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    collective_bytes=collectives.total_bytes, chips=chips,
                    hw=hw, collectives=collectives, model_flops=model_flops)
