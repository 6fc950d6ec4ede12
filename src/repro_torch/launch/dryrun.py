"""Production dry-run: build every (arch x input-shape x mesh) step at
published widths without a card and price it for the H100 (port of
`repro.launch.dryrun`).

The reference lowers and compiles each combination on 512 placeholder
devices and reads XLA's memory and cost analyses.  The port runs each
step once on the ``meta`` device (shapes only: no memory, no card):

1. the state (train: the HASFL SPMD step's state; prefill / decode: the
   params, and the decode cache) is built on ``meta``, and its sharding
   plan on the production mesh (`dist.sharding`, a `DeviceMesh` under the
   ``fake`` backend) gives each leaf's local shard;
2. the step runs once under `torch.utils.flop_counter.FlopCounterMode`
   and `launch.roofline.CostMode` (bytes accessed, live transient bytes);
3. the roofline prices the counts on `config.H100_SXM`, with the
   collectives the plan implies (`launch.roofline.plan_collectives`).

``per_device_bytes`` is the sharded state's local bytes (and the cache's),
the batch's, and the peak of live transient bytes the step made, one
device's share:
activations divided as far as the activation hook sharded them (its
logged ``divisor``), gradients as far as the plan shards the parameters.
Nothing here runs on the card.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import (INPUT_SHAPES, SSM, H100_SXM, InputShape,
                                ModelConfig, get_config)
from repro_torch.configs.input_shapes import input_specs
from repro_torch.core.sfl import make_hasfl_train_step
from repro_torch.dist.sharding import (batch_shardings, cache_shardings,
                                       make_shard_fn, state_shardings)
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (axis_size, dp_axes,
                                     make_production_mesh, mesh_axes,
                                     release_production_mesh)
from repro_torch.models.factory import build_model
from repro_torch.utils.tree import tree_leaves

SLIDING_WINDOW_500K = 8192

# perf-experiment knobs (overridden by launch/perf.py)
FORCE_REMAT = True
FORCE_ACCUM_SCALE = 1.0

# (arch, shape) combos that are skipped, with the reason.
SKIPS = {
    ("whisper-medium", "long_500k"):
        "enc-dec audio model: 500k-token decode is architecturally "
        "meaningless (30s windows, 448-token decoder context)",
}

META = torch.device("meta")
_DTYPES = {"int32": torch.int32, "int64": torch.int64,
           "float32": torch.float32, "bool": torch.bool}


def variant_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k needs sub-quadratic attention: dense/moe/vlm archs get an
    explicit sliding-window variant; hybrid gets windowed attn layers; SSM
    runs natively."""
    if shape.name == "long_500k" and cfg.family != SSM and cfg.sliding_window == 0:
        return dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_500K)
    return cfg


def choose_cut_reps(cfg: ModelConfig, n_clients: int, repeats: int) -> int:
    """Client-side prefix depth for the SPMD dry-run.

    The prefix is replicated per client, so its parameter bytes are
    multiplied by N.  Pick the deepest cut whose replicated prefix stays
    under ~25% of the server-side params; for expert-dense models (llama4)
    that is cut 0 — client keeps only the embedding, exactly what the
    paper's memory constraint C4 forces for edge devices that cannot hold
    expert layers."""
    total = cfg.param_count()
    per_rep = (total - 2 * cfg.vocab_size * cfg.d_model) / max(repeats, 1)
    # budget: replicated prefix (params + bf16 adam moments, 6 B/param)
    # may cost at most ~1 GB/device on the 256-card pod
    budget_params = 1e9 * 256 / (n_clients * 6)
    best = 0
    for c in range(0, max(1, repeats // 8) + 1):
        prefix = cfg.vocab_size * cfg.d_model + c * per_rep
        if prefix <= budget_params:
            best = c
    return best


def _meta_batch(specs: dict, lead=None) -> dict:
    """``meta`` tensors of ``input_specs``' (shape, dtype) pairs; ``lead``
    reshapes ``[B, ...]`` to ``[N, B/N, ...]`` for the HASFL step."""
    out = {}
    for k, (shp, dt) in specs.items():
        if lead is not None:
            if shp[0] % lead:
                raise ValueError(f"{k} {shp}: batch not divisible by "
                                 f"{lead} clients")
            shp = (lead, shp[0] // lead, *shp[1:])
        out[k] = torch.empty(shp, dtype=_DTYPES[str(dt)], device=META)
    return out


def _dp(mesh) -> int:
    return axis_size(mesh, dp_axes(mesh))


def build_train_combo(cfg: ModelConfig, shape: InputShape, mesh, *,
                      grad_accum: int = 4, optimizer_dtype: str = None,
                      n_clients: int = None, cut_reps: int = None,
                      optimizer_name: str = None, remat: bool = None):
    """The HASFL SPMD train step for this mesh: one client per data slice,
    the reference's cut, optimizer and micro-batching.  ``n_clients``,
    ``cut_reps``, ``optimizer_name`` and ``remat`` pin a run's own
    choices (`chip_smoke.py`'s ``spmd`` step on the host mesh)."""
    from repro_torch.models.transformer import layer_program

    model = build_model(cfg)
    n_clients = n_clients or _dp(mesh)
    b_client = shape.global_batch // n_clients
    accum = max(1, int(grad_accum * FORCE_ACCUM_SCALE))
    while b_client % accum:
        accum -= 1
    _, repeats = layer_program(cfg)
    if cut_reps is None:
        cut_reps = choose_cut_reps(cfg, n_clients, repeats)
    opt_dtype = optimizer_dtype or (
        "bfloat16" if cfg.param_count() > 1e11 else "float32")
    # 300B+: momentum (1 moment) instead of Adam (2)
    opt_name = optimizer_name or (
        "momentum" if cfg.param_count() > 3e11 else "adam")
    remat = FORCE_REMAT if remat is None else remat
    if accum > 1 and cfg.param_count() > 1e11:
        # 100B+ models need deeper accumulation to fit activations
        for cand in (16, 8):
            if b_client % cand == 0:
                accum = max(accum, cand)
                break
    shard_fn = make_shard_fn(mesh)
    init_probe, _ = make_hasfl_train_step(
        model, n_clients=n_clients, cut_reps=cut_reps, agg_interval=15,
        optimizer_name=opt_name, lr=1e-4, optimizer_dtype=opt_dtype)
    state = init_probe(torch.Generator(), device=META)
    state_sh = state_shardings(state, mesh)
    _, train_step = make_hasfl_train_step(
        model, n_clients=n_clients, cut_reps=cut_reps,
        agg_interval=15, optimizer_name=opt_name, lr=1e-4,
        optimizer_dtype=opt_dtype, grad_accum=accum, remat=remat,
        shard_fn=shard_fn,
        param_shardings=(state_sh["client"], state_sh["server"]))
    batch = _meta_batch(input_specs(cfg, shape), lead=n_clients)
    meta = {"n_clients": n_clients, "b_client": b_client,
            "grad_accum": accum, "cut_reps": cut_reps,
            "optimizer_dtype": opt_dtype, "optimizer": opt_name}
    plan = {"params": state["server"], "param_sh": state_sh["server"],
            "clients": state["client"], "client_sh": state_sh["client"],
            "remat": remat, "batch": batch}
    return (lambda: train_step(state, batch), state, state_sh,
            [shard_fn.log], plan, meta)


def build_prefill_combo(cfg: ModelConfig, shape: InputShape, mesh):
    model = build_model(cfg)
    window = cfg.sliding_window or None
    shard_fn = make_shard_fn(mesh)
    params = model.init(torch.Generator(), device=META)
    batch = _meta_batch(input_specs(cfg, shape))
    cache_len = min(shape.seq_len, window or shape.seq_len)

    def run():
        with torch.no_grad():
            return model.prefill(params, batch, cache_len=cache_len,
                                 window=window, shard_fn=shard_fn)

    param_sh = state_shardings(params, mesh)
    return (run, params, param_sh, [shard_fn.log],
            {"params": params, "param_sh": param_sh, "batch": batch}, {})


def build_decode_combo(cfg: ModelConfig, shape: InputShape, mesh):
    model = build_model(cfg)
    window = cfg.sliding_window or None
    cache_len = min(shape.seq_len, window or shape.seq_len)
    shard_fn = make_shard_fn(mesh)
    params = model.init(torch.Generator(), device=META)
    cache = model.init_cache(shape.global_batch, cache_len, window=window,
                             device=META)
    batch = _meta_batch(input_specs(cfg, shape))
    param_sh = state_shardings(params, mesh)
    cache_sh = cache_shardings(cache, mesh)

    def run():
        with torch.no_grad():
            return model.decode_step(params, cache, batch, window=window,
                                     shard_fn=shard_fn)

    state = {"params": params, "cache": cache}
    state_sh = {"params": param_sh, "cache": cache_sh}
    plan = {"params": params, "param_sh": param_sh, "cache": cache,
            "cache_sh": cache_sh, "batch": batch}
    return (run, state, state_sh, [shard_fn.log], plan,
            {"cache_len": cache_len, "window": window or 0})


def _local_bytes(tree, sh_tree) -> tuple:
    """(global, local) bytes of a tree of tensors under its shardings."""
    glob = loc = 0
    for t, sh in zip(tree_leaves(tree), tree_leaves(sh_tree)):
        if isinstance(t, torch.Tensor):
            glob += t.numel() * t.element_size()
            loc += sh.local_bytes(t.shape, t.element_size())
    return glob, loc


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              with_cost: bool = True, mesh=None, shape=None,
              **train_kw) -> dict:
    """One combination's record.  ``mesh`` replaces the production mesh
    (e.g. `make_host_mesh()`), ``shape`` (an `InputShape`) the named
    input shape, and ``train_kw`` go to `build_train_combo`."""
    shape = shape or INPUT_SHAPES[shape_name]
    shape_name = shape.name
    mesh_name = "multi" if multi_pod else "single"
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
    cfg = variant_config(get_config(arch), shape)
    own_mesh = mesh is None
    if own_mesh:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        mesh_name = "x".join(str(v) for v in mesh_axes(mesh).values())
    try:
        return _run(cfg, arch, shape, mesh, mesh_name, with_cost, train_kw)
    finally:
        if own_mesh:
            release_production_mesh()


def _run(cfg, arch, shape, mesh, mesh_name, with_cost, train_kw) -> dict:
    chips = math.prod(mesh_axes(mesh).values())
    t0 = time.time()
    if shape.kind == "train":
        built = build_train_combo(cfg, shape, mesh, **train_kw)
    else:
        build = {"prefill": build_prefill_combo,
                 "decode": build_decode_combo}[shape.kind]
        built = build(cfg, shape, mesh)
    run, state, state_sh, logs, plan, meta = built
    t_build = time.time() - t0
    state_glob, state_loc = _local_bytes(state, state_sh)
    _, batch_loc = _local_bytes(plan["batch"],
                                batch_shardings(plan["batch"], mesh))
    params = plan["params"]
    pshapes = [t.shape for t in tree_leaves(params)
               if isinstance(t, torch.Tensor)]
    if "clients" in plan:
        pshapes += [t.shape for t in tree_leaves(plan["clients"])
                    if isinstance(t, torch.Tensor)]
    cost = RL.CostMode(pshapes, count_bytes=with_cost)
    t1 = time.time()
    fc = FlopCounterMode(display=False) if with_cost else None
    if fc is not None:
        with fc, cost:
            run()
    else:
        with cost:
            run()
    t_run = time.time() - t1
    # one device's transients: activations as far as the activation hook
    # sharded them, gradients as the plan shards the parameters
    act_div = max(log["divisor"] for log in logs)
    pg, pl = _local_bytes(params, plan["param_sh"])
    grad_ratio = pl / pg if pg else 1.0
    transient, peak_act, peak_grad = cost.peak(act_div, grad_ratio)
    per_dev = state_loc + batch_loc + transient
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    coll = RL.plan_collectives(
        kind=shape.kind, params=params, param_sh=plan["param_sh"], mesh=mesh,
        tokens=tokens, clients=plan.get("clients"),
        client_sh=plan.get("client_sh"), cache=plan.get("cache"),
        cache_sh=plan.get("cache_sh"), n_heads=cfg.n_heads,
        n_experts=cfg.n_experts,
        remat=plan.get("remat", False), shard_logs=logs)
    flops = (fc.get_total_flops() if fc is not None else 0) \
        + cost.extra_flops
    rf = RL.analyze(flops, cost.bytes, coll, chips,
                    model_flops=RL.analytic_model_flops(cfg, shape))
    print("cost(%s): flops=%.3e bytes=%.3e coll=%.3e" %
          ("counted" if with_cost else "skipped", rf.flops, rf.hbm_bytes,
           rf.collective_bytes), flush=True)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "status": "ok",
        "lower_s": round(t_build, 1), "compile_s": round(t_run, 1),
        "cost_compile_s": 0.0,
        "cost_source": ("one meta run: FlopCounterMode, CostMode, the plan's "
                        "collectives" if with_cost else
                        "skipped (--no-cost): memory only"),
        "memory": {"state_bytes": state_glob,
                   "state_local_bytes": state_loc,
                   "batch_local_bytes": batch_loc,
                   "peak_activation_bytes": peak_act,
                   "peak_gradient_bytes": peak_grad,
                   "peak_transient_bytes": transient,
                   "activation_divisor": act_div,
                   "gradient_shard_ratio": grad_ratio},
        "per_device_bytes": per_dev,
        "fits_h100_80g": bool(per_dev < H100_SXM.hbm_bytes),
        "roofline": rf.summary(),
        "collectives": {"bytes_by_op": coll.bytes_by_op,
                        "count_by_op": coll.count_by_op},
        **meta,
    }


ASSIGNED = [
    "llama4-maverick-400b-a17b", "phi3-mini-3.8b", "glm4-9b",
    "whisper-medium", "xlstm-350m", "smollm-135m", "internvl2-1b",
    "dbrx-132b", "jamba-v0.1-52b", "qwen3-1.7b",
]


def table(out_dir: str) -> str:
    """A markdown table of the records under ``out_dir``: status,
    per-device GB, ``fits_h100_80g``, bottleneck and wall seconds."""
    rows = ["| arch | shape | mesh | status | per-device GB | fits 80 GB "
            "| bottleneck | wall s |", "| --- " * 8 + "|"]
    for path in sorted(os.listdir(out_dir)):
        if not path.endswith(".json"):
            continue
        with open(os.path.join(out_dir, path)) as f:
            r = json.load(f)
        ok = r["status"] == "ok"
        rf = r.get("roofline") or {}
        rows.append("| {} | {} | {} | {} | {} | {} | {} | {} |".format(
            r["arch"], r["shape"], r["mesh"], r["status"],
            f"{r['per_device_bytes'] / 1e9:.2f}" if ok else "-",
            r.get("fits_h100_80g", "-") if ok else "-",
            rf.get("bottleneck", "-") if ok and rf.get("flops") else "-",
            r.get("wall_s", "-")))
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the FLOP and byte counts (the multi-pod pass "
                         "only needs the memory proof)")
    ap.add_argument("--table", default=None, metavar="DIR",
                    help="print a markdown table of the records in DIR "
                         "and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table))
        return

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape_name}_{'multi' if multi else 'single'}"
                out_path = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[skip existing] {tag}", flush=True)
                    continue
                print(f"=== {tag} ===", flush=True)
                t0 = time.time()
                try:
                    rec = run_combo(arch, shape_name, multi,
                                    with_cost=not args.no_cost)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e)}
                    failures += 1
                rec["wall_s"] = round(time.time() - t0, 1)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(json.dumps({k: v for k, v in rec.items()
                                  if k not in ("memory", "collectives")},
                                 indent=1), flush=True)
    print(f"done; failures={failures}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
