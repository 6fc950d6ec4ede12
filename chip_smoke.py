#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--detail PATH]

Needs one CUDA card and the repo checkout around this file; exits non-zero
and prints no result without either.  It imports nothing of JAX and
nothing of the reference package.  Phases, each printing one JSON line:

1. ``gpu``: the card's name and power limit (``nvidia-smi``).
2. ``build``: builds every kernel of the main paths from the checkout's
   sources (the CUDA GEMM with ``nvcc``, the first compiles of the two
   Triton updates) and times it.
3. ``kernels``: each kernel against its plain PyTorch version on the card
   at the main path's shapes — the client-batched GEMM at every VGG-16
   forward/dW/dx shape at N=8, b=64; `BatchedConv`'s forward and dx/dW/db
   against the plain autograd path (stride 2 and a zeroed cotangent row
   included); the fused clip+SGD update over every participation pattern
   of N=4, a fractional lone survivor, the full cohort, and the 32 VGG-16
   leaves at N=8; the external-mean update of mesh mode at the 32 VGG-16
   leaves at N_local=16, for the global flag u on and off, keep all on
   and all off, with participation weights folded into the mean — with
   times of kernel, plain version and the library yardstick
   (``torch.bmm``), and each kernel's bound on this card.
4. ``train``: the flat main path, `Session(...).run()` for VGG-16 at full
   width, N=8, 12 rounds; the launch counters are zeroed just before and
   read just after: the GEMM and the update > 0, the external-mean
   update 0.
5. ``mesh``: the mesh path at the same width — VGG-16, 16 resident slots
   on a world-size-1 NCCL group, 4 edge servers, a cohort bank over a
   logical population of 1024, 12 rounds with 3 rotations; counters
   zeroed and read around it: the GEMM > 0, the external-mean update on
   every leaf of every round, the flat update 0.  Also the card time of
   the two all-reduces per leaf of a round.
6. ``cross_device``: the same vgg9 session on the card and on the CPU from
   the same weights: decisions, clocks and gather plans bitwise equal,
   losses and final parameters within 1e-4.
7. ``mesh_cross``: a vgg9 mesh session with one edge server against the
   flat session, both on the card from the same weights: decisions,
   clocks and gather plans bitwise equal, losses and parameters within
   1e-4.

Then the per-kernel summary line ``{"kernels": [...]}``, the raw
``nvidia-smi`` line, and, last, ``{"ok": true, "device": {...}}``.  Any
check over its tolerance raises, and the script exits non-zero.  Per-shape
detail goes to ``--detail`` (default ``build/chip_smoke.json``).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores
# (no tensor cores, no TF32) and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

VGG16 = dict(channels=(64, 64, 128, 128, 256, 256, 256,
                       512, 512, 512, 512, 512, 512),
             pools=(2, 4, 7, 10, 13), fc=(512, 512), classes=10, image=32)
CONV_CASES = [  # (n, b, h, w, cin, cout, stride), as the reference's tests
    (1, 2, 8, 8, 3, 5, 1),
    (3, 4, 16, 16, 3, 16, 1),
    (2, 4, 9, 9, 7, 11, 2),
    (4, 3, 8, 8, 4, 8, 2),
]
GEMM_RTOL = 1e-5      # of max|plain|, per sqrt(K/1024): fp32 sums, other order
CONV_FWD_TOL = 2e-5   # the reference's own bars for the conv
CONV_GRAD_TOL = 2e-4
CLIP_TOL = 2e-6
CROSS_TOL = 1e-4
MESH_SLOTS = 16       # resident clients of the mesh phase (N_local at d=1)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds per call over ``reps`` calls after one
    warm-up, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def vgg16_gemm_shapes(n: int = 8, b: int = 64):
    """(name, kind, M, K, C) of every GEMM one VGG-16 training round runs:
    forward, dW and dx of each conv (no dx for the first: the images)."""
    shapes, h, cin = [], VGG16["image"], 3
    for i, cout in enumerate(VGG16["channels"], start=1):
        m = b * h * h
        shapes.append((f"conv{i}.fwd", "fwd", m, 9 * cin, cout))
        shapes.append((f"conv{i}.dW", "dW", 9 * cin, m, cout))
        if i > 1:
            shapes.append((f"conv{i}.dx", "dx", m, 9 * cout, cin))
        cin = cout
        if i in VGG16["pools"]:
            h //= 2
    return shapes


def vgg16_leaf_sizes():
    """Per-client sizes of the 32 VGG-16 parameter leaves (b, w per unit)."""
    sizes, cin = [], 3
    for c in VGG16["channels"]:
        sizes += [c, 9 * cin * c]
        cin = c
    prev = cin  # 1x1 after five pools
    for f in list(VGG16["fc"]) + [VGG16["classes"]]:
        sizes += [f, prev * f]
        prev = f
    return sizes


def phase_gpu():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(",", 1))
    emit({"phase": "gpu", "name": name, "power_limit": limit})
    return out


def phase_build():
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    build.build(["batched_matmul"])
    t_nvcc = time.perf_counter() - t0
    # first Triton compiles of the updates (the N=8 flat and the
    # N_local=16 external-mean specializations)
    p = torch.zeros((8, 64), device="cuda")
    ops.clip_sgd(p, torch.ones_like(p), torch.ones(8, device="cuda"),
                 torch.ones(8, device="cuda", dtype=torch.bool), gamma=0.1)
    p = torch.zeros((MESH_SLOTS, 64), device="cuda")
    ops.clip_sgd(p, torch.ones_like(p), torch.ones(MESH_SLOTS, device="cuda"),
                 torch.zeros(MESH_SLOTS, device="cuda", dtype=torch.bool),
                 gamma=0.1, common=torch.ones(64, device="cuda"),
                 use_common=True)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             build.BUILD_LOGS.get("batched_matmul", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(t_all, 3),
          "nvcc_seconds": round(t_nvcc, 3), "ptxas": ptxas})


def _gemm_checks(detail):
    import torch
    from repro_torch.kernels import batched_conv as BC

    gen = torch.Generator(device="cuda").manual_seed(0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0, flops=0.0, bytes=0.0)
    rows = []
    n = 8
    for name, kind, m, k, c in vgg16_gemm_shapes(n):
        if kind == "dW":
            # patchesᵀ as a transposed view, as the main path passes it
            a = torch.randn((n, k, m), device="cuda",
                            generator=gen).transpose(1, 2)
        else:
            a = torch.randn((n, m, k), device="cuda", generator=gen)
        b = torch.randn((n, k, c), device="cuda", generator=gen)
        out = BC.batched_matmul_kernel(a, b)
        ref = BC.batched_matmul_plain(a, b)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        tol = GEMM_RTOL * scale * max(1.0, (k / 1024) ** 0.5)
        check(err <= tol, f"GEMM {name} {(n, m, k, c)}: max|kernel-plain| "
              f"{err} > {tol}")
        flops = 2.0 * n * m * k * c
        nbytes = 4.0 * n * (m * k + k * c + m * c)
        bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = dict(name=name, shape=[n, m, k, c], max_abs_err=err,
                   ms=time_ms(lambda: BC.batched_matmul_kernel(a, b)),
                   plain_ms=time_ms(lambda: BC.batched_matmul_plain(a, b)),
                   library_ms=time_ms(lambda: torch.bmm(a, b)),
                   bound_ms=bound)
        rows.append(row)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["flops"] += flops
        tot["bytes"] += nbytes
        del a, b, out, ref
    detail["gemm_vgg16_n8_b64"] = rows
    tot["bound_by"] = ("operations" if tot["flops"] / PEAK_FP32_FLOPS
                       >= tot["bytes"] / PEAK_BYTES else "bytes")
    return tot


def _conv_checks():
    import torch
    from repro_torch.kernels import batched_conv as BC
    from repro_torch.kernels import ops

    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(4)
    for n, b, h, w, cin, cout, stride in CONV_CASES:
        def rnd(*shape):
            return torch.randn(shape, device="cuda", generator=gen)
        x, wt, bias = rnd(n, b, h, w, cin), rnd(n, 3, 3, cin, cout) * 0.2, \
            rnd(n, cout)
        outs, grads = [], []
        for fn in (lambda *a: ops.batched_conv(*a, stride=stride),
                   lambda *a: BC.batched_conv_plain(*a, stride=stride)):
            args = [t.clone().requires_grad_() for t in (x, wt, bias)]
            y = fn(*args)
            if not outs:
                dy = torch.randn(y.shape, device="cuda", generator=gen)
                dy[0, -1] = 0.0            # a masked/padded batch row
            outs.append(y.detach())
            grads.append(torch.autograd.grad(y, args, dy))
        err = float((outs[0] - outs[1]).abs().max())
        check(err <= CONV_FWD_TOL, f"conv fwd {(n, b, h, w, cin, cout, stride)}"
              f": {err}")
        worst = max(worst, err)
        for gname, gk, gp in zip(("dx", "dW", "db"), *grads):
            e = float((gk - gp).abs().max())
            check(e <= CONV_GRAD_TOL, f"conv {gname} "
                  f"{(n, b, h, w, cin, cout, stride)}: {e}")
            worst = max(worst, e)
    return worst


def _clip_checks(detail):
    import torch
    from repro_torch.kernels import clip_sgd as CS

    gen = torch.Generator(device="cuda").manual_seed(7)
    gamma = 0.05

    def compare(p, g, scale, keep, part):
        want = CS.clip_sgd_plain(p, g, scale, keep, part, gamma=gamma)
        got = CS.clip_sgd_kernel(p.clone(), g, scale, keep, part,
                                 gamma=gamma)
        return float((got - want).abs().max())

    worst = 0.0
    n, d = 4, 300
    p = torch.randn((n, d), device="cuda", generator=gen)
    g = torch.randn((n, d), device="cuda", generator=gen)
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    cases = [(None, keep) for keep in (True, False)]
    for bits in range(16):
        part = torch.tensor([(bits >> i) & 1 for i in range(n)],
                            device="cuda", dtype=torch.float32)
        cases += [(part, keep) for keep in (True, False)]
    lone = torch.tensor([0.0, 0.3, 0.0, 0.0], device="cuda")
    cases += [(lone, False), (lone, True)]
    for part, keep_spec in cases:
        keep = torch.full((n,), keep_spec, device="cuda") if part is None \
            else (part > 0) & keep_spec
        e = compare(p, g, scale, keep, part)
        check(e <= CLIP_TOL, f"clip_sgd part={part} keep={keep_spec}: {e}")
        worst = max(worst, e)

    # the 32 VGG-16 leaves at N=8: one round's update
    n = 8
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0)
    rows = []
    for i, size in enumerate(vgg16_leaf_sizes()):
        p = torch.randn((n, size), device="cuda", generator=gen)
        g = torch.randn((n, size), device="cuda", generator=gen)
        keep = torch.full((n,), i % 4 != 0, device="cuda")
        e = compare(p, g, scale, keep, None)
        check(e <= CLIP_TOL, f"clip_sgd VGG-16 leaf {i} D={size}: {e}")
        worst = max(worst, e)
        nbytes = 12.0 * n * size
        row = dict(leaf=i, d=size, max_abs_err=e,
                   ms=time_ms(lambda: CS.clip_sgd_kernel(
                       p, g, scale, keep, None, gamma=gamma)),
                   plain_ms=time_ms(lambda: CS.clip_sgd_plain(
                       p, g, scale, keep, None, gamma=gamma)),
                   bound_ms=nbytes / PEAK_BYTES * 1e3)
        rows.append(row)
        for key in ("ms", "plain_ms", "bound_ms"):
            tot[key] += row[key]
        tot["bytes"] += nbytes
    detail["clip_sgd_vgg16_n8"] = rows
    tot["max_abs_err"] = worst
    return tot


def _clip_ext_checks(detail):
    """Kernel 3 at the 32 VGG-16 leaves, N_local=16: each (u, keep)
    combination against the plain version, the mean ``c`` built with
    fractional participation weights folded in; then one mesh round's
    time (keep off, u on: the aggregation round)."""
    import torch
    from repro_torch.kernels import clip_sgd as CS

    gen = torch.Generator(device="cuda").manual_seed(11)
    gamma, n = 0.05, MESH_SLOTS
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    w = torch.rand(n, device="cuda", generator=gen)
    w[::3] = 0.0                                   # dropped clients
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0)
    rows = []
    for i, size in enumerate(vgg16_leaf_sizes()):
        p = torch.randn((n, size), device="cuda", generator=gen)
        g = torch.randn((n, size), device="cuda", generator=gen)
        spec = p - gamma * (g * scale[:, None])
        common = (spec * w[:, None]).sum(0) / w.sum()
        leaf_err = 0.0
        for keep_on in (True, False):
            keep = torch.full((n,), keep_on, device="cuda")
            for use in (True, False):
                u = torch.tensor(use, device="cuda")
                want = CS.clip_sgd_ext_plain(p, g, scale, keep, common, u,
                                             gamma=gamma)
                got = CS.clip_sgd_ext_kernel(p.clone(), g, scale, keep,
                                             common, u, gamma=gamma)
                e = float((got - want).abs().max())
                check(e <= CLIP_TOL, f"clip_sgd_ext VGG-16 leaf {i} D={size}"
                      f" keep={keep_on} u={use}: {e}")
                leaf_err = max(leaf_err, e)
        worst = max(worst, leaf_err)
        keep = torch.zeros(n, dtype=torch.bool, device="cuda")
        u = torch.tensor(True, device="cuda")
        nbytes = 12.0 * n * size + 4.0 * size
        row = dict(leaf=i, d=size, max_abs_err=leaf_err,
                   ms=time_ms(lambda: CS.clip_sgd_ext_kernel(
                       p, g, scale, keep, common, u, gamma=gamma)),
                   plain_ms=time_ms(lambda: CS.clip_sgd_ext_plain(
                       p, g, scale, keep, common, u, gamma=gamma)),
                   bound_ms=nbytes / PEAK_BYTES * 1e3)
        rows.append(row)
        for key in ("ms", "plain_ms", "bound_ms"):
            tot[key] += row[key]
        tot["bytes"] += nbytes
    detail["clip_sgd_ext_vgg16_n16"] = rows
    tot["max_abs_err"] = worst
    return tot


def phase_kernels(detail):
    from repro_torch.device import disable_tf32

    disable_tf32()
    gemm = _gemm_checks(detail)
    conv_err = _conv_checks()
    clip = _clip_checks(detail)
    ext = _clip_ext_checks(detail)
    emit({"phase": "kernels",
          "batched_matmul": {k: gemm[k] for k in (
              "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
          "batched_conv_max_err": conv_err,
          "clip_sgd": {k: clip[k] for k in (
              "ms", "plain_ms", "bound_ms", "max_abs_err")},
          "clip_sgd_ext": {k: ext[k] for k in (
              "ms", "plain_ms", "bound_ms", "max_abs_err")},
          "note": "ms = one VGG-16 round's shapes summed: GEMM and flat "
                  "update at N=8 (b=64), external-mean update at N=16"})
    return gemm, clip, ext


def phase_train():
    import math
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops

    spec = ExperimentSpec(
        arch="vgg16-cifar", n_clients=8, partition="iid", n_train=4096,
        n_test=512, rounds=12, eval_every=4, policy="hasfl",
        conv_impl="kernel", update_impl="kernel",
        sfl=SFLConfig(lr=0.05, agg_interval=3))
    sess = Session(spec)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    out = {"phase": "train", "arch": spec.arch, "n_clients": spec.n_clients,
           "rounds": spec.rounds, "seconds": seconds,
           "seconds_per_round": seconds / spec.rounds,
           "train_loss": res.train_loss, "test_loss": res.test_loss,
           "test_acc": res.test_acc, "clock": res.clock,
           "b_history": [list(map(int, b)) for b in res.b_history],
           "cut_history": [list(map(int, c)) for c in res.cut_history],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches}
    emit(out)
    check(len(res.train_loss) == spec.rounds // spec.eval_every,
          f"train: {len(res.train_loss)} evals")
    check(all(math.isfinite(v) for v in
              res.train_loss + res.test_loss + res.clock),
          "train: non-finite loss or clock")
    check(all(0.0 <= a <= 1.0 for a in res.test_acc), "train: accuracy")
    finite = all(bool(torch.isfinite(t).all()) for u in sess.sim._stacked
                 for t in u.values())
    check(finite, "train: non-finite parameters")
    for name in ("batched_matmul", "clip_sgd"):
        check(launches[name] > 0, f"train: kernel {name} never launched")
    check(launches["clip_sgd_ext"] == 0,
          "train: the flat path launched the external-mean update")
    return out


def _allreduce_ms(group) -> float:
    """Card time of one mesh round's all-reduces: per VGG-16 leaf, the
    [D] edge-sum total and the survivor count (CUDA events, 5 calls after
    a warm-up each, summed over the 32 leaves)."""
    import torch
    import torch.distributed as dist

    total = 0.0
    cnt = torch.ones((), device="cuda")
    for size in vgg16_leaf_sizes():
        buf = torch.ones(size, device="cuda")
        total += time_ms(lambda: (dist.all_reduce(buf, group=group),
                                  dist.all_reduce(cnt, group=group)))
    return total


def phase_mesh():
    import math
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops
    from repro_torch.mesh import MeshSpec

    spec = ExperimentSpec(
        arch="vgg16-cifar", n_clients=MESH_SLOTS, partition="iid",
        n_train=16384, n_test=512, rounds=12, eval_every=4, policy="hasfl",
        conv_impl="kernel", update_impl="kernel",
        sfl=SFLConfig(lr=0.05, agg_interval=3),
        mesh=MeshSpec(devices=1, n_edges=4, population=1024))
    sess = Session(spec)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sess.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_leaves = sum(len(u) for u in sess.sim._stacked)
    out = {"phase": "mesh", "arch": spec.arch, "n_clients": spec.n_clients,
           "mesh": spec.mesh.to_dict(), "rounds": spec.rounds,
           "seconds": seconds, "seconds_per_round": seconds / spec.rounds,
           "rotations": sess.sim._bank.rotations,
           "train_loss": res.train_loss, "test_loss": res.test_loss,
           "test_acc": res.test_acc, "clock": res.clock,
           "b_history": [list(map(int, b)) for b in res.b_history],
           "cut_history": [list(map(int, c)) for c in res.cut_history],
           "max_memory_allocated": peak, "launches": launches,
           "allreduce_ms_per_round": _allreduce_ms(sess.sim._group)}
    emit(out)
    check(len(res.train_loss) == spec.rounds // spec.eval_every,
          f"mesh: {len(res.train_loss)} evals")
    check(all(math.isfinite(v) for v in
              res.train_loss + res.test_loss + res.clock),
          "mesh: non-finite loss or clock")
    check(all(b > a for a, b in zip(res.clock, res.clock[1:]))
          and res.clock[0] > 0, "mesh: the tiered clock does not grow")
    check(all(0.0 <= a <= 1.0 for a in res.test_acc), "mesh: accuracy")
    check(out["rotations"] == 3, f"mesh: {out['rotations']} rotations")
    finite = all(bool(torch.isfinite(t).all()) for u in sess.sim._stacked
                 for t in u.values())
    check(finite, "mesh: non-finite parameters")
    check(launches["batched_matmul"] > 0, "mesh: the GEMM never launched")
    check(launches["clip_sgd_ext"] == n_leaves * spec.rounds,
          f"mesh: {launches['clip_sgd_ext']} external-mean launches, not "
          f"{n_leaves} leaves x {spec.rounds} rounds")
    check(launches["clip_sgd"] == 0, "mesh: the flat update launched")
    return out


def phase_cross_device():
    import numpy as np
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig, get_config
    from repro_torch.convert import units_to_numpy
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves

    spec = ExperimentSpec(
        arch="vgg9-cifar-small", n_clients=4, partition="iid", n_train=400,
        n_test=100, rounds=4, eval_every=2, policy="hasfl", estimate=False,
        sfl=SFLConfig(lr=0.05, agg_interval=2))
    init = units_to_numpy(build_model(get_config(spec.arch)).init(
        torch.Generator().manual_seed(0)))
    runs = {}
    for dev in ("cuda", "cpu"):
        sess = Session(spec, device=dev, init_units=init)
        plans = []
        draw = sess.sim.store.segment_indices

        def recording(*a, draw=draw, plans=plans):
            plans.append(draw(*a))
            return plans[-1]

        sess.sim.store.segment_indices = recording
        res = sess.run()
        runs[dev] = (res, plans, units_to_numpy(sess.sim._stacked))
    (rg, pg, wg), (rc, pc, wc) = runs["cuda"], runs["cpu"]
    same = lambda xs, ys: len(xs) == len(ys) and all(
        np.array_equal(x, y) for x, y in zip(xs, ys))
    check(same(rg.b_history, rc.b_history), "cross: b_history")
    check(same(rg.cut_history, rc.cut_history), "cross: cut_history")
    check(rg.clock == rc.clock, "cross: clock")
    check(same(pg, pc), "cross: gather plans")
    loss_err = max(abs(a - b) for a, b in zip(
        rg.train_loss + rg.test_loss + rg.test_acc,
        rc.train_loss + rc.test_loss + rc.test_acc))
    param_err = max(float(np.max(np.abs(a - b))) for a, b in zip(
        tree_leaves(wg), tree_leaves(wc)))
    emit({"phase": "cross_device", "arch": spec.arch,
          "b_history": [list(map(int, b)) for b in rg.b_history],
          "clock": rg.clock, "loss_acc_max_err": loss_err,
          "param_max_err": param_err})
    check(loss_err <= CROSS_TOL, f"cross: losses differ by {loss_err}")
    check(param_err <= CROSS_TOL, f"cross: parameters differ by {param_err}")


def phase_mesh_cross():
    import numpy as np
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig, get_config
    from repro_torch.convert import units_to_numpy
    from repro_torch.mesh import MeshSpec
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves

    flat = ExperimentSpec(
        arch="vgg9-cifar-small", n_clients=4, partition="iid", n_train=400,
        n_test=100, rounds=4, eval_every=2, policy="hasfl", estimate=False,
        sfl=SFLConfig(lr=0.05, agg_interval=2))
    init = units_to_numpy(build_model(get_config(flat.arch)).init(
        torch.Generator().manual_seed(0)))
    runs = {}
    for name, spec in (("mesh", flat.replace(
            mesh=MeshSpec(devices=1, n_edges=1))), ("flat", flat)):
        sess = Session(spec, init_units=init)
        plans = []
        draw = sess.sim.store.segment_indices

        def recording(*a, draw=draw, plans=plans):
            plans.append(draw(*a))
            return plans[-1]

        sess.sim.store.segment_indices = recording
        res = sess.run()
        runs[name] = (res, plans, units_to_numpy(sess.sim._stacked))
    (rm, pm, wm), (rf, pf, wf) = runs["mesh"], runs["flat"]
    same = lambda xs, ys: len(xs) == len(ys) and all(
        np.array_equal(x, y) for x, y in zip(xs, ys))
    check(same(rm.b_history, rf.b_history), "mesh_cross: b_history")
    check(same(rm.cut_history, rf.cut_history), "mesh_cross: cut_history")
    check(rm.clock == rf.clock, "mesh_cross: clock")
    check(same(pm, pf), "mesh_cross: gather plans")
    loss_err = max(abs(a - b) for a, b in zip(
        rm.train_loss + rm.test_loss + rm.test_acc,
        rf.train_loss + rf.test_loss + rf.test_acc))
    param_err = max(float(np.max(np.abs(a - b))) for a, b in zip(
        tree_leaves(wm), tree_leaves(wf)))
    emit({"phase": "mesh_cross", "arch": flat.arch,
          "b_history": [list(map(int, b)) for b in rm.b_history],
          "clock": rm.clock, "loss_acc_max_err": loss_err,
          "param_max_err": param_err})
    check(loss_err <= CROSS_TOL, f"mesh_cross: losses differ by {loss_err}")
    check(param_err <= CROSS_TOL,
          f"mesh_cross: parameters differ by {param_err}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--detail", default=str(ROOT / "build" / "chip_smoke.json"),
                    help="where the per-shape kernel detail is written")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repo (src/ "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = phase_gpu()
    phase_build()
    detail = {"gpu": smi}
    gemm, clip, ext = phase_kernels(detail)
    train = phase_train()
    mesh = phase_mesh()
    phase_cross_device()
    phase_mesh_cross()
    import torch.distributed as dist

    dist.destroy_process_group()      # the mesh phases' world of one

    launches = train["launches"]
    kernels = [
        {"name": "batched_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/batched_matmul.cu",
         "replaces": "src/repro/kernels/batched_conv.py:63",
         "launches": launches["batched_matmul"],
         "max_abs_err": gemm["max_abs_err"], "ms": gemm["ms"],
         "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
         "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"]},
        {"name": "clip_sgd", "route": "triton",
         "source": "src/repro_torch/kernels/clip_sgd.py",
         "replaces": "src/repro/kernels/clip_sgd.py:29",
         "launches": launches["clip_sgd"],
         "max_abs_err": clip["max_abs_err"], "ms": clip["ms"],
         "plain_ms": clip["plain_ms"], "bound_ms": clip["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "clip_sgd_ext", "route": "triton",
         "source": "src/repro_torch/kernels/clip_sgd.py",
         "replaces": "src/repro/kernels/clip_sgd.py:44",
         "launches": mesh["launches"]["clip_sgd_ext"],
         "max_abs_err": ext["max_abs_err"], "ms": ext["ms"],
         "plain_ms": ext["plain_ms"], "bound_ms": ext["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
    ]
    detail["kernels"] = kernels
    detail["train"] = train
    detail["mesh"] = mesh
    path = Path(args.detail)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(detail, indent=1))

    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
