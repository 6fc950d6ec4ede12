#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--detail PATH]

Needs one CUDA card and the repo checkout around this file; exits non-zero
and prints no result without either.  It imports nothing of JAX and
nothing of the reference package.  Phases, each printing one JSON line:

1. ``gpu``: the card's name and power limit (``nvidia-smi``).
2. ``build``: builds every kernel of the main paths from the checkout's
   sources (one ``nvcc`` a source, all started together) and times it.
3. ``kernels``: each kernel against its plain PyTorch version on the card
   at the main path's shapes — the client-batched GEMM at every VGG-16
   forward/dW/dx shape at N=8, b=64; `BatchedConv`'s forward and dx/dW/db
   against the plain autograd path (stride 2 and a zeroed cotangent row
   included); the fused clip+SGD update over every participation pattern
   of N=4, a fractional lone survivor, the full cohort, and the 32 VGG-16
   leaves at N=8; the external-mean update of mesh mode at the 32 VGG-16
   leaves at N_local=16, for the global flag u on and off, keep all on
   and all off, with participation weights folded into the mean — each
   through the one-leaf entry points; then both as the main path calls
   them, one round's 32 leaves in one launch against the plain loop, with
   mixed keeps, with participation and at N=30 — with times of kernel,
   plain version and the library yardstick (``torch.bmm``), and each
   kernel's bound on this card.  Then both as the grid runner calls them,
   four cells of N=8 folded into one call (the ``grid`` entry): the GEMM
   at the split-K dW shapes planned per cell, bitwise equal to the
   one-cell calls (the unplanned call's difference recorded as the
   witness), and one round's update of four cells' 32 leaves in two
   launches, bitwise equal to four one-cell launches.
4. ``train``: the flat main path, `Session(...).run()` for VGG-16 at full
   width, N=8, 12 rounds; the launch counters are zeroed just before and
   read just after: the GEMM > 0, the update once a round, the
   external-mean update 0.
5. ``mesh``: the mesh path at the same width — VGG-16, 16 resident slots
   on a world-size-1 NCCL group, 4 edge servers, a cohort bank over a
   logical population of 1024, 12 rounds with 3 rotations; counters
   zeroed and read around it: the GEMM > 0, the external-mean update once
   a round, the flat update 0.  Also the card time of the two all-reduces
   per leaf of a round.
6. ``cross_device``: the same vgg9 session on the card and on the CPU from
   the same weights: decisions, clocks and gather plans bitwise equal,
   losses and final parameters within 1e-4.
7. ``mesh_cross``: a vgg9 mesh session with one edge server against the
   flat session, both on the card from the same weights: decisions,
   clocks and gather plans bitwise equal, losses and parameters within
   1e-4.
8. ``grid_cross``: `run_grid` on the card against each cell's own
   `run()`, at ``cross_device``'s sizes: three policies crossing pow2
   buckets (one with the estimating controller), and seeds x partitions
   (one folded carry of four cells reading their own data).  Decisions,
   clocks, gather plans, losses, accuracies and parameters bitwise equal;
   the op-by-op witness of one folded round body against per-cell ones
   goes to ``--detail``.
9. ``grid``: `run_grid` on four full-width cells (VGG-16, N=8, 12 rounds,
   {hasfl, rbs+rms} x seed {0, 1}), timed against the same four cells run
   one after another; counters zeroed just before and read just after:
   the GEMM once per conv GEMM of a dispatch round (not per cell), the
   update ⌈members·32/64⌉ times a round per dispatch, the external-mean
   update 0; every cell bitwise equal to its own run.  Seconds, seconds
   per cell-round, peak memory and the dispatch record.
10. ``scenario``: the train phase's cell under ``churn-heavy`` with
   deadline faults (`SCENARIO`), run uninterrupted, again writing a
   snapshot every 6 rounds (0.49 GB each, in a temporary directory under
   build/, removed at the end), and resumed from round 6 by
   `Session.resume`; counters zeroed and read around the first run: the
   GEMM > 0, the update once a round.  Both later runs bitwise equal to
   the first (results and final parameters).  Seconds per round, snapshot
   seconds, peak memory, mean participation.
11. ``traffic``: the same cohort (8 slots) under ``churn-heavy`` with the
   streaming plane (`TRAFFIC`), the same three runs, the event log
   bitwise too; more admits than the cohort, an eviction, a fractional
   staleness weight, one update launch a round.  Event counts by kind.
12. ``dynamic_cross``: vgg9 at ``cross_device``'s sizes on the card
   against the CPU: the scenario cell, a traffic cell (`TRAFFIC_CROSS`)
   and a 2 x 2 grid of policies x presets through `run_grid`; decisions,
   clocks, gather and participation plans and event logs bitwise, losses
   and parameters within 1e-4, each grid cell bitwise equal to its own
   run on the card.
13. ``cli``: `repro_torch.launch.train.main(CLI_ARGS + ["--csv", ...])`
   on the card: one CSV row per eval, the ``.spec.json`` reloading equal,
   the numbers bitwise equal to `Session(spec).run()`.
14. ``serve``: the token-model serving path, `repro_torch.launch.serve.serve`
   for qwen3-1.7b at full width (28 layers, d 2048, vocab 151936, bf16)
   with the port's seeded init and `launch.serve.FULL_WIDTH_TRAFFIC`
   (8 prompts of 512 tokens, a cache of 544, prefill and 32 greedy
   decode steps), run twice: the first warms up at the same shapes, the
   second is reported, its counters zeroed just before and read just
   after: flash attention 28 and RMSNorm 113 launches per forward, 33
   forwards, the prefill's 28 flash launches all on the tensor-core path
   and every decode step's 28 on the split-KV path.  Prefill ms, decode
   ms per step, tokens/s, peak memory.
15. ``serve_ssm``: the same on xlstm-350m at full width (24 layers, bf16):
   20 mLSTM-scan launches (prefill only), all 20 on the tensor-core
   parallel form and none on the recurrence, 49 RMSNorms per forward.
16. ``serve_glm4``, ``serve_phi3``, ``serve_dbrx``, ``serve_llama4``,
   ``serve_jamba``, ``serve_whisper``, ``serve_internvl2``
   (`FAMILY_SERVES`): the same for every other token family at its
   published widths, whole where 80 GB allows (glm4 40 layers, phi3 32 at
   hd 96, whisper 24 + 24 encoder layers over 1500 frames, internvl2 24
   with GQA group 7) and cut to whole super-blocks where it does not
   (dbrx 4 of 40 layers, 16 experts top-4; llama4 2 of 48, a dense and a
   128-expert top-1 layer; jamba 8 of 32: 7 mamba, 1 attention, 4 MoE),
   each with the family's modality stubs.  Flash attention once per
   attention block (self, cross, and the encoder's in prefill) and
   RMSNorm once per norm (mamba's ``norm_in`` and ``enc_final_norm``
   included); the MoE phases print each forward's dropped share (from the
   warm-up run).  Each model is freed before the next is built; each
   phase reports its own peak memory and weight bytes.
17. ``serve_cross``: the card with its kernels against the CPU with the
   plain versions, on the same fp32 weights (TF32 off), every token
   family cut as ``SERVE_CROSS`` says (qwen3 to 2 layers, xlstm to one
   period of 6, the MoE families in depth and llama4/jamba in experts),
   full width otherwise; 2 prompts of 64 tokens, then 8 decode steps
   teacher-forced with the CPU's greedy tokens.  Prefill and decode
   logits within 1e-4 (2e-4 for xlstm; rtol = atol), greedy ids equal,
   the MoE families' chosen experts equal in every MoE call, every fp32
   mLSTM launch on the recurrence.  For xlstm the phase also reports the
   same card run with the mLSTM scan's plain version in place of the
   kernel, against the CPU and against the kernel run: the witness of
   xlstm's bar.

The GEMM's split-K (conv1.dW, conv2.dW) must repeat bitwise.  The
``kernels`` phase also holds the token-model kernels against their
plain versions on the card — flash attention (the reference's cases,
the tensor-core prefill at hd 64 and 32, off its 128-row tile and with a
window and ``sk_valid``, the split-KV decode at ``sk_valid`` 1 and at
qwen3's decode shape, bitwise repeatable there, each call on its path;
then the other families' shapes, timed as their forward's calls: phi3's
hd 96 in bf16 and fp32, whisper's encoder, cross-attention and decode
cross step, the GQA groups 7 and 16 of internvl2 and glm4),
RMSNorm (the reference's cases, every norm shape of the serve phases and
of ``serve_cross``) and the mLSTM scan (the reference's cases, the paths'
edges in ``MLSTM_PATH_CASES`` — S off the 64-row tile, hd 64 and 32,
extreme gates — xlstm-350m's prefill shape in bf16 and serve_cross's in
fp32, each call on its path, the tensor-core path bitwise repeatable) —
at the reference's bars.  Each is timed as one forward's calls back to
back in one CUDA-event span (``calls`` of them: 28 flash, 113 RMSNorms in
qwen3's order for prefill and for decode, 20 scans), beside its bound, its
plain version and the library yardstick (``F.scaled_dot_product_attention``,
``F.rms_norm``; the mLSTM scan has none); RMSNorm and the scan also as
``device_ms``, the span captured once in a CUDA graph and replayed (no
host launch time).  The scan's bf16 row carries two bounds: its own form's
(the parallel form's operations or the bytes) and the fp32 recurrence's
operations (``recurrence_bound_ms``).

Then the per-kernel summary line ``{"kernels": [...]}``, the raw
``nvidia-smi`` line, and, last, ``{"ok": true, "device": {...}}``.  Any
check over its tolerance raises, and the script exits non-zero.  Per-shape
detail goes to ``--detail`` (default ``build/chip_smoke.json``).
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores
# (no tensor cores, no TF32), bf16 on the tensor cores (dense), and HBM3
# bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
# the grid phase's cells: the train phase's VGG-16 at full width, crossed
# over policy {hasfl, rbs+rms} and seed {0, 1}
GRID = dict(arch="vgg16-cifar", n_clients=8, partition="iid", n_train=4096,
            n_test=512, rounds=12, eval_every=4)
# the scenario phase's cell: the train phase's spec under the reference
# resume test's maximal-state settings (churn masks and deadline faults
# into kernel 2), snapshots every 6 rounds
SCENARIO = dict(scenario="churn-heavy", scenario_seed=7, fault_mode="deadline",
                deadline_factor=2.0)
CHECKPOINT_EVERY = 6
# the traffic phase's plane: benchmarks/traffic_sweep.py's shape, arrival
# rate and dwell matched to the plane's virtual clock at VGG-16 so the
# cohort churns within 12 rounds.  That clock has no Eq. 38 barrier and no
# Eq. 39 exchange: it reads ~0.56 virtual s after 12 rounds where the
# synchronous clock reads ~31 s, so at 0.5 arrivals/s and a 10 s dwell a
# run would expect 0.28 arrivals and 0.44 of 8 users departing
TRAFFIC = dict(n_users=100_000, arrival_rate=20.0, mean_dwell=0.5,
               buffer_frac=0.5, staleness_alpha=0.5, shard_size=150, seed=11)
# dynamic_cross's traffic plane at vgg9's virtual clock (~0.01 s a round):
# the reference's churny cell (tests/test_traffic.py)
TRAFFIC_CROSS = dict(n_users=500, arrival_rate=300.0, mean_dwell=0.02,
                     buffer_frac=0.5, staleness_alpha=0.5, shard_size=40,
                     seed=3)
# the cli phase's command line (the reference launcher's small edge run,
# under a scenario), its CSV under build/
CLI_ARGS = ["--mode", "edge", "--arch", "vgg9-cifar-small", "--clients", "4",
            "--rounds", "12", "--agg-interval", "3", "--eval-every", "4",
            "--n-train", "400", "--n-test", "100", "--iid", "--scenario",
            "straggler-bursts"]

# the reference's own token-kernel cases (tests/test_kernels.py) and bars
FLASH_CASES = [  # (b, sq, sk, hq, hkv, hd, causal, window, dtype)
    (1, 128, 128, 4, 2, 64, True, 0, "float32"),
    (2, 64, 256, 8, 8, 32, True, 0, "float32"),
    (1, 96, 96, 4, 1, 128, True, 32, "float32"),
    (1, 128, 128, 2, 2, 64, False, 0, "float32"),
    (1, 200, 200, 3, 1, 64, True, 0, "float32"),
    (1, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (2, 32, 512, 4, 4, 64, True, 128, "bfloat16"),
]
MLSTM_CASES = [(1, 64, 2, 32, "float32"), (2, 100, 2, 32, "float32"),
               (1, 96, 4, 64, "float32"), (1, 64, 2, 32, "bfloat16")]
# the mLSTM paths' own edges, (b, s, h, hd, dtype, gates): bf16 takes the
# parallel form on the tensor cores, fp32 the recurrence; "extreme" gates
# have forget pre-activations of ±30 and input ones at -1e30 (the first
# steps and 30 % of the rest), so D underflows and m takes the i branch
MLSTM_PATH_CASES = [(1, 200, 2, 512, "bfloat16", "normal"),
                    (1, 96, 4, 64, "bfloat16", "normal"),
                    (2, 100, 2, 32, "bfloat16", "normal"),
                    (1, 130, 2, 512, "bfloat16", "extreme"),
                    (2, 70, 2, 32, "bfloat16", "extreme"),
                    (1, 130, 2, 64, "float32", "extreme")]
RMSNORM_CASES = [((4, 128), "float32"), ((3, 50, 96), "float32"),
                 ((2, 17, 256), "bfloat16"), ((1, 1, 512), "bfloat16")]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
RMSNORM_TOL = 2e-2
SERVE_CROSS = dict(batch=2, prompt=64, gen=8, seed=1,
                   # each arch's cut (fp32 weights live on the card and
                   # again on the host): depth, and the experts of the two
                   # MoE families whose fp32 experts would not fit
                   cuts={"qwen3-1.7b": dict(n_layers=2),
                         "xlstm-350m": dict(n_layers=6),
                         "glm4-9b": dict(n_layers=2),
                         "phi3-mini-3.8b": dict(n_layers=2),
                         "dbrx-132b": dict(n_layers=1),
                         "llama4-maverick-400b-a17b": dict(n_layers=2,
                                                           n_experts=8),
                         "jamba-v0.1-52b": dict(n_layers=8, n_experts=4),
                         "whisper-medium": dict(n_layers=2,
                                                n_encoder_layers=2),
                         "internvl2-1b": dict(n_layers=2)},
                   # fp32 logits, rtol = atol.  1e-4 is the CPU parity
                   # tests' bar; xlstm takes the reference's own fp32 bar
                   # for the mLSTM recurrence (2e-4): its den = |n . q|
                   # cancels, so fp32 sums taken in another order move its
                   # logits by ~1e-4, with the scan's plain version on the
                   # card too (the phase's witness)
                   tol={"xlstm-350m": 2e-4}, default_tol=1e-4)
# the serving phases of the other token families: (phase, arch, layers on
# the card or None for the whole model); depth cut only where 80 GB forces
# it, in whole super-blocks (llama4: one dense + one 128-expert layer;
# jamba: 7 mamba + 1 attention layer, 4 of them MoE)
FAMILY_SERVES = [("serve_glm4", "glm4-9b", None),
                 ("serve_phi3", "phi3-mini-3.8b", None),
                 ("serve_dbrx", "dbrx-132b", 4),
                 ("serve_llama4", "llama4-maverick-400b-a17b", 2),
                 ("serve_jamba", "jamba-v0.1-52b", 8),
                 ("serve_whisper", "whisper-medium", None),
                 ("serve_internvl2", "internvl2-1b", None)]


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


def _ptxas_lines(log: str):
    """ptxas's per-kernel report: each entry's (demangled where short)
    name, then its registers / shared memory and spill lines."""
    keep = []
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            keep.append(ln.split("'")[1] if "'" in ln else ln)
        elif "registers" in ln or "spill" in ln or "warning" in ln:
            keep.append(ln.replace("ptxas info    : ", ""))
    return keep


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    sources = ["batched_matmul", "clip_sgd", "flash_attention", "rmsnorm",
               "mlstm_scan"]
    build.build(sources)
    seconds = time.perf_counter() - t0
    ptxas = {name: _ptxas_lines(build.BUILD_LOGS.get(name, ""))
             for name in sources}
    emit({"phase": "build", "seconds": round(seconds, 3), "ptxas": ptxas})


def _gemm_checks(detail):
    import torch
    from repro_torch.kernels import batched_conv as BC

    gen = torch.Generator(device="cuda").manual_seed(0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0, flops=0.0, bytes=0.0)
    rows = []
    n = 8
    sms = torch.cuda.get_device_properties("cuda").multi_processor_count
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
        splits = BC.gemm_splits(n, m, k, c, sms)[0]
        if name in ("conv1.dW", "conv2.dW"):
            # split-K reduces its partials in a fixed order
            check(splits > 1 and torch.equal(out, BC.batched_matmul_kernel(
                a, b)), f"GEMM {name}: split-K ({splits} splits) not "
                "bitwise repeatable")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        tol = GEMM_RTOL * scale * max(1.0, (k / 1024) ** 0.5)
        check(err <= tol, f"GEMM {name} {(n, m, k, c)}: max|kernel-plain| "
              f"{err} > {tol}")
        flops = 2.0 * n * m * k * c
        nbytes = 4.0 * n * (m * k + k * c + m * c)
        bound = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        row = dict(name=name, shape=[n, m, k, c], splits=splits,
                   max_abs_err=err,
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


def _round_inputs(gen, n, gamma, ext, part=None, keeps=None):
    """One VGG-16 round's update inputs on the card at N=n: (ps, gs,
    scale, keep_specs, participation, commons, count); ``keeps`` defaults
    to mixed (leaf i keeps where i % 4 != 0); with ``ext`` the means of
    the external form, participation folded in."""
    import torch

    sizes = vgg16_leaf_sizes()
    ps = [torch.randn((n, d), device="cuda", generator=gen) for d in sizes]
    gs = [torch.randn((n, d), device="cuda", generator=gen) for d in sizes]
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    keeps = keeps or [i % 4 != 0 for i in range(len(sizes))]
    commons = count = None
    if ext:
        w = torch.ones(n, device="cuda") if part is None else part
        count = w.sum()
        commons = [((p - gamma * (g * scale[:, None])) * w[:, None]).sum(0)
                   / torch.where(count > 0, count, 1.0)
                   for p, g in zip(ps, gs)]
    return ps, gs, scale, keeps, part, commons, count


def _round_checks(gen, n_timed, gamma, ext):
    """The round call as the main path makes it — one launch over the 32
    VGG-16 leaves, updated in place — against the plain loop: mixed keeps
    at ``n_timed``, with participation (fractional, every third client
    dropped), every leaf on the aggregation side, and at N=30.  Then the
    timed round at ``n_timed``: the flat update with mixed keeps (the
    elementwise and the mean form, 12·N·ΣD bytes either way), the external
    mean on the aggregation round (keep off, use on: each row written from
    the mean, p and g not read, 4·N·ΣD + 4·ΣD bytes).  Returns (worst
    error, timings)."""
    import torch
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.timing import graph_ms

    def weights(n):
        w = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
        w[::3] = 0.0
        return w

    sizes = vgg16_leaf_sizes()
    cases = [(n_timed, None, None), (n_timed, weights(n_timed), None),
             (n_timed, weights(n_timed), [False] * len(sizes)),
             (30, weights(30), None)]
    worst = 0.0
    for n, part, keeps in cases:
        ps, gs, scale, keeps, part, commons, count = _round_inputs(
            gen, n, gamma, ext, part, keeps)
        want = CS.clip_sgd_leaves_plain(ps, gs, scale, keeps, part,
                                        gamma=gamma, commons=commons,
                                        count=count)
        got = CS.clip_sgd_leaves_kernel(ps, gs, scale, keeps, part,
                                        gamma=gamma, commons=commons,
                                        count=count)
        torch.cuda.synchronize()
        for i, (a, b, p) in enumerate(zip(got, want, ps)):
            check(a.data_ptr() == p.data_ptr(), "clip_sgd round: not in place")
            e = float((a - b).abs().max())
            check(e <= CLIP_TOL, f"clip_sgd round ext={ext} N={n} leaf {i}"
                  f" D={sizes[i]}: {e}")
            worst = max(worst, e)
        del ps, gs, commons, want, got
    keeps = [False] * len(sizes) if ext else None
    ps, gs, scale, keeps, part, commons, count = _round_inputs(
        gen, n_timed, gamma, ext, None, keeps)

    def kernel():
        CS.clip_sgd_leaves_kernel(ps, gs, scale, keeps, gamma=gamma,
                                  commons=commons, count=count)

    def plain():
        CS.clip_sgd_leaves_plain(ps, gs, scale, keeps, gamma=gamma,
                                 commons=commons, count=count)

    total = float(sum(sizes))
    nbytes = (4.0 * n_timed * total + 4.0 * total if ext
              else 12.0 * n_timed * total)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        kernel()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3  # the wrapper, no sync
    torch.cuda.synchronize()
    out = dict(ms=time_ms(kernel), device_ms=graph_ms(kernel),
               host_ms=host_ms,
               plain_ms=time_ms(plain), bound_ms=nbytes / PEAK_BYTES * 1e3,
               bytes=nbytes, launches_a_round=-(-len(sizes) // CS.CAPACITY))
    if ext:
        # the bound of the parent's kernel, which read p and g on every row
        out["full_read_bound_ms"] = (12.0 * n_timed * total + 4.0 * total) \
            / PEAK_BYTES * 1e3
    return worst, out


def _clip_checks(detail):
    import torch
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.timing import graph_ms

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

    # the 32 VGG-16 leaves at N=8, each alone through the one-leaf entry
    n = 8
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    rows = []
    for i, size in enumerate(vgg16_leaf_sizes()):
        p = torch.randn((n, size), device="cuda", generator=gen)
        g = torch.randn((n, size), device="cuda", generator=gen)
        keep = torch.full((n,), float(i % 4 != 0), device="cuda")
        e = compare(p, g, scale, keep, None)
        check(e <= CLIP_TOL, f"clip_sgd VGG-16 leaf {i} D={size}: {e}")
        worst = max(worst, e)

        def one(p=p, g=g, keep=keep):
            CS.clip_sgd_kernel(p, g, scale, keep, None, gamma=gamma)

        rows.append(dict(leaf=i, d=size, max_abs_err=e, ms=time_ms(one),
                         device_ms=graph_ms(one),
                         bound_ms=12.0 * n * size / PEAK_BYTES * 1e3))
        del p, g
    detail["clip_sgd_vgg16_n8"] = rows
    err, tot = _round_checks(gen, n, gamma, ext=False)
    tot["max_abs_err"] = max(worst, err)
    detail["clip_sgd_round_n8"] = tot
    return tot


def _clip_ext_checks(detail):
    """Kernel 3 at the 32 VGG-16 leaves, N_local=16, each leaf alone: each
    (u, keep) combination against the plain version, the mean ``c`` built
    with fractional participation weights folded in, and the leaf's time
    on the aggregation round (keep off, u on); then the round call."""
    import torch
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(11)
    gamma, n = 0.05, MESH_SLOTS
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    w = torch.rand(n, device="cuda", generator=gen)
    w[::3] = 0.0                                   # dropped clients
    worst = 0.0
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
        keep = torch.zeros(n, device="cuda")
        u = torch.ones(1, device="cuda")

        def one(p=p, g=g, common=common, keep=keep, u=u):
            CS.clip_sgd_ext_kernel(p, g, scale, keep, common, u, gamma=gamma)

        rows.append(dict(leaf=i, d=size, max_abs_err=leaf_err, ms=time_ms(one),
                         device_ms=graph_ms(one),
                         bound_ms=(4.0 * n * size + 4.0 * size)
                         / PEAK_BYTES * 1e3))
        del p, g, spec, common
    detail["clip_sgd_ext_vgg16_n16"] = rows
    err, tot = _round_checks(gen, n, gamma, ext=True)
    tot["max_abs_err"] = max(worst, err)
    detail["clip_sgd_ext_round_n16"] = tot
    return tot


def _dtype(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _compare(got, want, tol, what):
    """Max |got - want|; fails the check unless every element is within
    ``tol * (1 + |want|)`` (the reference's rtol = atol = tol bar)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bad = float((diff - tol * (1 + want.float().abs())).max()) \
        if diff.numel() else -1.0
    check(bad <= 0, f"{what}: max|kernel-plain| {err} over the bar {tol}")
    return err


def _bound(flops, nbytes, peak_flops):
    return max(flops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def _flash_pairs(sq, sk, causal, window, sk_valid):
    """Query-key pairs the masks leave, per (batch, head)."""
    total = 0
    for i in range(sq):
        hi = min(sk_valid, i + 1) if causal else sk_valid
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


# calls per forward of each family shape record of `_flash_checks` (one
# per attention block of that kind in the full-depth model)
FAMILY_FLASH_CALLS = {"phi3_prefill": 32, "phi3_decode": 32,
                      "phi3_prefill_fp32": 32, "phi3_decode_fp32": 32,
                      "whisper_encoder": 24, "whisper_cross": 24,
                      "whisper_decode_cross": 24, "internvl2_prefill": 24,
                      "internvl2_decode": 24, "glm4_prefill": 40,
                      "glm4_decode": 40}


def _family_flash_cases(b, s, n):
    """Kernel 4's cases at the shapes of the families the port serves
    besides qwen3, at ``FULL_WIDTH_TRAFFIC`` (``b`` prompts of ``s``, a
    cache of ``n``): phi3's hd 96 (bf16, and fp32 at serve_cross's
    sizes), whisper's encoder (1500 x 1500, non-causal), its
    cross-attention (prompt x 1500) and a decode step's cross-attention
    (kv_end 1500), internvl2's GQA group 7 and glm4's group 16."""
    from repro_torch.config import get_config

    sc = SERVE_CROSS
    phi3, whisper, ivl, glm4 = (get_config(a) for a in (
        "phi3-mini-3.8b", "whisper-medium", "internvl2-1b", "glm4-9b"))

    def heads(c):
        return c.n_heads, c.n_kv_heads, c.resolved_head_dim

    enc = whisper.encoder_seq
    return [
        (b, s, s, *heads(phi3), True, 0, "bfloat16", None, "phi3_prefill"),
        (b, 1, n, *heads(phi3), False, 0, "bfloat16", s + 1, "phi3_decode"),
        (sc["batch"], sc["prompt"], sc["prompt"], *heads(phi3), True, 0,
         "float32", None, "phi3_prefill_fp32"),
        (sc["batch"], 1, sc["prompt"] + sc["gen"], *heads(phi3), False, 0,
         "float32", sc["prompt"] + 1, "phi3_decode_fp32"),
        (b, enc, enc, *heads(whisper), False, 0, "bfloat16", None,
         "whisper_encoder"),
        (b, s, enc, *heads(whisper), False, 0, "bfloat16", None,
         "whisper_cross"),
        (b, 1, enc, *heads(whisper), False, 0, "bfloat16", None,
         "whisper_decode_cross"),
        (b, s, s, *heads(ivl), True, 0, "bfloat16", None,
         "internvl2_prefill"),
        (b, 1, n, *heads(ivl), False, 0, "bfloat16", s + 1,
         "internvl2_decode"),
        (b, s, s, *heads(glm4), True, 0, "bfloat16", None, "glm4_prefill"),
        (b, 1, n, *heads(glm4), False, 0, "bfloat16", s + 1, "glm4_decode"),
    ]


def _traffic():
    from repro_torch.launch.serve import FULL_WIDTH_TRAFFIC

    return FULL_WIDTH_TRAFFIC


def _blocks(cfg):
    """Block kinds of one decoder forward of ``cfg``, in order."""
    from repro_torch.models.transformer import layer_program

    program, repeats = layer_program(cfg)
    return [kind for layer in program * repeats for kind in layer]


def _enc_blocks(cfg):
    """Block kinds of the encoder (enc-dec models; it runs in prefill
    only), in order."""
    from repro_torch.models.transformer import encoder_program

    if not cfg.is_enc_dec:
        return []
    program, repeats = encoder_program(cfg)
    return [kind for layer in program * repeats for kind in layer]


ATTN_KINDS = ("attn", "attn_nc", "xattn")


def _norm_shapes(cfg, b, s, kinds):
    """Input shapes of the RMSNorms of the blocks ``kinds`` over ``b`` x
    ``s`` tokens, in order: per self-attention block (``attn``,
    ``attn_nc``) the pre-norm and, with qk-norm, the per-head q and k
    norms; per cross-attention, FFN (``ffn``, ``ffn_gelu``), MoE and mamba
    block its pre-norm (mamba's ``norm_in``); per mLSTM block its input
    norm and the norm of h over its 2·d inner width; per sLSTM block its
    input norm and the norm of h over d."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qk = [(b, s, cfg.n_heads, hd), (b, s, cfg.n_kv_heads, hd)] \
        if cfg.qk_norm else []
    per_block = {"attn": [(b, s, d)] + qk, "attn_nc": [(b, s, d)] + qk,
                 "xattn": [(b, s, d)], "ffn": [(b, s, d)],
                 "ffn_gelu": [(b, s, d)], "moe": [(b, s, d)],
                 "mamba": [(b, s, d)],
                 "mlstm": [(b, s, d), (b, s, 2 * d)],
                 "slstm": [(b, s, d), (b, s, d)]}
    return [sh for kind in kinds for sh in per_block[kind]]


def _norm_calls(cfg, b, s):
    """Input shapes of the RMSNorms one decoder forward of ``cfg`` over
    ``b`` x ``s`` tokens runs, in order (`_norm_shapes` of its blocks),
    then the final norm on the last position."""
    return _norm_shapes(cfg, b, s, _blocks(cfg)) + [(b, 1, cfg.d_model)]


def _enc_norm_calls(cfg, b):
    """The encoder's RMSNorms over ``b`` x ``encoder_seq`` frames (prefill
    only): its blocks', then ``enc_final_norm``."""
    if not cfg.is_enc_dec:
        return []
    se, d = cfg.encoder_seq, cfg.d_model
    return _norm_shapes(cfg, b, se, _enc_blocks(cfg)) + [(b, se, d)]


def _span(fn, calls: int):
    """``fn`` called ``calls`` times back to back, timed as one unit."""
    def run():
        for _ in range(calls):
            fn()
    return run


def _flash_path(q, sq):
    """The kernel `flash_attention_kernel` must take for these inputs."""
    import torch

    if sq == 1:
        return "split_kv"
    return "tc" if q.dtype == torch.bfloat16 else "fp32"


def _flash_checks(detail):
    """Kernel 4 against its plain version: the reference's cases, the
    decode form, the new paths' edges (bf16 prefill at hd 64 and 32 and
    with folded rows off the 128-row tile, window with sk_valid, decode at
    sk_valid = 1 against 544 slots, so most splits are empty), and
    qwen3-1.7b's prefill and decode shapes, each of these timed as one
    forward's calls (one per attention block); then the other families'
    shapes (`_family_flash_cases`), each timed the same way.  Every call must take its
    path (tensor-core, split-KV or fp32); the split-KV decode at qwen3's
    shape must be bitwise repeatable."""
    import torch
    import torch.nn.functional as F
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as FA

    cfg = get_config("qwen3-1.7b")
    tf = _traffic()
    b, s, n = tf["batch"], tf["prompt"], tf["prompt"] + tf["gen"]
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    shapes = FLASH_CASES + [
        # bf16 prefill at hd 64 and 32; folded rows 231 and 300, off the
        # 128-row tile; a window with sk_valid
        (1, 128, 128, 4, 2, 64, True, 0, "bfloat16", None, None),
        (1, 128, 128, 4, 2, 32, True, 0, "bfloat16", None, None),
        (1, 77, 77, 3, 1, 128, True, 0, "bfloat16", None, None),
        (2, 100, 100, 6, 2, 64, True, 0, "bfloat16", None, None),
        (2, 150, 300, 4, 2, 128, True, 40, "bfloat16", 120, None),
        # qwen3 prefill, one attention layer
        (b, s, s, *heads, True, 0, cfg.dtype, None, "prefill"),
        # qwen3's first decode step against the cache
        (b, 1, n, *heads, False, 0, cfg.dtype, s + 1, "decode"),
        # one valid key of 544: every split but the first is empty
        (b, 1, n, *heads, False, 0, cfg.dtype, 1, None),
        # the decode form at fp32 (serve_cross), slots past pos unused
        (SERVE_CROSS["batch"], 1, SERVE_CROSS["prompt"] + SERVE_CROSS["gen"],
         *heads, False, 0, "float32", SERVE_CROSS["prompt"] + 1, None),
    ] + _family_flash_cases(b, s, n)
    rows = {}
    for case in shapes:
        b, sq, sk, hq, hkv, hd, causal, window, dt = case[:9]
        sk_valid, role = (case[9], case[10]) if len(case) > 9 else (None,
                                                                   None)
        q = torch.randn((b, sq, hq, hd), device="cuda", generator=gen).to(
            _dtype(dt))
        k, v = (torch.randn((b, sk, hkv, hd), device="cuda",
                            generator=gen).to(_dtype(dt)) for _ in range(2))
        kw = dict(causal=causal, window=window, sk_valid=sk_valid)
        before = FA.path_launches()
        got = FA.flash_attention_kernel(q, k, v, **kw)
        after = FA.path_launches()
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        path = _flash_path(q, sq)
        check(after[path] == before[path] + 1,
              f"flash {case}: not launched on the {path} path")
        err = _compare(got, want, FLASH_TOL[dt], f"flash {case}")
        worst = max(worst, err)
        if role == "decode":
            check(torch.equal(got, FA.flash_attention_kernel(q, k, v, **kw)),
                  "flash decode: split-KV not bitwise repeatable")
        if role is None:
            continue
        calls = FAMILY_FLASH_CALLS.get(role, _blocks(cfg).count("attn"))
        nv = sk if sk_valid is None else sk_valid
        itemsize = q.element_size()
        peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_FP32_FLOPS
        flops = 4.0 * b * hq * hd * _flash_pairs(sq, sk, causal, window, nv)
        nbytes = itemsize * (2.0 * b * sq * hq * hd + 2.0 * b * nv * hkv * hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :nv], v[:, :nv]))
        rows[role] = dict(
            shape=list(case[:9]), sk_valid=nv, calls=calls, path=path,
            max_abs_err=err,
            ms=time_ms(_span(lambda: FA.flash_attention_kernel(
                q, k, v, **kw), calls)),
            plain_ms=time_ms(_span(lambda: FA.flash_attention_plain(
                q, k, v, **kw), calls)),
            library_ms=time_ms(_span(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), calls)),
            bound_ms=calls * _bound(flops, nbytes, peak),
            bound_by="operations" if flops / peak >= nbytes / PEAK_BYTES
            else "bytes", flops=calls * flops, bytes=calls * nbytes)
        del q, k, v, got, want
    detail["flash_attention"] = rows
    return rows, worst


def _rmsnorm_checks(detail):
    """Kernel 5 against its plain version: the reference's cases and
    every norm shape of the serve phases (bf16) and of serve_cross (fp32);
    then one qwen3-1.7b forward's norms, in order, timed as one unit, for
    prefill and for a decode step: ``ms`` the span of eager calls (host
    launch path included), ``device_ms`` the same calls captured once in a
    CUDA graph and replayed, for the kernel and for ``F.rms_norm``.  At
    serve_cross's fp32 shapes the kernel and the plain version (both on the
    card) are also held against the norm taken in fp64, to show which fp32
    sum is nearer (recorded, no bar)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.config import get_config
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(22)
    qwen, xlstm = get_config("qwen3-1.7b"), get_config("xlstm-350m")
    tf, c = _traffic(), SERVE_CROSS
    b, s = tf["batch"], tf["prompt"]
    served = {sh: "bfloat16" for cfg in (qwen, xlstm) for n in (s, 1)
              for sh in _norm_calls(cfg, b, n)}
    crossed = {sh: "float32" for cfg in (qwen, xlstm)
               for n in (c["prompt"], 1)
               for sh in _norm_calls(cfg, c["batch"], n)}
    inputs, worst = {}, 0.0
    vs_fp64 = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}  # max, mean
    for shape, dt in RMSNORM_CASES + list(served.items()) \
            + list(crossed.items()):
        x = torch.randn(shape, device="cuda", generator=gen).to(_dtype(dt))
        sc = torch.rand(shape[-1], device="cuda", generator=gen)
        got = RN.rmsnorm_kernel(x, sc, qwen.norm_eps)
        want = RN.rmsnorm_plain(x, sc, qwen.norm_eps)
        err = _compare(got, want, RMSNORM_TOL, f"rmsnorm {shape} {dt}")
        worst = max(worst, err)
        if (shape, dt) in served.items():
            inputs[shape] = (x, sc, sc.to(x.dtype))
        if (shape, dt) in crossed.items():
            xd = x.double()   # rmsnorm_plain computes in fp32 whatever x is
            exact = xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True)
                                     + qwen.norm_eps) * sc.double()
            for name, y in (("kernel", got), ("plain", want)):
                diff = (y.double() - exact).abs()
                vs_fp64[name][0] = max(vs_fp64[name][0], float(diff.max()))
                vs_fp64[name][1] = max(vs_fp64[name][1], float(diff.mean()))
    detail["rmsnorm_fp32_vs_fp64"] = {
        k: {"max_abs_err": v[0], "worst_mean_abs_err": v[1]}
        for k, v in vs_fp64.items()}
    totals = {}
    for role, n in (("prefill", s), ("decode", 1)):
        seq = [inputs[sh] for sh in _norm_calls(qwen, b, n)]

        def run(fn, seq=seq):
            return lambda: [fn(x, sc, sl) for x, sc, sl in seq]

        bound = flops = nbytes = 0.0
        for x, _, _ in seq:
            d, rows_ = x.shape[-1], x.numel() // x.shape[-1]
            by = 2.0 * rows_ * d * x.element_size() + 4.0 * d
            fl = 4.0 * rows_ * d
            bound += _bound(fl, by, PEAK_FP32_FLOPS)
            flops += fl
            nbytes += by
        eps = qwen.norm_eps
        kernel = run(lambda x, sc, sl: RN.rmsnorm_kernel(x, sc, eps))
        library = run(lambda x, sc, sl: F.rms_norm(x, (x.shape[-1],), sl,
                                                   eps))
        ms = time_ms(kernel)
        totals[role] = dict(
            calls=len(seq), ms=ms, device_ms=graph_ms(kernel),
            span_us_per_call=ms * 1e3 / len(seq),
            plain_ms=time_ms(run(
                lambda x, sc, sl: RN.rmsnorm_plain(x, sc, eps))),
            library_ms=time_ms(library), library_device_ms=graph_ms(library),
            bound_ms=bound, flops=flops, bytes=nbytes,
            by_shape=[dict(
                shape=list(x.shape),
                plan=RN.rmsnorm_plan(x.numel() // x.shape[-1], x.shape[-1],
                                     x.element_size()),
                calls=sum(1 for y, _, _ in seq if y is x),
                device_ms=graph_ms(_span(lambda x=x, sc=sc: RN.rmsnorm_kernel(
                    x, sc, eps), 10)) / 10,
                bound_ms=_bound(4.0 * x.numel(), 2.0 * x.numel()
                                * x.element_size() + 4.0 * x.shape[-1],
                                PEAK_FP32_FLOPS))
                for x, sc, _ in {id(t[0]): t for t in seq}.values()])
    detail["rmsnorm"] = totals
    return totals, worst


def _mlstm_gates(gen, shape, kind):
    """(i_gate, f_gate) fp32 pre-activations: N(0, 1), or "extreme"."""
    import torch

    ig = torch.randn(shape, device="cuda", generator=gen)
    fg = torch.randn(shape, device="cuda", generator=gen)
    if kind == "extreme":
        sign = torch.rand(shape, device="cuda", generator=gen) < 0.5
        fg = torch.where(sign, 30.0, -30.0)
        off = torch.rand(shape, device="cuda", generator=gen) < 0.3
        ig = torch.where(off, -1e30, ig * 5)
        ig[:, :3] = -1e30
    return ig, fg


def _mlstm_checks(detail):
    """Kernel 6 against its plain version (the recurrence): the reference's
    cases, the paths' edges (`MLSTM_PATH_CASES`), xlstm-350m's prefill shape
    (4 heads of 512, bf16) and serve_cross's (fp32); every call must take
    its path (bf16 the tensor-core parallel form, fp32 the recurrence), and
    the tensor-core path must repeat bitwise.  The two serve shapes are
    timed as one prefill's calls (one per mLSTM block)."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.timing import graph_ms

    cfg = get_config("xlstm-350m")
    tf = _traffic()
    h, hd = cfg.n_heads, 2 * cfg.d_model // cfg.n_heads
    calls = _blocks(cfg).count("mlstm")
    served = (tf["batch"], tf["prompt"], h, hd, cfg.dtype, "normal")
    crossed = (SERVE_CROSS["batch"], SERVE_CROSS["prompt"], h, hd, "float32",
               "normal")
    gen = torch.Generator(device="cuda").manual_seed(23)
    worst = 0.0
    rows = {}
    for b, s, h, hd, dt, gates in [c + ("normal",) for c in MLSTM_CASES] \
            + MLSTM_PATH_CASES + [served, crossed]:
        case = (b, s, h, hd, dt, gates)
        q, k, v = (torch.randn((b, s, h, hd), device="cuda",
                               generator=gen).to(_dtype(dt))
                   for _ in range(3))
        ig, fg = _mlstm_gates(gen, (b, s, h), gates)
        path = "tc" if dt == "bfloat16" else "recurrent"
        before = MS.path_launches()
        got = MS.mlstm_scan_kernel(q, k, v, ig, fg)
        after = MS.path_launches()
        torch.cuda.synchronize()
        check(after[path] == before[path] + 1 and all(
            after[p] == before[p] for p in MS.PATHS if p != path),
            f"mlstm {case}: not launched on the {path} path")
        check(bool(torch.isfinite(got.float()).all()),
              f"mlstm {case}: non-finite output")
        err = _compare(got, MS.mlstm_scan_plain(q, k, v, ig, fg),
                       MLSTM_TOL[dt], f"mlstm {case}")
        worst = max(worst, err)
        if path == "tc":
            check(torch.equal(got, MS.mlstm_scan_kernel(q, k, v, ig, fg)),
                  f"mlstm {case}: tensor-core path not bitwise repeatable")
        if case not in (served, crossed):
            continue
        # operations: the parallel form's 4·hd per causal pair (S = QKᵀ
        # and PV), the recurrence's 5·hd² + 5·hd per step (C's update a
        # multiply and an FMA per element, i·v once per row, C·q an FMA;
        # n and n·q the same per column); bytes: q, k, v, h once, gates
        pairs = s * (s + 1) / 2
        par_flops = calls * 4.0 * hd * pairs * b * h
        rec_flops = calls * (5.0 * hd * hd + 5.0 * hd) * b * s * h
        nbytes = calls * (4.0 * b * s * h * hd * q.element_size()
                          + 8.0 * b * s * h)
        if path == "tc":
            flops, peak = par_flops, PEAK_BF16_FLOPS
        else:   # fp32 on the CUDA cores: the cheaper form's operations
            flops, peak = min(par_flops, rec_flops), PEAK_FP32_FLOPS
        span = _span(lambda: MS.mlstm_scan_kernel(q, k, v, ig, fg), calls)
        rows[path] = dict(
            shape=list(case[:5]), calls=calls, path=path, max_abs_err=err,
            ms=time_ms(span), device_ms=graph_ms(span),
            plain_ms=time_ms(_span(lambda: MS.mlstm_scan_plain(
                q, k, v, ig, fg), calls), reps=1 if path == "tc" else 2),
            library_ms=None, bound_ms=_bound(flops, nbytes, peak),
            bound_by="operations" if flops / peak >= nbytes / PEAK_BYTES
            else "bytes",
            recurrence_bound_ms=_bound(rec_flops, nbytes, PEAK_FP32_FLOPS),
            flops=flops, recurrence_flops=rec_flops, bytes=nbytes)
        del q, k, v, got
    detail["mlstm_scan"] = rows
    return rows, worst


def _grid_kernel_checks(detail):
    """Kernels 1 and 2 as the grid runner calls them, G=4 cells of N=8
    folded into one call: the GEMM at the split-K dW shapes planned per
    cell (``plan_n=8``), bitwise equal to the four one-cell calls and
    within the GEMM's bar of the plain version, with the unplanned call's
    difference recorded as the witness; the clip+SGD update over the 32
    VGG-16 leaves of four cells with their own keeps and participation,
    in ⌈4·32/64⌉ = 2 launches, bitwise equal to four one-cell launches and
    within `CLIP_TOL` of the plain cells; then timed with the full cohort
    (every row read and written: 12·G·N·ΣD bytes) against four one-cell
    launches and the plain cells."""
    import torch
    from repro_torch.kernels import batched_conv as BC
    from repro_torch.kernels import clip_sgd as CS

    cells, n = 4, 8
    gen = torch.Generator(device="cuda").manual_seed(17)
    gemm = []
    for name, kind, m, k, c in vgg16_gemm_shapes(n):
        if name not in ("conv1.dW", "conv2.dW"):
            continue
        a = torch.randn((cells * n, k, m), device="cuda",
                        generator=gen).transpose(1, 2)
        b = torch.randn((cells * n, k, c), device="cuda", generator=gen)
        folded = BC.batched_matmul_kernel(a, b, plan_n=n)
        alone = torch.cat([BC.batched_matmul_kernel(a[i * n:(i + 1) * n],
                                                    b[i * n:(i + 1) * n])
                           for i in range(cells)])
        unplanned = BC.batched_matmul_kernel(a, b)
        ref = BC.batched_matmul_plain(a, b)
        torch.cuda.synchronize()
        check(torch.equal(folded, alone), f"grid GEMM {name}: the folded "
              "call planned per cell is not bitwise the one-cell calls")
        err = float((folded - ref).abs().max())
        tol = GEMM_RTOL * float(ref.abs().max()) * max(1.0, (k / 1024) **
                                                         0.5)
        check(err <= tol, f"grid GEMM {name}: {err} > {tol}")
        splits = BC.gemm_splits(cells * n, m, k, c, plan_n=n)[0]
        gemm.append(dict(
            name=name, shape=[cells * n, m, k, c], max_abs_err=err,
            splits=splits,
            unplanned_splits=BC.gemm_splits(cells * n, m, k, c)[0],
            unplanned_bitwise=bool(torch.equal(unplanned, alone)),
            unplanned_max_abs_diff=float((unplanned - alone).abs().max()),
            workspace_bytes=4 * splits * cells * n * m * c,
            ms=time_ms(lambda: BC.batched_matmul_kernel(a, b, plan_n=n)),
            plain_ms=time_ms(lambda: BC.batched_matmul_plain(a, b)),
            library_ms=time_ms(lambda: torch.bmm(a, b))))
        del a, b, folded, alone, unplanned, ref

    sizes = vgg16_leaf_sizes()
    gamma = 0.05
    ps = [torch.randn((cells * n, d), device="cuda", generator=gen)
          for d in sizes]
    gs = [torch.randn((cells * n, d), device="cuda", generator=gen)
          for d in sizes]
    scale = torch.rand(cells * n, device="cuda", generator=gen) * 0.9 + 0.1
    w = torch.rand(cells * n, device="cuda", generator=gen) * 0.9 + 0.1
    w[::3] = 0.0
    keeps = [[(i + c) % 3 != 0 for i in range(len(sizes))]
             for c in range(cells)]
    want = CS.clip_sgd_leaves_plain(ps, gs, scale, keeps, w, gamma=gamma,
                                    cells=cells)
    folded = [p.clone() for p in ps]
    before = CS.clip_sgd_kernel.launches
    CS.clip_sgd_leaves_kernel(folded, gs, scale, keeps, w, gamma=gamma,
                              cells=cells)
    torch.cuda.synchronize()
    launches = CS.clip_sgd_kernel.launches - before
    check(launches == -(-cells * len(sizes) // CS.CAPACITY),
          f"grid clip_sgd: {launches} launches for {cells} cells")
    err = max(float((a - b).abs().max()) for a, b in zip(folded, want))
    check(err <= CLIP_TOL, f"grid clip_sgd: {err} from the plain cells")
    for c in range(cells):
        rows = slice(c * n, (c + 1) * n)
        alone = [p[rows].clone() for p in ps]
        CS.clip_sgd_leaves_kernel(alone, [g[rows] for g in gs],
                                  scale[rows], keeps[c], w[rows],
                                  gamma=gamma)
        torch.cuda.synchronize()
        check(all(torch.equal(f[rows], a) for f, a in zip(folded, alone)),
              f"grid clip_sgd: cell {c} is not bitwise its own launch")

    def kernel():
        CS.clip_sgd_leaves_kernel(ps, gs, scale, keeps, gamma=gamma,
                                  cells=cells)

    def per_cell():
        for c in range(cells):
            rows = slice(c * n, (c + 1) * n)
            CS.clip_sgd_leaves_kernel(
                [p[rows] for p in ps], [g[rows] for g in gs], scale[rows],
                keeps[c], gamma=gamma)

    clip = dict(cells=cells, n=n, launches=launches, max_abs_err=err,
                ms=time_ms(kernel), per_cell_ms=time_ms(per_cell),
                plain_ms=time_ms(lambda: CS.clip_sgd_leaves_plain(
                    ps, gs, scale, keeps, gamma=gamma, cells=cells)),
                bound_ms=12.0 * cells * n * sum(sizes) / PEAK_BYTES * 1e3)
    detail["grid_kernels"] = dict(gemm=gemm, clip_sgd=clip)
    return dict(gemm=gemm, clip_sgd=clip)


def phase_kernels(detail):
    from repro_torch.device import disable_tf32

    disable_tf32()
    gemm = _gemm_checks(detail)
    conv_err = _conv_checks()
    clip = _clip_checks(detail)
    ext = _clip_ext_checks(detail)
    flash, flash_err = _flash_checks(detail)
    norms, norm_err = _rmsnorm_checks(detail)
    mlstm, mlstm_err = _mlstm_checks(detail)
    grid = _grid_kernel_checks(detail)
    emit({"phase": "kernels",
          "batched_matmul": {k: gemm[k] for k in (
              "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
          "batched_conv_max_err": conv_err,
          "clip_sgd": {k: clip[k] for k in (
              "ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
              "max_abs_err")},
          "clip_sgd_ext": {k: ext[k] for k in (
              "ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
              "full_read_bound_ms", "max_abs_err")},
          "flash_attention": {role: {k: r[k] for k in (
              "calls", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err")} for role, r in flash.items()},
          "rmsnorm": {role: {k: r[k] for k in (
              "calls", "ms", "device_ms", "span_us_per_call", "plain_ms",
              "library_ms", "library_device_ms", "bound_ms")}
              for role, r in norms.items()},
          "rmsnorm_fp32_vs_fp64": detail["rmsnorm_fp32_vs_fp64"],
          "mlstm_scan": {path: {k: r[k] for k in (
              "shape", "calls", "ms", "device_ms", "plain_ms", "bound_ms",
              "bound_by", "recurrence_bound_ms", "max_abs_err")}
              for path, r in mlstm.items()},
          "max_abs_err": {"flash_attention": flash_err, "rmsnorm": norm_err,
                          "mlstm_scan": mlstm_err},
          "grid": {"gemm": [{k: r[k] for k in (
              "name", "shape", "splits", "unplanned_splits",
              "unplanned_bitwise", "ms", "library_ms")}
              for r in grid["gemm"]], "clip_sgd": grid["clip_sgd"]},
          "note": "GEMM: one VGG-16 round's shapes summed at N=8 (b=64); "
                  "clip_sgd (N=8) and clip_sgd_ext (N=16): one round's 32 "
                  "leaves in one call; "
                  "flash, rmsnorm and mlstm_scan: one forward's calls "
                  "(calls) timed as one unit, at the serve shapes; "
                  "device_ms: the same calls replayed from a CUDA graph"})
    return (gemm, clip, ext, dict(flash, max_abs_err=flash_err),
            dict(norms, max_abs_err=norm_err),
            dict(mlstm, max_abs_err=mlstm_err))


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
    check(launches["batched_matmul"] > 0, "train: the GEMM never launched")
    check(launches["clip_sgd"] == spec.rounds,
          f"train: {launches['clip_sgd']} update launches, not one a round "
          f"({spec.rounds})")
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
    check(launches["clip_sgd_ext"] == spec.rounds,
          f"mesh: {launches['clip_sgd_ext']} external-mean launches, not "
          f"one a round ({spec.rounds})")
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


def _recording(sess):
    """Record every gather plan ``sess`` draws (a list, filled as it runs)."""
    plans = []
    draw = sess.sim.store.segment_indices

    def recording(*a):
        plans.append(draw(*a))
        return plans[-1]

    sess.sim.store.segment_indices = recording
    return plans


def _grid_witness(specs, fold_library: bool = False):
    """One round body of fresh sessions of ``specs`` (same cut, b=8 for
    every client), folded against per-cell, op by op on the card: the
    gathered batch, each layer's output, the losses, each gradient leaf,
    the clip factors and each updated leaf.  With ``fold_library`` the
    folded body runs the library ops that the grid runs cell by cell
    (`utils.cells.by_cell`: clip norms, bias gradients, FC GEMMs, loss
    means) over all G·N rows at once, to show whether the card needs the
    per-cell calls.  Returns a row per stage, bitwise or not, with its
    largest difference."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.api import Session
    from repro_torch.core import split as SP
    from repro_torch.data.pipeline import DeviceClientStore
    from repro_torch.models.cnn import cnn_stacked_forward
    from repro_torch.utils import cells as CELLS
    from repro_torch.utils.cells import fold
    from repro_torch.utils.tree import tree_leaves

    sims = [Session(s).sim for s in specs]
    sim0, cells, n = sims[0], len(sims), sims[0].n
    b, b_pad = np.full(n, 8), 8
    idx = [sim.store.segment_indices(1, b, b_pad) for sim in sims]
    rmask = [sim.store.row_mask(b, b_pad) for sim in sims]
    arrays = DeviceClientStore.stack_arrays([sim.store for sim in sims])
    n_train = len(next(iter(sim0.store.arrays.values())))
    plan, mask = DeviceClientStore.fold_plan(idx, rmask, n_train)
    dev = sim0.device
    batch = DeviceClientStore.device_batch(
        arrays, torch.as_tensor(plan[0], device=dev),
        torch.as_tensor(mask, device=dev))
    alone = [DeviceClientStore.device_batch(
        sim.store.arrays, torch.as_tensor(i[0], device=dev, dtype=torch.long),
        torch.as_tensor(m, device=dev)) for sim, i, m in zip(sims, idx, rmask)]
    carry = fold([sim._stacked for sim in sims])
    rows = []

    def stage(name, folded, per_cell):
        want = torch.cat(per_cell)
        rows.append(dict(stage=name, bitwise=bool(torch.equal(folded, want)),
                         max_abs_diff=float((folded - want).abs().max())))

    def folded(fn, *a):
        if not fold_library:
            return fn(*a)
        with mock.patch.object(CELLS, "apart", lambda t, cell_size: False):
            return fn(*a)

    stage("batch.images", batch["images"], [a["images"] for a in alone])
    with torch.no_grad():
        for layer in range(1, len(carry) + 1):
            stage(f"layer{layer}", folded(
                cnn_stacked_forward, carry[:layer], batch["images"],
                sim0.cfg, n),
                [cnn_stacked_forward(sim._stacked[:layer], a["images"],
                                     sim0.cfg) for sim, a in zip(sims, alone)])
    got = folded(sim0._client_grads, carry, batch, cells)
    want = [sim._client_grads(sim._stacked, a) for sim, a in zip(sims, alone)]
    stage("losses", got[0], [w[0] for w in want])
    for j, leaf in enumerate(tree_leaves(got[1])):
        stage(f"grad{j}", leaf, [tree_leaves(w[1])[j] for w in want])
    stage("clip_scale", got[2], [w[2] for w in want])
    mask_u = SP.client_unit_mask(sim0.cfg, len(carry), 2)
    new = SP.hasfl_round_update(carry, got[1], np.stack([mask_u] * cells),
                                False, sim0.sfl.lr, grad_scale=got[2],
                                impl="kernel", cells=cells)
    per = [SP.hasfl_round_update(sim._stacked, w[1], mask_u, False,
                                 sim0.sfl.lr, grad_scale=w[2], impl="kernel")
           for sim, w in zip(sims, want)]
    for j, leaf in enumerate(tree_leaves(new)):
        stage(f"update{j}", leaf, [tree_leaves(p)[j] for p in per])
    return rows


def phase_grid_cross(detail):
    """`run_grid` on the card against each cell's own `run()`, at
    ``cross_device``'s sizes: grid (a), three policies crossing pow2
    buckets with the estimating controller, and grid (b), seeds x
    partitions (cells reading their own data).  Decisions, clocks, gather
    plans, losses, accuracies and parameters bitwise; the op-by-op
    witness of one folded round body goes to ``--detail``."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentSpec, Session, grid, run_grid
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops
    from repro_torch.utils.tree import tree_leaves

    base = dict(arch="vgg9-cifar-small", n_clients=4, partition="iid",
                n_train=400, n_test=100, rounds=4, eval_every=2,
                estimate=False, sfl=SFLConfig(lr=0.05, agg_interval=2))
    grids = {
        "a": [dict(policy="fixed(b=8,cut=3)"), dict(policy="rbs+rms"),
              dict(policy="hasfl", estimate=True)],
        "b": [dict(policy="hasfl", seed=s, partition=p)
              for s in (0, 1) for p in ("iid", "noniid-shards")],
    }
    same = lambda xs, ys: len(xs) == len(ys) and all(
        np.array_equal(x, y) for x, y in zip(xs, ys))
    out = {"phase": "grid_cross", "arch": base["arch"]}
    bad = []
    for name, cells in grids.items():
        specs = [ExperimentSpec(**dict(base, **c)) for c in cells]
        alone = [Session(s) for s in specs]
        plans_alone = [_recording(s) for s in alone]
        seq = [s.run() for s in alone]
        folded = [Session(s) for s in specs]
        plans_folded = [_recording(s) for s in folded]
        ops.reset_launch_counts()
        res = run_grid(folded)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        rows = []
        for i, (r, q, sr, sq, pr, pq) in enumerate(zip(
                res, seq, folded, alone, plans_folded, plans_alone)):
            wr, wq = tree_leaves(sr.sim._stacked), tree_leaves(sq.sim._stacked)
            row = dict(
                decisions=same(r.b_history, q.b_history)
                and same(r.cut_history, q.cut_history),
                clock=r.clock == q.clock, plans=same(pr, pq),
                losses=(r.train_loss, r.test_loss, r.test_acc)
                == (q.train_loss, q.test_loss, q.test_acc),
                params=all(torch.equal(a, b) for a, b in zip(wr, wq)),
                loss_max_diff=max(abs(a - b) for a, b in zip(
                    r.train_loss + r.test_loss + r.test_acc,
                    q.train_loss + q.test_loss + q.test_acc)),
                param_max_diff=max(float((a - b).abs().max())
                                   for a, b in zip(wr, wq)))
            rows.append(row)
            bad += [f"grid {name} cell {i}: {k}" for k in (
                "decisions", "clock", "plans", "losses", "params")
                if not row[k]]
        out[name] = dict(
            cells=[c["policy"] + (f" seed {c['seed']} {c['partition']}"
                                  if "seed" in c else "") for c in cells],
            dispatches=[[d.t0, d.rounds, d.b_pad, list(d.members)]
                        for d in grid.run_group.dispatches],
            launches=launches, cells_bitwise=rows,
            train_loss=[r.train_loss for r in res])
        check(launches["batched_matmul"] > 0 and launches["clip_sgd"] > 0,
              f"grid_cross {name}: the kernels never launched")
        check(len({tuple(r.train_loss) for r in res}) == len(res),
              f"grid_cross {name}: cells do not differ")
    # the grid's round body, then the same with the library ops folded:
    # the first stage at which each differs from the per-cell bodies
    for key, fold_library in (("grid_witness", False),
                              ("grid_witness_library_folded", True)):
        witness = _grid_witness([ExperimentSpec(**dict(base, **c))
                                 for c in grids["b"]], fold_library)
        detail[key] = witness
        out[key + "_first_difference"] = next(
            (w for w in witness if not w["bitwise"]), None)
    emit(out)
    detail["grid_cross"] = out
    check(not bad, "; ".join(bad))
    return out


def _timed_policies(sessions):
    """Wrap each session's policy to add its wall seconds (the BCD solve,
    the G²/σ² estimate and their syncs) to the one-element list
    returned.  The card is synchronized before the clock starts, so a
    call is not charged with the rounds still queued before it."""
    import torch

    spent = [0.0]
    for sess in sessions:
        def timed(sim, rng, policy=sess.policy):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return policy(sim, rng)
            finally:
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t0
        sess.policy = timed
    return spent


def phase_grid(detail):
    """`run_grid` on four full-width cells — VGG-16, N=8, 12 rounds,
    {hasfl, rbs+rms} x seed {0, 1} — against the same four cells run one
    after another: seconds, seconds per cell-round, peak memory, the
    dispatch record and the launch counts (counters zeroed just before
    the grid run and read just after).  Checks: one GEMM launch per conv
    GEMM of a dispatch round, not per cell (both runs make the same eval
    and estimate launches, so the grid makes 38 fewer for each cell-round
    a dispatch round folds), ⌈members·32/64⌉ update launches a round per
    dispatch, no external-mean launch, finite losses and parameters, and
    every cell bitwise equal to its own run."""
    import math
    import numpy as np
    import torch
    from repro_torch.api import ExperimentSpec, Session, grid, run_grid
    from repro_torch.config import SFLConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.clip_sgd import CAPACITY
    from repro_torch.utils.tree import tree_leaves

    specs = [ExperimentSpec(
        **GRID, policy=policy, seed=seed, conv_impl="kernel",
        update_impl="kernel", sfl=SFLConfig(lr=0.05, agg_interval=3))
        for policy in ("hasfl", "rbs+rms") for seed in (0, 1)]
    cell_rounds = len(specs) * specs[0].rounds
    runs = {}
    for runner in ("sequential", "grid"):
        sessions = [Session(s) for s in specs]
        n_leaves = len(tree_leaves(sessions[0].sim.units))
        policy_s = _timed_policies(sessions)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        grid.run_group.dispatches.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_grid(sessions, runner=runner)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs[runner] = dict(
            seconds=seconds, seconds_per_cell_round=seconds / cell_rounds,
            policy_seconds=policy_s[0],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=ops.launch_counts(),
            dispatches=list(grid.run_group.dispatches), res=res,
            params=[[t.cpu() for t in tree_leaves(s.sim._stacked)]
                    for s in sessions])
        del sessions
    g, q = runs["grid"], runs["sequential"]
    # a round's GEMMs: forward, dW and dx of every conv, no dx for the first
    per_round = 3 * len(get_config(specs[0].arch).conv_channels) - 1
    dispatch_rounds = sum(d.rounds for d in g["dispatches"])
    saved = q["launches"]["batched_matmul"] - g["launches"]["batched_matmul"]
    want_updates = sum(d.rounds * -(-len(d.members) * n_leaves // CAPACITY)
                       for d in g["dispatches"])
    res = g["res"]
    same = lambda xs, ys: len(xs) == len(ys) and all(
        np.array_equal(x, y) for x, y in zip(xs, ys))
    bitwise = [dict(
        decisions=same(r.b_history, s.b_history)
        and same(r.cut_history, s.cut_history),
        clock=r.clock == s.clock,
        losses=(r.train_loss, r.test_loss, r.test_acc)
        == (s.train_loss, s.test_loss, s.test_acc),
        params=all(torch.equal(a, b) for a, b in zip(pr, ps)))
        for r, s, pr, ps in zip(res, q["res"], g["params"], q["params"])]
    out = {"phase": "grid", "arch": specs[0].arch,
           "n_clients": specs[0].n_clients, "rounds": specs[0].rounds,
           "cells": [f"{s.policy} seed {s.seed}" for s in specs],
           "seconds": g["seconds"],
           "seconds_per_cell_round": g["seconds_per_cell_round"],
           "policy_seconds": g["policy_seconds"],
           "max_memory_allocated": g["max_memory_allocated"],
           "dispatches": [[d.t0, d.rounds, d.b_pad, list(d.members)]
                          for d in g["dispatches"]],
           "launches": g["launches"],
           "gemm_launches_a_dispatch_round": per_round,
           "dispatch_rounds": dispatch_rounds, "cell_rounds": cell_rounds,
           "gemm_launches_saved": saved,
           "expected_update_launches": want_updates,
           "sequential": {k: q[k] for k in (
               "seconds", "seconds_per_cell_round", "policy_seconds",
               "max_memory_allocated", "launches")},
           "train_loss": [r.train_loss for r in res],
           "test_acc": [r.test_acc for r in res],
           "b_history": [[list(map(int, b)) for b in r.b_history]
                         for r in res],
           "bitwise_vs_sequential": bitwise}
    emit(out)
    detail["grid"] = out
    check(saved == per_round * (cell_rounds - dispatch_rounds),
          f"grid: {saved} GEMM launches fewer than sequential, not "
          f"{per_round} for each of the {cell_rounds - dispatch_rounds} "
          "cell-rounds folded away")
    check(g["launches"]["clip_sgd"] == want_updates,
          f"grid: {g['launches']['clip_sgd']} update launches, not "
          f"{want_updates}")
    check(g["launches"]["clip_sgd_ext"] == 0,
          "grid: the external-mean update launched")
    check(all(math.isfinite(v) for r in res
              for v in r.train_loss + r.test_loss + r.clock),
          "grid: non-finite loss or clock")
    check(all(bool(torch.isfinite(t).all()) for ps in g["params"]
              for t in ps), "grid: non-finite parameters")
    check(all(all(row.values()) for row in bitwise),
          f"grid: cells differ from their own runs: {bitwise}")
    return out


def _same(xs, ys) -> bool:
    """Two lists of arrays (or Nones) equal element for element."""
    import numpy as np

    return len(xs) == len(ys) and all(
        (x is None and y is None) or np.array_equal(x, y)
        for x, y in zip(xs, ys))


def _same_result(a, b) -> bool:
    """Two `SimResult`s bitwise: rounds, clocks, losses, accuracies and
    decisions."""
    return (a.rounds == b.rounds and a.clock == b.clock
            and a.train_loss == b.train_loss and a.test_loss == b.test_loss
            and a.test_acc == b.test_acc
            and _same(a.b_history, b.b_history)
            and _same(a.cut_history, b.cut_history))


def _same_params(sa, sb) -> bool:
    import torch
    from repro_torch.utils.tree import tree_leaves

    return all(torch.equal(a, b) for a, b in zip(
        tree_leaves(sa.sim._stacked), tree_leaves(sb.sim._stacked)))


def _same_log(a, b) -> bool:
    return (a.time, a.round, a.kind, a.slot, a.user) == \
        (b.time, b.round, b.kind, b.slot, b.user)


def _recording_parts(sess):
    """Record every participation plan ``sess`` draws."""
    parts = []
    draw = sess.sim._segment_participation

    def recording(*a):
        parts.append(draw(*a))
        return parts[-1]

    sess.sim._segment_participation = recording
    return parts


def _recording_weights(sess):
    """Record every staleness-weight plan ``sess``'s traffic plane draws."""
    plans = []
    draw = sess.plane.plan_segment

    def recording(*a):
        plans.append(draw(*a))
        return plans[-1]

    sess.plane.plan_segment = recording
    return plans


def _timed_snapshots(sess):
    """Wrap ``sess``'s snapshot writer to add its wall seconds to the
    one-element list returned."""
    spent = [0.0]
    write = sess._snapshot_cb

    def timed(*a):
        t0 = time.perf_counter()
        write(*a)
        spent[0] += time.perf_counter() - t0

    sess._snapshot_cb = timed
    return spent


def _dynamic_runs(spec, name, record):
    """The full-width checkpoint drill of the ``scenario`` and ``traffic``
    phases: ``spec`` run uninterrupted on the card (launch counters zeroed
    just before and read just after, peak memory, policy seconds), run
    again writing a
    snapshot every `CHECKPOINT_EVERY` rounds into a temporary directory
    under build/ (snapshot seconds), then `Session.resume` from the first
    snapshot runs the rest.  ``record(sess)`` wraps what the phase reads
    and returns it.  Returns the three (session, result, recorded, wall
    seconds), the first run's launches, peak and policy seconds, and the
    second's snapshot seconds and bytes; the directory is removed."""
    import shutil
    import tempfile

    import torch
    from repro_torch.api import Session
    from repro_torch.kernels import ops

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix=f"{name}_snaps_", dir=ROOT / "build")
    try:
        runs = []
        for kind in ("whole", "checkpointed", "resumed"):
            gc.collect()
            torch.cuda.empty_cache()
            ck = spec.replace(checkpoint_every=CHECKPOINT_EVERY,
                              checkpoint_dir=ckpt_dir)
            if kind == "whole":
                sess = Session(spec)
            elif kind == "checkpointed":
                sess = Session(ck)
                snap_s = _timed_snapshots(sess)
            else:
                sess = Session.resume(ck, step=CHECKPOINT_EVERY)
            recorded = record(sess)
            if kind == "whole":
                policy_s = _timed_policies([sess])
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sess.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if kind == "whole":
                launches = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated()
            runs.append((sess, res, recorded, seconds))
            if kind == "checkpointed":
                snapshot_bytes = sum(
                    f.stat().st_size for f in Path(ckpt_dir).iterdir())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return runs, dict(launches=launches, max_memory_allocated=peak,
                      policy_seconds=policy_s[0],
                      snapshot_seconds=snap_s[0],
                      snapshot_bytes=snapshot_bytes)


def _dynamic_out(phase, spec, runs, info):
    """The common part of the ``scenario``/``traffic`` lines."""
    import math

    import torch
    from repro_torch.utils.tree import tree_leaves

    (whole, r, _, s_whole), (ck, rc, _, s_ck), (res, rr, _, s_res) = runs
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(whole.sim._stacked))
    out = {"phase": phase, "arch": spec.arch, "n_clients": spec.n_clients,
           "rounds": spec.rounds, "scenario": spec.scenario,
           "seconds": s_whole, "seconds_per_round": s_whole / spec.rounds,
           "policy_seconds": info["policy_seconds"],
           "checkpointed_seconds": s_ck,
           "resumed_seconds": s_res,
           "resumed_rounds": spec.rounds - CHECKPOINT_EVERY,
           "snapshot_seconds": info["snapshot_seconds"],
           "snapshot_bytes": info["snapshot_bytes"],
           "max_memory_allocated": info["max_memory_allocated"],
           "launches": info["launches"],
           "train_loss": r.train_loss, "test_acc": r.test_acc,
           "clock": r.clock,
           "b_history": [list(map(int, b)) for b in r.b_history],
           "checkpointed_bitwise": _same_result(rc, r)
           and _same_params(ck, whole),
           "resumed_bitwise": _same_result(rr, r)
           and _same_params(res, whole)}
    checks = [
        (len(r.train_loss) == spec.rounds // spec.eval_every, "evals"),
        (all(math.isfinite(v) for v in r.train_loss + r.test_loss + r.clock)
         and finite, "non-finite loss, clock or parameters"),
        (info["launches"]["batched_matmul"] > 0, "the GEMM never launched"),
        (info["launches"]["clip_sgd"] == spec.rounds,
         f"{info['launches']['clip_sgd']} update launches, not one a round"),
        (info["launches"]["clip_sgd_ext"] == 0,
         "the external-mean update launched"),
        (out["checkpointed_bitwise"],
         "the checkpointed run differs from the uninterrupted run"),
        (out["resumed_bitwise"],
         "the resumed run differs from the uninterrupted run"),
    ]
    return out, checks


def phase_scenario(detail):
    """The train phase's VGG-16 cell under ``churn-heavy`` with deadline
    faults (`SCENARIO`): run uninterrupted, checkpointed every 6 rounds,
    and resumed from round 6 (`_dynamic_runs`).  Checks: one update
    launch a round, the GEMM launched, the checkpointed and the resumed
    runs bitwise equal to the uninterrupted one (results and final
    parameters), and the deadline dropping clients.  Reports seconds per
    round, snapshot seconds and bytes, peak memory and the mean
    participation."""
    import numpy as np
    from repro_torch.api import ExperimentSpec
    from repro_torch.config import SFLConfig

    spec = ExperimentSpec(**GRID, policy="hasfl", conv_impl="kernel",
                          update_impl="kernel", **SCENARIO,
                          sfl=SFLConfig(lr=0.05, agg_interval=3))
    runs, info = _dynamic_runs(spec, "scenario", _recording_parts)
    out, checks = _dynamic_out("scenario", spec, runs, info)
    parts = np.concatenate(runs[0][2])
    out["mean_participation"] = float(parts.mean())
    out["rounds_with_drops"] = int((parts.min(axis=1) < 1).sum())
    out["parts_bitwise_resumed"] = _same(
        runs[2][2], runs[0][2][-len(runs[2][2]):])
    emit(out)
    detail["scenario"] = out
    checks += [(out["rounds_with_drops"] > 0, "no client was ever dropped"),
               (out["parts_bitwise_resumed"],
                "the resumed participation plans differ")]
    for ok, what in checks:
        check(ok, f"scenario: {what}")
    return out


def phase_traffic(detail):
    """The same VGG-16 cohort (8 slots) under ``churn-heavy`` with the
    streaming plane (`TRAFFIC`): the same drill as ``scenario``, plus the
    event log of the resumed run bitwise equal to the uninterrupted one's.
    Checks: more admits than the cohort, an eviction, a staleness weight
    strictly between 0 and 1, one update launch a round.  Reports event
    counts by kind and seconds per round."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, TrafficSpec
    from repro_torch.config import SFLConfig

    spec = ExperimentSpec(**GRID, policy="hasfl", conv_impl="kernel",
                          update_impl="kernel", scenario="churn-heavy",
                          scenario_seed=7, traffic=TrafficSpec(**TRAFFIC),
                          sfl=SFLConfig(lr=0.05, agg_interval=3))
    runs, info = _dynamic_runs(spec, "traffic", _recording_weights)
    out, checks = _dynamic_out("traffic", spec, runs, info)
    whole, resumed = runs[0][0], runs[2][0]
    w = np.concatenate([p.ravel() for p in runs[0][2]])
    counts = whole.plane.log.counts()
    out.update(events=counts, virtual_clock=whole.plane.clock,
               fractional_weights=int(((w > 0) & (w < 1)).sum()),
               min_positive_weight=float(w[w > 0].min()),
               event_log_bitwise_resumed=_same_log(resumed.plane.log,
                                                   whole.plane.log),
               event_log_bitwise_checkpointed=_same_log(
                   runs[1][0].plane.log, whole.plane.log))
    emit(out)
    detail["traffic"] = out
    checks += [
        (counts["admit"] > spec.n_clients,
         f"{counts['admit']} admits, not more than the cohort"),
        (counts["evict"] > 0, "no eviction"),
        (out["fractional_weights"] > 0, "no fractional staleness weight"),
        (out["event_log_bitwise_resumed"]
         and out["event_log_bitwise_checkpointed"],
         "the event log differs from the uninterrupted run's"),
    ]
    for ok, what in checks:
        check(ok, f"traffic: {what}")
    return out


def _cross_pair(spec, record):
    """``spec`` on the card and on the CPU from the same weights: the two
    (session, result, recorded plans) pairs."""
    import torch
    from repro_torch.api import Session
    from repro_torch.config import get_config
    from repro_torch.convert import units_to_numpy
    from repro_torch.models import build_model

    init = units_to_numpy(build_model(get_config(spec.arch)).init(
        torch.Generator().manual_seed(0)))
    out = []
    for dev in ("cuda", "cpu"):
        sess = Session(spec, device=dev, init_units=init)
        recorded = record(sess)
        out.append((sess, sess.run(), recorded))
    return out


def _cross_errors(ra, rb, sa, sb):
    """(max loss/accuracy difference, max parameter difference)."""
    import numpy as np
    from repro_torch.convert import units_to_numpy
    from repro_torch.utils.tree import tree_leaves

    loss = max(abs(a - b) for a, b in zip(
        ra.train_loss + ra.test_loss + ra.test_acc,
        rb.train_loss + rb.test_loss + rb.test_acc))
    param = max(float(np.max(np.abs(a - b))) for a, b in zip(
        tree_leaves(units_to_numpy(sa.sim._stacked)),
        tree_leaves(units_to_numpy(sb.sim._stacked))))
    return loss, param


def phase_dynamic_cross(detail):
    """The dynamic edge on the card against the CPU at ``cross_device``'s
    sizes (vgg9-cifar-small, N=4): the scenario cell (``SCENARIO``), a
    traffic cell (`TRAFFIC_CROSS`) and a 2 x 2 grid (hasfl, rbs+rms x
    straggler-bursts, flaky-uplink) through `run_grid`.  Decisions,
    clocks, gather and participation plans and event logs bitwise; losses
    and parameters within 1e-4; each grid cell on the card bitwise equal
    to its own `run()` on the card."""
    import torch
    from repro_torch.api import ExperimentSpec, Session, TrafficSpec, run_grid
    from repro_torch.config import SFLConfig, get_config
    from repro_torch.convert import units_to_numpy
    from repro_torch.models import build_model

    base = dict(arch="vgg9-cifar-small", n_clients=4, partition="iid",
                n_train=400, n_test=100, rounds=4, eval_every=2,
                policy="hasfl", estimate=False,
                sfl=SFLConfig(lr=0.05, agg_interval=2))
    out = {"phase": "dynamic_cross", "arch": base["arch"]}
    bad = []

    def both(sess):
        return _recording(sess), _recording_parts(sess)

    def gate(name, card, cpu, extra=()):
        (sa, ra, (pa, qa)), (sb, rb, (pb, qb)) = card, cpu
        loss, param = _cross_errors(ra, rb, sa, sb)
        row = dict(decisions=_same(ra.b_history, rb.b_history)
                   and _same(ra.cut_history, rb.cut_history),
                   clock=ra.clock == rb.clock, plans=_same(pa, pb),
                   participation=_same(qa, qb),
                   loss_acc_max_err=loss, param_max_err=param, **dict(extra))
        out[name] = row
        bad.extend(f"{name}: {k}" for k, v in row.items()
                   if v is False)
        if loss > CROSS_TOL or param > CROSS_TOL:
            bad.append(f"{name}: losses {loss} / parameters {param} over "
                       f"{CROSS_TOL}")

    spec = ExperimentSpec(**base, **SCENARIO)
    card, cpu = _cross_pair(spec, both)
    gate("scenario", card, cpu)

    spec = ExperimentSpec(**dict(base, policy="fixed"),
                          traffic=TrafficSpec(**TRAFFIC_CROSS))
    card, cpu = _cross_pair(spec, both)
    counts = card[0].plane.log.counts()
    gate("traffic", card, cpu, dict(
        event_log=_same_log(card[0].plane.log, cpu[0].plane.log),
        events=counts))
    if counts["admit"] <= spec.n_clients or counts["evict"] == 0:
        bad.append(f"traffic: the cell did not churn ({counts})")

    cells = [dict(base, policy=p, scenario=sc, scenario_seed=5)
             for p in ("hasfl", "rbs+rms")
             for sc in ("straggler-bursts", "flaky-uplink")]
    specs = [ExperimentSpec(**c) for c in cells]
    init = units_to_numpy(build_model(get_config(base["arch"])).init(
        torch.Generator().manual_seed(0)))
    grids = {}
    for dev in ("cuda", "cpu"):
        sessions = [Session(s, device=dev, init_units=init) for s in specs]
        recorded = [both(s) for s in sessions]
        grids[dev] = list(zip(sessions, run_grid(sessions), recorded))
    alone = [Session(s, init_units=init) for s in specs]
    alone_res = [s.run() for s in alone]
    rows = []
    for i, (card, cpu) in enumerate(zip(grids["cuda"], grids["cpu"])):
        gate(f"grid_{i}", card, cpu, dict(
            cell=f"{cells[i]['policy']} x {cells[i]['scenario']}",
            bitwise_own_run=_same_result(card[1], alone_res[i])
            and _same_params(card[0], alone[i])))
        rows.append(out.pop(f"grid_{i}"))
    out["grid"] = rows
    emit(out)
    detail["dynamic_cross"] = out
    check(not bad, "dynamic_cross: " + "; ".join(bad))
    return out


def phase_cli(detail):
    """`repro_torch.launch.train.main` in process, edge mode on the card
    (`CLI_ARGS`, a CSV under build/): one CSV row per eval, the
    ``.spec.json`` beside it reloading equal to the spec, and the numbers
    bitwise equal to `Session(spec).run()` on the card."""
    import csv
    import shutil
    import tempfile

    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.launch import train

    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="cli_", dir=ROOT / "build")
    try:
        path = str(Path(d) / "edge.csv")
        t0 = time.perf_counter()
        spec, res = train.main(CLI_ARGS + ["--csv", path])
        seconds = time.perf_counter() - t0
        with open(path) as f:
            rows = list(csv.DictReader(f))
        reloaded = ExperimentSpec.load(path + ".spec.json")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    alone = Session(spec).run()
    out = {"phase": "cli", "argv": CLI_ARGS, "seconds": seconds,
           "csv_rows": len(rows), "evals": len(res.rounds),
           "spec_reloads_equal": reloaded == spec,
           "csv_matches": [float(r["clock"]) for r in rows] == res.clock
           and [float(r["train_loss"]) for r in rows] == res.train_loss,
           "bitwise_session_run": _same_result(res, alone),
           "test_acc": res.test_acc, "clock": res.clock}
    emit(out)
    detail["cli"] = out
    check(out["csv_rows"] == out["evals"] == spec.rounds // spec.eval_every,
          f"cli: {out['csv_rows']} CSV rows for {out['evals']} evals")
    check(out["spec_reloads_equal"], "cli: the spec file reloads unequal")
    check(out["csv_matches"], "cli: the CSV differs from the result")
    check(out["bitwise_session_run"],
          "cli: the launcher's run differs from Session(spec).run()")
    return out


def _expected_launches(cfg, forwards: int) -> dict:
    """Launches of the token kernels in one ``serve`` run of ``forwards``
    forwards (one prefill, then decode steps): flash attention once per
    attention block (self, non-causal or cross) and forward; RMSNorm once
    per norm and forward (`_norm_calls`); the encoder's attention and
    norms (`_enc_norm_calls`) once, in prefill; the mLSTM scan once per
    mLSTM block, in prefill only."""
    kinds, enc = _blocks(cfg), _enc_blocks(cfg)
    attn = sum(kinds.count(k) for k in ATTN_KINDS)
    return {"flash_attention": attn * forwards
            + sum(enc.count(k) for k in ATTN_KINDS),
            "rmsnorm": len(_norm_calls(cfg, 1, 1)) * forwards
            + len(_enc_norm_calls(cfg, 1)),
            "mlstm_scan": kinds.count("mlstm")}


def _expected_mlstm_paths(cfg) -> dict:
    """The mLSTM scan's launches per kernel in one ``serve`` run: every
    prefill scan on the tensor-core path in bf16, on the recurrence in
    fp32."""
    scans = _blocks(cfg).count("mlstm")
    bf16 = cfg.dtype == "bfloat16"
    return {"tc": scans if bf16 else 0, "recurrent": 0 if bf16 else scans}


def _expected_paths(cfg, n_gen: int) -> dict:
    """Flash attention's launches per kernel in one ``serve`` run: the
    prefill's (the encoder's included) on the tensor-core path (bf16; fp32
    takes the CUDA-core kernel), every decode step's self- and
    cross-attention on the split-KV path."""
    attn = sum(_blocks(cfg).count(k) for k in ATTN_KINDS)
    enc = sum(_enc_blocks(cfg).count(k) for k in ATTN_KINDS)
    paths = {"tc": 0, "split_kv": attn * n_gen, "fp32": 0}
    paths["tc" if cfg.dtype == "bfloat16" else "fp32"] += attn + enc
    return paths


def _dropped_shares(records, cfg):
    """The MoE router's dropped share per forward (prefill, then each
    decode step), from `models.moe.RECORD`: the mean over the forward's
    MoE blocks of each block's ``dropped_frac``, and its per-block values."""
    import torch

    per_fwd = _blocks(cfg).count("moe")
    if not per_fwd:
        return None
    drops = torch.stack([a["dropped_frac"] for a in records]).cpu()
    drops = drops.reshape(-1, per_fwd)
    return {"prefill": drops[0].tolist(),
            "decode_mean": drops[1:].mean(dim=1).tolist(),
            "decode_max": float(drops[1:].max())}


def phase_serve(arch: str, name: str, layers=None):
    """`launch.serve.serve` at full width on the card (bf16, the port's
    seeded init, the family's modality stubs), cut to ``layers`` layers
    where the card's memory forces it: a first run at the same traffic
    warms the library handles and the allocator (and records the MoE
    router's dropped shares, `models.moe.RECORD`), the second is reported,
    with the launch counters zeroed just before it and read just after.
    The model's weights and caches are freed before it returns."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import seeded_inputs, serve
    from repro_torch.models import moe as M
    from repro_torch.utils.tree import tree_leaves

    published = get_config(arch)
    cfg = published if layers is None else dataclasses.replace(
        published, n_layers=layers)
    tf = _traffic()
    b, s, n_gen = tf["batch"], tf["prompt"], tf["gen"]
    torch.cuda.reset_peak_memory_stats()
    params, prompts = seeded_inputs(cfg, b, s, tf["seed"], "cuda")
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    M.RECORD = []
    try:
        serve(cfg, params, prompts, n_gen)            # warm-up
        drops = _dropped_shares(M.RECORD, cfg)
    finally:
        M.RECORD = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(cfg, params, prompts, n_gen)
    launches = ops.launch_counts()
    paths = FA.path_launches()
    mlstm_paths = MS.path_launches()
    peak = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    expected = _expected_launches(cfg, n_gen + 1)
    expected_paths = _expected_paths(cfg, n_gen)
    expected_mlstm = _expected_mlstm_paths(cfg)
    out = {"phase": name, "arch": arch, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab_size": cfg.vocab_size, "batch": b, "prompt": s,
           "gen": n_gen, "cache_len": s + n_gen,
           "prefill_ms": res.prefill_s * 1e3,
           "decode_ms_per_step": res.decode_s * 1e3 / n_gen,
           "tokens_per_s": res.tokens_per_s,
           "max_memory_allocated": peak,
           "launches": launches, "expected_launches": expected,
           "flash_paths": paths, "expected_flash_paths": expected_paths,
           "mlstm_paths": mlstm_paths, "expected_mlstm_paths": expected_mlstm,
           "sample": res.tokens[0][:16].tolist(),
           "logits_finite": bool(np.isfinite(res.logits).all()),
           "reduced": ({"n_layers": [layers, published.n_layers]}
                       if layers is not None else {}),
           "n_encoder_layers": cfg.n_encoder_layers,
           "weight_bytes": weight_bytes}
    if drops is not None:
        out["dropped_frac"] = drops
    emit(out)
    check(res.tokens.shape == (b, n_gen + 1), f"{name}: tokens "
          f"{res.tokens.shape}")
    check(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all(),
          f"{name}: token ids out of range")
    check(out["logits_finite"], f"{name}: non-finite logits")
    for kernel, want in expected.items():
        check(launches[kernel] == want, f"{name}: {launches[kernel]} "
              f"{kernel} launches, expected {want}")
    for path, want in expected_paths.items():
        check(paths[path] == want, f"{name}: {paths[path]} flash launches "
              f"on the {path} path, expected {want}")
    for path, want in expected_mlstm.items():
        check(mlstm_paths[path] == want, f"{name}: {mlstm_paths[path]} "
              f"mLSTM launches on the {path} path, expected {want}")
    for kernel in ("batched_matmul", "clip_sgd", "clip_sgd_ext"):
        check(launches[kernel] == 0, f"{name}: {kernel} launched")
    return out


def _forced(model, params, prompts, steps: int, feed=None):
    """Prefill (with the family's `stub_inputs`), then ``steps`` decode
    steps, each fed ``feed[:, i]`` (or the greedy token when ``feed`` is
    None); returns the fp32 logits [B, steps + 1, V] and the greedy ids
    [B, steps + 1]."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import stub_inputs

    dev = params["embed"].device
    b, s = prompts.shape
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(prompts, device=dev),
                 **stub_inputs(model.cfg, b, s, dev)},
        cache_len=s + steps)
    outs = [logits[:, 0].float().cpu().numpy()]
    for i in range(steps):
        tok = outs[-1].argmax(-1) if feed is None else feed[:, i]
        logits, cache = model.decode_step(params, cache, {
            "tokens": torch.as_tensor(tok[:, None], device=dev),
            "positions": torch.full((b,), s + i, dtype=torch.int32)})
        outs.append(logits[:, 0].float().cpu().numpy())
    logits = np.stack(outs, axis=1)
    return logits, logits.argmax(-1)


def _errors(logits, ref, tol):
    """Max |logits - ref| in prefill (step 0) and decode, and how far the
    worst element lies over the bar ``tol * (1 + |ref|)``."""
    import numpy as np

    diff = np.abs(logits - ref)
    return {"prefill_err": float(diff[:, 0].max()),
            "decode_err": float(diff[:, 1:].max()),
            "over_bar": float((diff - tol * (1 + np.abs(ref))).max())}


def _routed(model, params, prompts, steps, feed=None):
    """`_forced`, also returning each MoE call's chosen experts (host
    copies, in call order; [] without MoE blocks)."""
    from repro_torch.models import moe as M

    M.RECORD = []
    try:
        logits, ids = _forced(model, params, prompts, steps, feed=feed)
        experts = [a["expert_idx"].cpu() for a in M.RECORD]
    finally:
        M.RECORD = None
    return logits, ids, experts


def phase_serve_cross():
    """The card (kernels) against the CPU (plain versions) on the same fp32
    weights, every token family at full width cut as ``SERVE_CROSS``
    says; for the MoE families also the chosen experts of every MoE call,
    card against CPU.  For xlstm also the witness of its bar: the same
    card run with the mLSTM scan's plain version in place of kernel 6,
    against the CPU and against the kernel run, and the card runs with
    RMSNorm's plain version in place of kernel 5, with each scan, against
    the CPU (which kernel the error follows).  Each model is freed before
    the next is built."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    disable_tf32()
    c = SERVE_CROSS
    out = {"phase": "serve_cross"}
    for arch, cut in c["cuts"].items():
        published = get_config(arch)
        cfg = dataclasses.replace(published, dtype="float32", **cut)
        model = build_model(cfg)
        on_card = model.init(
            torch.Generator(device="cuda").manual_seed(c["seed"]), "cuda")
        on_cpu = tree_map(lambda t: t.cpu(), on_card)
        prompts = np.random.default_rng(c["seed"]).integers(
            0, cfg.vocab_size, (c["batch"], c["prompt"]))
        ops.reset_launch_counts()
        cpu_logits, cpu_ids, cpu_experts = _routed(model, on_cpu, prompts,
                                                   c["gen"])
        check(sum(ops.launch_counts().values()) == 0,
              f"serve_cross {arch}: a kernel launched on the CPU run")
        card_logits, card_ids, card_experts = _routed(
            model, on_card, prompts, c["gen"], feed=cpu_ids)
        tol = c["tol"].get(arch, c["default_tol"])
        res = {"n_layers": cfg.n_layers,
               **_errors(card_logits, cpu_logits, tol),
               "max_abs_logit": float(np.abs(cpu_logits).max()),
               "tol": tol, "ids_equal": bool((card_ids == cpu_ids).all()),
               "launches": ops.launch_counts(),
               "mlstm_paths": MS.path_launches()}
        res["reduced"] = {k: [v, getattr(published, k)]
                          for k, v in cut.items()}
        if cpu_experts:
            res["moe_calls"] = len(cpu_experts)
            res["experts_equal"] = len(card_experts) == len(cpu_experts) \
                and all(torch.equal(a, b)
                        for a, b in zip(card_experts, cpu_experts))
        if "mlstm" in _blocks(cfg):
            witness = {}
            for norm, scan in (("kernel", "plain"), ("plain", "kernel"),
                               ("plain", "plain")):
                swapped = ops.rmsnorm, ops.mlstm_scan
                if norm == "plain":
                    ops.rmsnorm = RN.rmsnorm_plain
                if scan == "plain":
                    ops.mlstm_scan = MS.mlstm_scan_plain
                try:
                    witness[norm, scan], _ = _forced(
                        model, on_card, prompts, c["gen"], feed=cpu_ids)
                finally:
                    ops.rmsnorm, ops.mlstm_scan = swapped
            plain_logits = witness["kernel", "plain"]
            res["plain_scan_on_card"] = {
                "vs_cpu": _errors(plain_logits, cpu_logits, tol),
                "vs_kernel": _errors(card_logits, plain_logits, tol)}
            res["plain_norm_on_card"] = {
                f"{scan}_scan": {"vs_cpu": _errors(
                    witness["plain", scan], cpu_logits, tol)}
                for scan in ("kernel", "plain")}
        out[arch] = res
        del on_card, on_cpu
        gc.collect()
        torch.cuda.empty_cache()
    emit(out)
    for arch, res in out.items():
        if arch == "phase":
            continue
        check(res["over_bar"] <= 0, f"serve_cross {arch}: logits differ by "
              f"{max(res['prefill_err'], res['decode_err'])}")
        check(res["ids_equal"], f"serve_cross {arch}: greedy ids")
        check(res.get("experts_equal", True),
              f"serve_cross {arch}: chosen experts differ")
        kernels = ["rmsnorm"] + (["mlstm_scan"] if arch == "xlstm-350m"
                                 else ["flash_attention"])
        for kernel in kernels:
            check(res["launches"][kernel] > 0,
                  f"serve_cross {arch}: {kernel} never launched on the card")
        paths = res["mlstm_paths"]
        check(paths["tc"] == 0 and paths["recurrent"]
              == res["launches"]["mlstm_scan"], f"serve_cross {arch}: fp32 "
              f"mLSTM launches off the recurrence ({paths})")
    return out


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

    t_start = time.perf_counter()
    smi = phase_gpu()
    phase_build()
    detail = {"gpu": smi}
    gemm, clip, ext, flash, norm, mlstm = phase_kernels(detail)
    train = phase_train()
    mesh = phase_mesh()
    phase_cross_device()
    phase_mesh_cross()
    import torch.distributed as dist

    dist.destroy_process_group()      # the mesh phases' world of one
    phase_grid_cross(detail)
    grid = phase_grid(detail)
    scenario = phase_scenario(detail)
    traffic = phase_traffic(detail)
    phase_dynamic_cross(detail)
    phase_cli(detail)
    # a simulator refers to itself (its segment function is a bound
    # method), so the earlier phases' sessions and their device tensors
    # go only with a collection: free them before serving's peak is read
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve("qwen3-1.7b", "serve")
    serve_ssm = phase_serve("xlstm-350m", "serve_ssm")
    families = {name: phase_serve(arch, name, layers)
                for name, arch, layers in FAMILY_SERVES}
    phase_serve_cross()

    launches = train["launches"]
    kernels = [
        {"name": "batched_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/batched_matmul.cu",
         "replaces": "src/repro/kernels/batched_conv.py:63",
         "launches": launches["batched_matmul"],
         "launches_grid": grid["launches"]["batched_matmul"],
         "launches_scenario": scenario["launches"]["batched_matmul"],
         "launches_traffic": traffic["launches"]["batched_matmul"],
         "max_abs_err": gemm["max_abs_err"], "ms": gemm["ms"],
         "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
         "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"]},
        {"name": "clip_sgd", "route": "cuda",
         "source": "src/repro_torch/csrc/clip_sgd.cu",
         "replaces": "src/repro/kernels/clip_sgd.py:29",
         "launches": launches["clip_sgd"],
         "launches_grid": grid["launches"]["clip_sgd"],
         "launches_scenario": scenario["launches"]["clip_sgd"],
         "launches_traffic": traffic["launches"]["clip_sgd"],
         "max_abs_err": clip["max_abs_err"], "ms": clip["ms"],
         "device_ms": clip["device_ms"],
         "plain_ms": clip["plain_ms"], "bound_ms": clip["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "clip_sgd_ext", "route": "cuda",
         "source": "src/repro_torch/csrc/clip_sgd.cu",
         "replaces": "src/repro/kernels/clip_sgd.py:44",
         "launches": mesh["launches"]["clip_sgd_ext"],
         "max_abs_err": ext["max_abs_err"], "ms": ext["ms"],
         "device_ms": ext["device_ms"],
         "plain_ms": ext["plain_ms"], "bound_ms": ext["bound_ms"],
         "full_read_bound_ms": ext["full_read_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:31",
         "launches": serve["launches"]["flash_attention"],
         "launches_by_path": serve["flash_paths"],
         "calls": flash["prefill"]["calls"],
         "max_abs_err": flash["max_abs_err"], "ms": flash["prefill"]["ms"],
         "plain_ms": flash["prefill"]["plain_ms"],
         "bound_ms": flash["prefill"]["bound_ms"],
         "bound_by": flash["prefill"]["bound_by"],
         "library_ms": flash["prefill"]["library_ms"],
         "decode": {k: flash["decode"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "launches_families": {name: r["launches"]["flash_attention"]
                               for name, r in families.items()},
         "shapes": {role: {k: flash[role][k] for k in (
             "shape", "calls", "path", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")}
             for role in FAMILY_FLASH_CALLS}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:11",
         "launches": serve["launches"]["rmsnorm"],
         "launches_families": {name: r["launches"]["rmsnorm"]
                               for name, r in families.items()},
         "calls": norm["prefill"]["calls"],
         "max_abs_err": norm["max_abs_err"], "ms": norm["prefill"]["ms"],
         "device_ms": norm["prefill"]["device_ms"],
         "plain_ms": norm["prefill"]["plain_ms"],
         "bound_ms": norm["prefill"]["bound_ms"], "bound_by": "bytes",
         "library_ms": norm["prefill"]["library_ms"],
         "library_device_ms": norm["prefill"]["library_device_ms"],
         "decode": {k: norm["decode"][k] for k in (
             "calls", "ms", "device_ms", "plain_ms", "bound_ms",
             "library_ms", "library_device_ms")}},
        {"name": "mlstm_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_scan.cu",
         "replaces": "src/repro/kernels/mlstm_scan.py:24",
         "launches": serve_ssm["launches"]["mlstm_scan"],
         "launches_by_path": serve_ssm["mlstm_paths"],
         "calls": mlstm["tc"]["calls"],
         "max_abs_err": mlstm["max_abs_err"], "ms": mlstm["tc"]["ms"],
         "device_ms": mlstm["tc"]["device_ms"],
         "plain_ms": mlstm["tc"]["plain_ms"],
         "bound_ms": mlstm["tc"]["bound_ms"],
         "bound_by": mlstm["tc"]["bound_by"],
         "recurrence_bound_ms": mlstm["tc"]["recurrence_bound_ms"],
         "library_ms": None,
         "fp32": {k: mlstm["recurrent"][k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by",
             "recurrence_bound_ms")}},
    ]
    detail["kernels"] = kernels
    detail["train"] = train
    detail["mesh"] = mesh
    detail["serve"] = serve
    detail["serve_ssm"] = serve_ssm
    detail.update(families)
    detail["seconds"] = time.perf_counter() - t_start
    path = Path(args.detail)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(detail, indent=1))

    emit({"phase": "total", "seconds": detail["seconds"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
