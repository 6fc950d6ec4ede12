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
   forward/dW/dx shape at N=8, b=64, and again at N=1, b=64 (the legacy
   engine's one client at a time) and at N=8, b=24 (a vectorized ``b_max``
   off the power-of-two buckets); `BatchedConv`'s forward and dx/dW/db
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
   on the card, on the scan engine and with ``--engine vectorized`` and
   ``--engine legacy``: one CSV row per eval, the ``.spec.json``
   reloading equal, the numbers bitwise equal to `Session(spec).run()`,
   the same clock on every engine.
   Then ``engines``: VGG-16 at full width (`ENGINES`: N=8, 4096 images, 6
   rounds, evals every 2, I=3) on the scan, vectorized and legacy engines
   from the same initial units, under ``fixed(b=24,cut=3)``, HASFL
   (priors) and ``fixed(b=32,cut=3)``; counters zeroed and read around
   each run.  Decisions, clocks
   and every sampler draw bitwise equal across the engines; legacy
   against vectorized within the reference's seed-loop bars; vectorized
   against scan recorded as bitwise or not (held bitwise where every
   ``b_max`` is a power of two); the stacked engines' update once a
   round, legacy's never, the GEMM > 0 on all.  Seconds a round, peak
   memory, and legacy's GEMM launches against vectorized's.  And
   ``engines_cross``: the vectorized and legacy engines card against CPU
   from the same weights, vgg9 at ``cross_device``'s sizes and a fp32
   smollm-tiny cell: decisions, clocks and draws bitwise, losses and
   parameters within 1e-4.
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

18. ``train_lm``: the simulator's token cell at full width (`TRAIN_LM`:
   smollm-135m, 30 layers, vocab 49152, bf16; N=8, IID, S=128, 4096
   training sequences, HASFL with the online G²/σ² estimate, I=3, 12
   rounds); counters zeroed and read around the run.  Seconds a round,
   the policy calls' share of the wall, peak memory, and a round's
   launches of flash attention forward and backward, RMSNorm forward and
   backward and kernel 2, each > 0; the test loss falls; every parameter
   leaf has moved from its start (a leaf cut from the graph would not).
   A witness records the shape of every backward call of kernels 4 and
   5 and the inputs of the last kernel-2 call.
19. ``spmd``: `make_hasfl_train_step` at full width (`SPMD`: qwen3-1.7b,
   N=2, cut_reps=1, b=4, S=512, Adam, 6 steps), remat off and then on:
   seconds a step, tokens/s, peak memory, the loss a step (it falls), and
   both backward kernels launched; the same witness.
20. ``train_moe``: the same step on dbrx-132b at its published widths
   (`TRAIN_MOE`: d 6144, 48/8 heads at hd 128, 16 experts of 10752 top-4,
   vocab 100352), cut to 2 of 40 layers with cut_reps=1 (an MoE layer in
   the client-stacked prefix, one on the server), N=2, b=2, S=512, SGD, 6
   steps: seconds a step, tokens/s, peak memory, each step's load-balance
   loss and the router's dropped share (`models.moe.RECORD`), a step's
   launches of kernels 4 and 5 forward and backward.  Gates: the loss is
   finite and falls, the lb loss finite and > 0, every parameter leaf
   moved (the routers included; fp64 fingerprints, not copies, at 23 GB
   of weights), kernels 4 and 5 forward and backward launched.
21. ``train_families``: whisper-medium whole (24 + 24 layers over 1500
   stub frames; Adam, remat), internvl2-1b whole with 256 patch stubs a
   sequence (S=512, Adam) and jamba's super-block (7 mamba, 1 attention,
   4 MoE layers at d 4096, 4 of 16 experts; cut_reps=0, SGD) through the
   same step (`TRAIN_FAMILY_SPMD`), and internvl2 in a `Session`
   (`TRAIN_VLM`: N=4, S=64, HASFL priors, 6 rounds, kernel 2 once a
   round); each run's seconds and peak, gates as ``train_moe``'s.
   llama4 at its published widths does not fit one card (one MoE layer is
   ~16 B parameters); it trains in ``train_cross`` only.
   Then ``train_xlstm``: the same step on xlstm-350m whole at its
   published widths (`TRAIN_XLSTM`: 24 layers, 20 mLSTM and 4 sLSTM,
   N=2, cut_reps=1, b=4, S=512, Adam, 4 steps, remat off and then on):
   kernel 6's forward and backward 20 times a step on the tensor cores
   (40 forwards under remat), the loss falls, every leaf moves; one
   sLSTM block's forward and backward alone, wall and device-busy ms
   under the profiler, and its share of a step; and ``xlstm_session``:
   a `Session` on xlstm cut to one period of its pattern
   (`XLSTM_SESSION`: 5 mLSTM + 1 sLSTM layers, N=4, S=64, 6 rounds),
   kernel 6's backward 5 times a round, kernel 2 once.
22. ``kernels_train``: the training kernels at what the runs ran:
   kernel 4's ``lse`` and backward against their plain versions at the
   reference's cases and at every shape the witnesses recorded (dQ, dK,
   dV within 2e-5·(1+|plain|) at fp32 and 3e-2·max|plain| at bf16,
   bitwise repeatable), each run's most frequent shape timed as one
   backward's calls (a call a layer) beside SDPA's backward (its forward
   + backward minus its forward); kernel 5's grouped scale and backward
   at the reference's cases and every recorded shape, each recorded
   shape timed beside ``F.rms_norm``'s backward; kernel 2 on copies of
   ``train_lm``'s last round (the session's own bf16 and fp32 leaves,
   gradients, clip factors and keep flags) against its plain version
   leaf by leaf (bf16 within one bf16 ulp); kernel 6's backward at the
   reference's cases, at extreme gates at hd 512 (bf16 and fp32), at
   `serve_cross`'s fp32 shape (2 × 64, 4 heads, hd 512) and at every
   shape `train_xlstm` and `xlstm_session` ran (3e-2·max|plain| at
   bf16, 2e-5·(1+|plain|) at fp32, 2e-5·max|plain| at extreme gates),
   bitwise repeatable, from a forward whose h is serving's bitwise, each
   recorded shape timed as a step's calls beside its bound and the fp64
   plain version.
23. ``train_cross``: card against CPU from the same fp32 weights
   (`TRAIN_CROSS`): smollm-tiny, and qwen3, glm4, phi3 (hd 96), dbrx,
   llama4 (8 experts), jamba (one super-block, 4 experts), internvl2
   (patch stubs) and whisper (frame stubs) reduced to 2 layers: a 6-round
   token `Session` (decisions, clocks and plans bitwise; losses and
   parameters within 1e-4; whisper's raises the reference's
   ``KeyError('frame_embeddings')`` on both devices) and 3 SPMD steps with
   SGD (parameters within 1e-4), every MoE call's experts equal on both.
   Then smollm-tiny and dbrx at bf16 (`TRAIN_CROSS_BF16`, 6 rounds):
   decisions and clocks bitwise, smollm's losses within 1e-3; dbrx's
   losses recorded beside the experts that differ between the devices and
   the loss move of one bf16 ulp on the card alone (its routers flip on
   the kernels' other bf16 rounding).  dbrx's ``loss`` backward run twice
   on the card records whether the MoE backward repeats bitwise.  Also
   xlstm-350m at its published widths cut to 6 layers (one
   period, both block kinds; b capped at 4 and 3 rounds: its CPU side is
   the sequential fp32 recurrence under autograd) held at
   2e-4·(1+|CPU|): its Session, and each of its 3 SPMD steps taken on the
   card from the CPU's own weights; its 3-step run is recorded beside the
   scan's plain version on the card, the fp64 backward, one ulp's growth
   and the den branches of both devices (`_xlstm_spmd_witness`).  At
   bf16 its losses are recorded.
24. ``cli_spmd``: ``python -m repro_torch.launch.train --mode spmd`` in
   process on the card (`SPMD_CLI`): a row a step, finite losses.
25. ``grid_lm``: four smollm-135m cells at published widths (`GRID_LM`:
   N=4, S=128, 2048 sequences, 6 rounds, I=3, b=16, cut 1 or 3 x seed 0
   or 1) through `run_grid`, with ``runner="sequential"`` and then
   folded; counters zeroed and read around each.  Every cell bitwise
   equal both ways (results and parameters), the products (one
   `torch.bmm` a cell each way) counted equal, kernel 2 ⌈members·272/64⌉
   launches a dispatch round, kernels 4-5 fewer folded.  Seconds a
   cell-round both ways, policy seconds, dispatches, peaks.
26. ``mesh_lm``: mesh mode on smollm-135m (`MESH_LM`: 8 slots of a
   population of 1024 on 4 edge servers, world-size-1 NCCL group, 6
   rounds at I=2, two rotations): kernel 3 ⌈272/64⌉ launches a round on
   its 211 bf16 leaves and 61 fp32 ones, kernel 2 none, the test loss
   falls, every leaf moved; seconds a round, all-reduce ms, policy
   share, peak; then kernel 3 on copies of the last two rounds (round 5,
   where the client-specific leaves keep, and the aggregation round)
   against its plain version within one bf16 ulp, each timed beside its
   bytes bound.
27. ``dynamic_lm``: smollm-135m (`DYNAMIC_LM`, N=4, 6 rounds) under
   ``churn-heavy`` with deadline faults and then on the streaming plane
   (`TRAFFIC`), each uninterrupted, checkpointed every 3 rounds (~1.1 GB
   a snapshot) and resumed from round 3, bitwise.
28. ``serve_ring``: qwen3-1.7b at published widths decoding from a ring
   (`SERVE_RING`: window and ring of 8192 slots, the long_500k combo's,
   batch 1, an 8192-token prefill, 64 bf16 greedy steps that wrap the
   ring, positions on the card): every step's 28 flash launches on the
   split-KV path, the stored positions the reference's ring arithmetic,
   the logits recorded beside the same steps on the plain decode at
   ``tests/test_decode.py``'s bars with the witness of bf16 rounding
   alone (the plain decode without its P rounding), the greedy ids that
   agree; the same ring in fp32 for 16 steps, held against the plain
   decode at 1e-4 · (1 + |plain|); kernel 4's decode at this shape on the
   real cache, timed beside its bound, its plain version and SDPA (a
   boolean mask from the positions, ``enable_gqa``).
29. ``decode_positions``: qwen3-1.7b at published widths, 8 sequences
   prefilled alone at 384 + 16·i tokens into one 576-slot cache, then
   decoded together each at its own position (32 bf16 steps, recorded;
   8 fp32 steps, held at 1e-4 · (1 + |alone|)) against each sequence
   decoded alone at batch 1.
30. ``dryrun``: `launch.dryrun.run_combo` on the host mesh (1 x 1), on
   the ``meta`` device (no card): ``spmd``'s step and ``serve_ring``'s
   decode step (the long_500k combo), each combo's FLOPs, bytes,
   roofline terms, model-FLOPs share and predicted per-device bytes
   beside the phase's measured seconds and peak.
31. ``grad_moments``: the HASFL estimate's per-unit gradient moments
   (``csrc/grad_moments.cu``) at VGG-16's decision — three fp32 samples
   of its 32 leaves in 16 units — bitwise the kernel's order emulated on
   the host (`grad_moments_plain`) and bitwise repeatable, within 1e-12
   of the host path (`_flat_grad` copies, `estimate_constants`); timed
   as the wrapper's call (CUDA events, its table's upload included), as
   the two launches alone (`device_ms`, from a CUDA graph, and by kernel
   under ``split``), beside the bytes bound, the host path's seconds
   (``plain_s``) and the straightforward `torch` fp64 ops on the card
   (``library_ms``); then the kernel and `torch` at smollm-135m's 32
   units (bf16 weights, fp32 norms), within 1e-12 of each other.  The
   ``train`` phase's HASFL controller takes its moments through it.

``grid_cross`` also folds token grids (`TOKEN_GRIDS`: smollm-tiny fp32
and bf16, reduced dbrx fp32), each cell bitwise its own run on the card;
``mesh_cross`` also runs a smollm-tiny mesh cell (2 edges, a bank of 64,
kernel 3) card against CPU in fp32 (losses and parameters 1e-4) and bf16
(losses 1e-3); ``dynamic_cross`` also the reference's resume spec
(`tests/test_resume.py`, bf16) card against CPU (losses 1e-3); the
``kernels`` phase also holds kernel 3 on bf16 leaves with a bf16 mean;
``serve_cross`` also decodes qwen3 (2 layers, fp32) from a 16-slot ring
under a window of 16 after a 40-token prompt (not a multiple of 16: the
windowed prefill's slot order, kept from the reference, runs on both
sides) and four sequences at their own positions (20-44 tokens in 64
slots), card against CPU at 1e-4, ids equal;
``token_families`` runs qwen3, glm4, phi3, llama4, jamba and internvl2
(`reduced`, fp32) through a two-cell `run_grid` (bitwise), mesh mode
with and without a bank, and a scenario and a traffic cell resumed
bitwise, each on the card.

The summary line gives the two backward kernels rows of their own
(``flash_attention_bwd``, ``rmsnorm_bwd``, at ``train_lm``'s most
frequent shape, with every other run's shapes under ``shapes``), with
their launches in ``train_lm`` (and per round), ``spmd``, ``train_moe``
and each ``train_families`` run; kernel 2's row carries the token round
under ``token_round``.

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

import contextlib
import functools
import gc
import json
import math
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
# the engines phase's cell: the train phase's VGG-16 at full width on
# each round engine from the same initial units, under a fixed policy
# whose b_max (24) is off the power-of-two buckets, under HASFL's own
# decisions (priors only: decisions from the host plane alone), and at
# b = 32, where the scan engine pads no wider than the vectorized one
ENGINES = dict(arch="vgg16-cifar", n_clients=8, partition="iid",
               n_train=4096, n_test=512, rounds=6, eval_every=2)
ENGINES_AGG = 3
ENGINES_POLICIES = {"fixed": dict(policy="fixed(b=24,cut=3)"),
                    "hasfl": dict(policy="hasfl", estimate=False),
                    "fixed_pow2": dict(policy="fixed(b=32,cut=3)")}
# the reference's legacy == vectorized bars (tests/test_dist_sharding.py):
# losses and parameters, and accuracy (a few of 512 test images)
SEED_LOOP = dict(rtol=2e-3, atol=2e-4)
SEED_LOOP_ACC = 0.051
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
    # the backward's wgmma tiling: hd 128 native, hd 96 padded, a ragged
    # non-causal length (64-row and 64-key steps)
    (2, 256, 256, 4, 2, 128, True, 0, "bfloat16"),
    (1, 190, 190, 6, 2, 96, True, 0, "bfloat16"),
    (2, 200, 200, 4, 4, 64, False, 0, "bfloat16"),
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
# kernel 6's backward at hd 512 off the recorded shapes: serve_cross's
# shape on the fp32 path (train_cross's fp32 cells take it), and extreme
# gates on each path
MLSTM_BWD_EDGES = [(2, 64, 4, 512, "float32", "normal"),
                   (2, 256, 4, 512, "bfloat16", "extreme"),
                   (2, 256, 4, 512, "float32", "extreme")]
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
    sources = ["batched_matmul", "clip_sgd", "flash_attention",
               "flash_attention_bwd", "rmsnorm", "mlstm_scan",
               "mlstm_scan_bwd", "grad_moments"]
    build.build(sources)
    seconds = time.perf_counter() - t0
    ptxas = {name: _ptxas_lines(build.BUILD_LOGS.get(name, ""))
             for name in sources}
    emit({"phase": "build", "seconds": round(seconds, 3), "ptxas": ptxas})
    # kernel 4's and kernel 6's bf16 backwards (on wgmma): no instance
    # spills (the fp32 kernels beside them are not held to this)
    bf16 = {"flash_attention_bwd": ("tcb",),
            "mlstm_scan_bwd": ("scores_wg", "products_wg", "prep_kernel",
                               "gates_kernel")}
    for name, marks in bf16.items():
        entry, spills = "", []
        for ln in ptxas[name]:
            if "spill" not in ln:
                entry = ln if "registers" not in ln else entry
            elif any(m in entry for m in marks) and not ln.startswith(
                    "0 bytes stack frame, 0 bytes spill stores"):
                spills.append((entry, ln))
        check(not spills, f"{name} (bf16) spills: {spills}")


def _gemm_checks(detail, n: int = 8, batch: int = 64):
    """Kernel 1 at every GEMM of one VGG-16 round at ``n`` clients of
    ``batch`` images (N=8, b=64: the stacked engines' main path; N=1, b=64: the
    legacy engine's per-client shapes; N=8, b=24: a ``b_max`` off the
    power-of-two buckets, as the vectorized engine pads): each against
    its plain version at `GEMM_RTOL`, every split-K plan bitwise
    repeatable, timed beside ``torch.bmm`` and its bound.  Returns the
    sums over the round's shapes; the rows go to ``detail``."""
    import torch
    from repro_torch.kernels import batched_conv as BC

    gen = torch.Generator(device="cuda").manual_seed(0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0, flops=0.0, bytes=0.0)
    rows = []
    sms = torch.cuda.get_device_properties("cuda").multi_processor_count
    for name, kind, m, k, c in vgg16_gemm_shapes(n, batch):
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
        if (n, batch) == (8, 64) and name in ("conv1.dW", "conv2.dW"):
            check(splits > 1, f"GEMM {name}: no split-K")
        if splits > 1:
            # split-K reduces its partials in a fixed order
            check(torch.equal(out, BC.batched_matmul_kernel(a, b)),
                  f"GEMM {name} {(n, m, k, c)}: split-K ({splits} splits) "
                  "not bitwise repeatable")
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
    detail[f"gemm_vgg16_n{n}_b{batch}"] = rows
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
    # bf16 leaves (a token model's units in mesh mode): a bf16 mean, as
    # the two-tier combine makes it in the leaf's type, widened by the
    # wrapper; the plain version in fp32 rounded once (the kernel's
    # arithmetic) within one bf16 ulp, each (u, keep), aligned and not
    bf16_err = 0.0
    for size in (576, 576 * 1536 + 3, 49152):
        p = torch.randn((n, size), device="cuda", generator=gen) \
            .to(torch.bfloat16)
        g = torch.randn((n, size), device="cuda", generator=gen) \
            .to(torch.bfloat16)
        common = torch.randn(size, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        for keep_on in (True, False):
            keep = torch.full((n,), keep_on, device="cuda")
            for use in (True, False):
                u = torch.tensor(use, device="cuda")
                want = CS.clip_sgd_ext_plain(
                    p.float(), g.float(), scale, keep, common.float(), u,
                    gamma=gamma).to(torch.bfloat16).float()
                got = CS.clip_sgd_ext_kernel(p.clone(), g, scale, keep,
                                             common, u, gamma=gamma).float()
                diff = (got - want).abs()
                check(bool((diff <= 2 ** -7 * want.abs() + 1e-6).all()),
                      f"clip_sgd_ext bf16 D={size} keep={keep_on} u={use}: "
                      f"{float(diff.max())} over one bf16 ulp")
                bf16_err = max(bf16_err, float(diff.max()))
        del p, g, common
    err, tot = _round_checks(gen, n, gamma, ext=True)
    tot["bf16_max_abs_err"] = bf16_err
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
        call = functools.partial(FA.flash_attention_kernel, q, k, v, **kw)
        if sq == 1:   # as decode calls it: positions stored on the card
            slots = torch.arange(sk, dtype=torch.int32, device="cuda")
            k_pos = torch.where(slots < nv, slots, -1).expand(b, sk) \
                .contiguous()
            cur = torch.full((b,), sk, dtype=torch.int32, device="cuda")
            call = functools.partial(FA.flash_decode_kernel, q, k, v, k_pos,
                                     cur)
        rows[role] = dict(
            shape=list(case[:9]), sk_valid=nv, calls=calls, path=path,
            max_abs_err=err, ms=time_ms(_span(call, calls)),
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
        # the training forward (with the backward's a_t and m_t) gives h
        # bitwise as serving's
        h_stats, a_t, m_t = MS.mlstm_scan_kernel(q, k, v, ig, fg,
                                                 stats=True)
        check(torch.equal(got, h_stats),
              f"mlstm {case}: h with and without a_t differ")
        del h_stats, a_t, m_t
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
    # the per-round engines' GEMMs: legacy's one client at a time, and a
    # vectorized b_max of 24 (the engines phase's fixed policy)
    gemm_engines = {"legacy_n1_b64": _gemm_checks(detail, 1, 64),
                    "vectorized_n8_b24": _gemm_checks(detail, 8, 24)}
    gemm.update(gemm_engines)
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
          **{f"batched_matmul_{key}": {k: tot[k] for k in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err")} for key, tot in gemm_engines.items()},
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
          "note": "GEMM: one VGG-16 round's shapes summed at N=8 (b=64), "
                  "at N=1 (b=64, one legacy client) and N=8 (b=24); "
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
    check(launches["grad_moments"] > 0,
          "train: the controller's estimate never launched its moments")
    return out


def _moments_library(samples):
    """The ``[U, 2]`` moments by straightforward `torch` fp64 ops on the
    card: each unit's samples concatenated, widened and stacked."""
    import torch
    from repro_torch.utils.tree import tree_leaves

    out = []
    for u in range(len(samples[0])):
        x = torch.stack([torch.cat([t.reshape(-1) for t in tree_leaves(s[u])])
                         .double() for s in samples])
        out.append(torch.stack([(x * x).sum(1).mean(),
                                ((x - x.mean(0)) ** 2).sum(1).mean()]))
    return torch.stack(out)


def phase_grad_moments():
    import numpy as np
    import torch
    from repro_torch.core.convergence import estimate_constants
    from repro_torch.core.split import to_units
    from repro_torch.config import get_config
    from repro_torch.kernels import grad_moments as GM
    from repro_torch.kernels.launch import raw_stream
    from repro_torch.models.factory import build_model
    from repro_torch.scenarios.controller import _flat_grad
    from repro_torch.timing import graph_ms, launch_split
    from repro_torch.utils.tree import tree_leaves, tree_map

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    # three fp32 gradient samples of VGG-16's 16 units (bias, weight)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = vgg16_leaf_sizes()
    samples = [[[torch.randn(d, device="cuda", generator=gen) * 1e-2
                 for d in sizes[i:i + 2]] for i in range(0, len(sizes), 2)]
               for _ in range(3)]
    before = GM.grad_moments_kernel.launches
    got = GM.grad_moments_kernel(samples)
    again = GM.grad_moments_kernel(samples)
    torch.cuda.synchronize()
    check(GM.grad_moments_kernel.launches == before + 2 * GM.LAUNCHES,
          "grad_moments: not two launches a call")
    got, again = got.cpu().numpy(), again.cpu().numpy()
    check(np.array_equal(got, again), "grad_moments: not bitwise repeatable")
    check(np.array_equal(got, GM.grad_moments_plain(samples)),
          "grad_moments: not the emulated order bitwise")
    t0 = time.perf_counter()
    est = estimate_constants([[_flat_grad(u) for u in s] for s in samples])
    plain_s = time.perf_counter() - t0
    want = np.stack([est["g_sq"], est["sigma_sq"]], axis=1)
    err = rel(got, want)
    check(err <= 1e-12, f"grad_moments: {err} from the host path")
    units = GM.unit_leaves(samples)
    words, entries, chunks = GM.table(units)
    tab = torch.from_numpy(words).cuda()
    partials = torch.empty(chunks * 6, dtype=torch.float64, device="cuda")
    out = torch.empty((len(units), 2), dtype=torch.float64, device="cuda")
    fn = GM.symbol()

    def launches():
        fn(tab.data_ptr(), entries, tab.data_ptr() + 8 * entries
           * GM.ENTRY_WORDS, len(units), chunks, 3, partials.data_ptr(),
           out.data_ptr(), raw_stream(0))

    elements = sum(t.numel() for s in samples[:1] for u in s for t in u)
    res = {"phase": "grad_moments", "units": len(units), "leaves": entries,
           "elements": elements, "chunks": chunks, "max_rel_err": err,
           "ms": time_ms(lambda: GM.grad_moments_kernel(samples), reps=20),
           "device_ms": graph_ms(launches, calls=10) / 10,
           "split": launch_split(launches),
           "bound_ms": 3 * 4 * elements / 3.35e12 * 1e3,
           "plain_s": plain_s,
           "library_ms": time_ms(lambda: _moments_library(samples), reps=5)}
    lib = _moments_library(samples).cpu().numpy()
    res["library_rel_err"] = rel(lib, want)
    del samples, tab, partials, out
    cfg = get_config("smollm-135m")
    shapes = to_units(cfg, build_model(cfg).init(
        torch.Generator().manual_seed(0), "meta"))[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    lm = [[tree_map(lambda t: (torch.randn(t.shape, device="cuda",
                                           generator=gen) * 1e-3)
                    .to(t.dtype), u) for u in shapes] for _ in range(3)]
    got = GM.grad_moments_kernel(lm).cpu().numpy()
    lib = _moments_library(lm).cpu().numpy()
    err = rel(got, lib)
    check(err <= 1e-12, f"grad_moments smollm-135m: {err} from torch fp64")
    elements = sum(t.numel() for t in tree_leaves(lm[0]))
    item = sum(t.numel() * t.element_size() for t in tree_leaves(lm[0]))
    res["smollm_135m"] = {
        "units": len(shapes), "elements": elements, "max_rel_err": err,
        "ms": time_ms(lambda: GM.grad_moments_kernel(lm), reps=5),
        "bound_ms": 3 * item / 3.35e12 * 1e3,
        "library_ms": time_ms(lambda: _moments_library(lm), reps=2)}
    emit(res)
    return res


def _allreduce_ms(group, leaves=None) -> float:
    """Card time of one mesh round's all-reduces: per leaf, the [D]
    edge-sum total and the survivor count in the leaf's type (CUDA events,
    5 calls after a warm-up each, summed over the leaves); ``leaves``:
    (D, dtype) pairs, by default the 32 VGG-16 leaves in fp32."""
    import torch
    import torch.distributed as dist

    if leaves is None:
        leaves = [(size, torch.float32) for size in vgg16_leaf_sizes()]
    total = 0.0
    for size, dtype in leaves:
        buf = torch.ones(size, device="cuda", dtype=dtype)
        cnt = torch.ones((), device="cuda", dtype=dtype)
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
    _mesh_cross_token()


def _mesh_cross_token():
    """A smollm-tiny mesh cell (N=4 on 2 edge servers, a cohort bank of
    64, HASFL on priors, kernel 3) on the card against the CPU from the
    same weights, in fp32 and at its registered bf16: decisions, clocks
    and gather plans bitwise; losses within 1e-4 (fp32) or 1e-3 (bf16),
    parameters within 1e-4 at fp32 (recorded at bf16, where a weight
    moves by whole ulps).  Each device runs on its own world of one (NCCL,
    then gloo); no process group is left."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig
    from repro_torch.mesh import MeshSpec

    out = {"phase": "mesh_cross_token"}
    bad = []
    for dtype, tol in (("float32", CROSS_TOL), ("bfloat16", 1e-3)):
        cfg = _register_cut("smollm-tiny", f"smollm-tiny-mesh-{dtype}",
                            dtype)
        spec = ExperimentSpec(
            arch=cfg.arch_id, n_clients=4, partition="iid", n_train=128,
            n_test=16, seq_len=16, rounds=4, eval_every=2, policy="hasfl",
            estimate=False, update_impl="kernel",
            sfl=SFLConfig(lr=0.05, agg_interval=2),
            mesh=MeshSpec(devices=1, n_edges=2, population=64))
        runs = {}
        for dev in ("cuda", "cpu"):
            # the seeded init is drawn on the host: the same on both
            if dist.is_initialized():
                dist.destroy_process_group()
            sess = Session(spec, device=dev)
            plans = _recording(sess)
            runs[dev] = (sess.run(), plans, _host_f32(sess.sim._stacked))
            del sess
        dist.destroy_process_group()
        (rg, pg, wg), (rc, pc, wc) = runs["cuda"], runs["cpu"]
        loss_err = max(abs(a - b) for a, b in zip(
            rg.train_loss + rg.test_loss, rc.train_loss + rc.test_loss))
        param_err = max(float(np.max(np.abs(a - b)))
                        for a, b in zip(wg, wc))
        row = dict(decisions=_same(rg.b_history, rc.b_history)
                   and _same(rg.cut_history, rc.cut_history),
                   clock=rg.clock == rc.clock, plans=_same(pg, pc),
                   loss_max_err=loss_err, param_max_err=param_err)
        out[dtype] = row
        bad += [f"{dtype}: {k}" for k, v in row.items() if v is False]
        if loss_err > tol or (dtype == "float32" and param_err > tol):
            bad.append(f"{dtype}: losses {loss_err} / parameters "
                       f"{param_err} over {tol}")
    emit(out)
    check(not bad, "mesh_cross token: " + "; ".join(bad))


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


# grid_cross's token grids: (arch, dtype, cut) at smollm-tiny's widths or
# `reduced` (dbrx: 2 layers, 4 experts top-2), each over TOKEN_GRID_CELLS:
# two b buckets (8 and 16), seeds crossed within the b=8 bucket (cells
# reading their own data), other cuts, and HASFL on priors
TOKEN_GRIDS = {"smollm_fp32": ("smollm-tiny", "float32", {}),
               "smollm_bf16": ("smollm-tiny", "bfloat16", {}),
               "dbrx_fp32": ("dbrx-132b", "float32", {"n_layers": 2})}
TOKEN_GRID_CELLS = [dict(policy="fixed(b=4,cut=1)", seed=0),
                    dict(policy="fixed(b=4,cut=2)", seed=1),
                    dict(policy="fixed(b=8,cut=1)", seed=1),
                    dict(policy="hasfl", seed=0)]


def phase_grid_cross(detail):
    """`run_grid` on the card against each cell's own `run()`, at
    ``cross_device``'s sizes: grid (a), three policies crossing pow2
    buckets with the estimating controller, and grid (b), seeds x
    partitions (cells reading their own data); then the token grids
    (`TOKEN_GRIDS`: smollm-tiny in fp32 and bf16, reduced dbrx in fp32).
    Decisions, clocks, gather plans, losses, accuracies and parameters
    bitwise; the op-by-op witness of one folded round body goes to
    ``--detail``."""
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
    grids = {name: [dict(base, **c) for c in cells]
             for name, cells in grids.items()}
    for name, (arch, dtype, cut) in TOKEN_GRIDS.items():
        cfg = _register_cut(arch, f"{arch}-grid-{dtype}", dtype, **cut)
        grids[name] = [dict(base, arch=cfg.arch_id, n_train=128, n_test=16,
                            seq_len=16, **c) for c in TOKEN_GRID_CELLS]
    same = lambda xs, ys: len(xs) == len(ys) and all(
        np.array_equal(x, y) for x, y in zip(xs, ys))
    out = {"phase": "grid_cross", "arch": base["arch"]}
    bad = []
    for name, cells in grids.items():
        specs = [ExperimentSpec(**c) for c in cells]
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
        main = ("flash_attention", "rmsnorm") if name in TOKEN_GRIDS \
            else ("batched_matmul",)
        check(all(launches[k] > 0 for k in main + ("clip_sgd",)),
              f"grid_cross {name}: the kernels never launched")
        check(len({tuple(r.train_loss) for r in res}) == len(res),
              f"grid_cross {name}: cells do not differ")
    # the grid's round body, then the same with the library ops folded:
    # the first stage at which each differs from the per-cell bodies
    for key, fold_library in (("grid_witness", False),
                              ("grid_witness_library_folded", True)):
        witness = _grid_witness([ExperimentSpec(**c) for c in grids["b"]],
                                fold_library)
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


def _dynamic_runs(spec, name, record, every=CHECKPOINT_EVERY):
    """The full-width checkpoint drill of the ``scenario``, ``traffic`` and
    ``dynamic_lm`` phases: ``spec`` run uninterrupted on the card (launch
    counters zeroed just before and read just after, peak memory, policy
    seconds), run again writing a snapshot every ``every`` rounds into a
    temporary directory under build/ (snapshot seconds), then
    `Session.resume` from the first snapshot runs the rest.  ``record(sess)`` wraps what the phase reads
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
            ck = spec.replace(checkpoint_every=every,
                              checkpoint_dir=ckpt_dir)
            if kind == "whole":
                sess = Session(spec)
            elif kind == "checkpointed":
                sess = Session(ck)
                snap_s = _timed_snapshots(sess)
            else:
                sess = Session.resume(ck, step=every)
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


def _dynamic_out(phase, spec, runs, info, every=CHECKPOINT_EVERY,
                 updates_a_round=1):
    """The common part of the ``scenario``/``traffic``/``dynamic_lm``
    lines; ``updates_a_round``: kernel 2's launches a round (a token
    model's leaves take several tables), and on a token model flash
    attention stands for the GEMM in the launch check."""
    import math

    import torch
    from repro_torch.config import get_config
    from repro_torch.utils.tree import tree_leaves

    (whole, r, _, s_whole), (ck, rc, _, s_ck), (res, rr, _, s_res) = runs
    main = "batched_matmul" if get_config(spec.arch).is_cnn \
        else "flash_attention"
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(whole.sim._stacked))
    out = {"phase": phase, "arch": spec.arch, "n_clients": spec.n_clients,
           "rounds": spec.rounds, "scenario": spec.scenario,
           "seconds": s_whole, "seconds_per_round": s_whole / spec.rounds,
           "policy_seconds": info["policy_seconds"],
           "checkpointed_seconds": s_ck,
           "resumed_seconds": s_res,
           "resumed_rounds": spec.rounds - every,
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
        (info["launches"][main] > 0, f"{main} never launched"),
        (info["launches"]["clip_sgd"] == spec.rounds * updates_a_round,
         f"{info['launches']['clip_sgd']} update launches, not "
         f"{updates_a_round} a round"),
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
    """``spec`` on the card and on the CPU from the same weights (a CNN's
    drawn once; a token model's seeded init is drawn on the host, the same
    for both devices): the two (session, result, recorded plans) pairs."""
    import torch
    from repro_torch.api import Session
    from repro_torch.config import get_config
    from repro_torch.convert import units_to_numpy
    from repro_torch.models import build_model

    cfg = get_config(spec.arch)
    init = units_to_numpy(build_model(cfg).init(
        torch.Generator().manual_seed(0))) if cfg.is_cnn else None
    out = []
    for dev in ("cuda", "cpu"):
        sess = Session(spec, device=dev, init_units=init)
        recorded = record(sess)
        out.append((sess, sess.run(), recorded))
    return out


def _cross_errors(ra, rb, sa, sb):
    """(max loss/accuracy difference, max parameter difference)."""
    import numpy as np

    loss = max(abs(a - b) for a, b in zip(
        ra.train_loss + ra.test_loss + ra.test_acc,
        rb.train_loss + rb.test_loss + rb.test_acc))
    param = max(float(np.max(np.abs(a - b))) for a, b in zip(
        _host_f32(_clients(sa)), _host_f32(_clients(sb))))
    return loss, param


def _clients(sess) -> list:
    """A session's client parameters as ``[N, ...]``-stacked units, on
    every engine (the legacy engine's client lists stacked)."""
    from repro_torch.core import split as SP

    if sess.sim.vectorized:
        return sess.sim._stacked
    return SP.stack_unit_trees(sess.sim.client_units)


@contextlib.contextmanager
def _draw_log():
    """While the block runs, every index draw of the host sampling
    routine (`data.pipeline.draw_indices`, which `ClientSampler.sample`
    and `DeviceClientStore.segment_indices` both call, in round and
    client order) goes to the list the latest ``start()`` returned."""
    from repro_torch.data import pipeline as P

    draw = P.draw_indices
    log = [[]]

    def recording(rng, pool, batch):
        take = draw(rng, pool, batch)
        log[0].append(take.copy())
        return take

    def start():
        log[0] = []
        return log[0]

    P.draw_indices = recording
    try:
        yield start
    finally:
        P.draw_indices = draw


def _host_f32(tree) -> list:
    """Host fp32 copies of a tree's leaves (numpy holds no bf16)."""
    from repro_torch.utils.tree import tree_leaves

    return [t.detach().float().cpu().numpy() for t in tree_leaves(tree)]


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

    def gate(name, card, cpu, extra=(), tol=CROSS_TOL, params=True):
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
        if loss > tol or (params and param > tol):
            bad.append(f"{name}: losses {loss} / parameters {param} over "
                       f"{tol}")

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

    # the reference's resume spec (tests/test_resume.py): smollm-tiny at
    # its registered bf16, HASFL with the estimate, churn-heavy, deadline
    # faults; losses held at 1e-3, parameters recorded
    spec = ExperimentSpec(
        arch="smollm-tiny", n_clients=4, partition="iid", n_train=160,
        n_test=40, seq_len=32, seed=0, policy="hasfl", estimate=True,
        scenario="churn-heavy", scenario_seed=7, rounds=4, eval_every=2,
        fault_mode="deadline", deadline_factor=2.0,
        sfl=SFLConfig(lr=0.05, agg_interval=2))
    card, cpu = _cross_pair(spec, both)
    gate("resume_spec", card, cpu, tol=1e-3, params=False)
    emit(out)
    detail["dynamic_cross"] = out
    check(not bad, "dynamic_cross: " + "; ".join(bad))
    return out


# token_families: every other token family that trains, `reduced` (2
# layers, d <= 128, vocab <= 512; MoE at 4 experts) in fp32, through each
# entry point of this slice on the card
TOKEN_FAMILIES = ["qwen3-1.7b", "glm4-9b", "phi3-mini-3.8b",
                  "llama4-maverick-400b-a17b", "jamba-v0.1-52b",
                  "internvl2-1b"]


def phase_token_families(detail):
    """Each family of `TOKEN_FAMILIES` on the card through the normal
    entry points at a reduced size (N=4, S=8, 2 rounds, I=1): a two-cell
    `run_grid` of crossed seeds, each cell bitwise its own run; mesh mode
    on 2 edge servers without and with a cohort bank (finite, the bank
    rotating once); a ``straggler-bursts`` cell with deadline faults and a
    traffic cell (`TRAFFIC_CROSS`), each checkpointed every round and
    resumed from round 1 bitwise its uninterrupted run.  Kernels 4 and 5
    launched in each family's runs.  The process group of the mesh runs
    is destroyed at the end."""
    import math
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.api import ExperimentSpec, Session, TrafficSpec, run_grid
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops
    from repro_torch.mesh import MeshSpec

    t_phase = time.perf_counter()
    out = {"phase": "token_families"}
    bad = []
    for arch in TOKEN_FAMILIES:
        t0 = time.perf_counter()
        cfg = _register_cut(arch, f"{arch}-families", "float32")
        base = ExperimentSpec(
            arch=cfg.arch_id, n_clients=4, partition="iid", n_train=120,
            n_test=8, seq_len=8, policy="hasfl", estimate=False, rounds=2,
            eval_every=1, update_impl="kernel",
            sfl=SFLConfig(lr=0.05, agg_interval=1))
        ops.reset_launch_counts()
        specs = [base.replace(policy="fixed(b=4,cut=1)", seed=s)
                 for s in (0, 1)]
        alone = [Session(s) for s in specs]
        seq = [s.run() for s in alone]
        folded = [Session(s) for s in specs]
        grid = [_same_result(r, q) and _same_params(a, b) for r, q, a, b
                in zip(run_grid(folded), seq, folded, alone)]
        del alone, folded
        mesh = []
        for pop in (None, 16):
            sess = Session(base.replace(mesh=MeshSpec(
                devices=1, n_edges=2, population=pop)))
            res = sess.run()
            mesh.append(all(math.isfinite(v) for v in
                            res.train_loss + res.test_loss)
                        and (pop is None or sess.sim._bank.rotations == 1))
            del sess
        dist.destroy_process_group()
        resumed = {}
        cells = {"scenario": base.replace(
                     scenario="straggler-bursts", scenario_seed=3,
                     fault_mode="deadline", deadline_factor=1.5),
                 "traffic": base.replace(
                     policy="fixed", traffic=TrafficSpec(**TRAFFIC_CROSS))}
        (ROOT / "build").mkdir(exist_ok=True)
        for kind, spec in cells.items():
            ckpt = tempfile.mkdtemp(prefix=f"{kind}_", dir=ROOT / "build")
            try:
                whole = Session(spec)
                r = whole.run()
                ck = spec.replace(checkpoint_every=1, checkpoint_dir=ckpt)
                Session(ck).run()
                again = Session.resume(ck, step=1)
                resumed[kind] = _same_result(again.run(), r) \
                    and _same_params(again, whole)
            finally:
                shutil.rmtree(ckpt, ignore_errors=True)
        launches = ops.launch_counts()
        row = dict(grid_bitwise=grid, mesh_ok=mesh, resumed_bitwise=resumed,
                   launches={k: launches[k] for k in (
                       "flash_attention", "flash_attention_bwd", "rmsnorm",
                       "rmsnorm_bwd", "clip_sgd", "clip_sgd_ext")},
                   seconds=time.perf_counter() - t0)
        out[arch] = row
        if not (all(grid) and all(mesh) and all(resumed.values())):
            bad.append(f"{arch}: {row}")
        if not all(launches[k] > 0 for k in (
                "flash_attention", "flash_attention_bwd", "rmsnorm",
                "rmsnorm_bwd", "clip_sgd", "clip_sgd_ext")):
            bad.append(f"{arch}: a kernel never launched ({launches})")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    detail["token_families"] = out
    check(not bad, "token_families: " + "; ".join(bad))
    return out

def _excess(xs, ys, rtol: float, atol: float):
    """max(|x − y| − (atol + rtol·|y|)) over two lists of tensors on the
    card (≤ 0: within the bars), and max|x − y|."""
    worst = diff = -math.inf
    for x, y in zip(xs, ys):
        d = (x.float() - y.float()).abs()
        worst = max(worst, float((d - (atol + rtol * y.float().abs()))
                                 .max()))
        diff = max(diff, float(d.max()))
    return worst, diff


def phase_engines(detail):
    """The three round engines on VGG-16 at full width (`ENGINES`: N=8,
    4096 images, 6 rounds, evals every 2, I=3) from the same initial
    units, under each of `ENGINES_POLICIES`; counters zeroed just before
    each run and read just after.  Decisions, clocks and every draw of
    the host sampler bitwise equal across the engines; legacy against
    vectorized within the reference's seed-loop bars (`SEED_LOOP`,
    accuracy `SEED_LOOP_ACC`); vectorized against scan recorded as
    bitwise or not, and held bitwise where every ``b_max`` was a power of
    two (the scan engine then pads no wider).  Launches: the stacked
    engines' update once a round, legacy's never, the GEMM > 0 on all
    and the external-mean update on none.  Seconds a round (with and
    without the policy calls), peak memory."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig, get_config
    from repro_torch.convert import units_to_numpy
    from repro_torch.core.sfl import pow2_bucket
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    init = units_to_numpy(build_model(get_config(ENGINES["arch"])).init(
        torch.Generator().manual_seed(0)))
    rounds = ENGINES["rounds"]
    out = {"phase": "engines", **ENGINES, "agg_interval": ENGINES_AGG,
           "policies": {}}
    bad = []
    with _draw_log() as start:
        for pname, pol in ENGINES_POLICIES.items():
            runs = {}
            for engine in ("scan", "vectorized", "legacy"):
                spec = ExperimentSpec(
                    **ENGINES, **pol, engine=engine,
                    sfl=SFLConfig(lr=0.05, agg_interval=ENGINES_AGG))
                sess = Session(spec, init_units=init)
                policy_s = _timed_policies([sess])
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                at_start = torch.cuda.memory_allocated()
                draws = start()
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = sess.run()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated()
                runs[engine] = dict(
                    res=res, draws=draws, launches=launches,
                    # host copies: the next engine's peak holds none
                    leaves=[t.detach().cpu()
                            for t in tree_leaves(_clients(sess))],
                    info=dict(
                        seconds=seconds, seconds_per_round=seconds / rounds,
                        policy_seconds=policy_s[0],
                        round_seconds_without_policy=(
                            seconds - policy_s[0]) / rounds,
                        max_memory_allocated=peak,
                        memory_allocated_at_start=at_start,
                        launches=launches,
                        gemm_launches_per_round=(
                            launches["batched_matmul"] / rounds),
                        train_loss=res.train_loss, test_loss=res.test_loss,
                        test_acc=res.test_acc))
                del sess
            scan, vec, leg = (runs[e] for e in ("scan", "vectorized",
                                                "legacy"))
            res = {e: r["res"] for e, r in runs.items()}
            b_max = [int(np.max(b)) for b in res["scan"].b_history]
            pow2 = all(pow2_bucket(b) == b for b in b_max)
            loss_excess, loss_diff = _excess(
                [torch.tensor(leg["res"].train_loss + leg["res"].test_loss)],
                [torch.tensor(vec["res"].train_loss + vec["res"].test_loss)],
                **SEED_LOOP)
            acc_diff = max(abs(a - b) for a, b in zip(
                leg["res"].test_acc, vec["res"].test_acc))
            param_excess, param_diff = _excess(leg["leaves"], vec["leaves"],
                                               **SEED_LOOP)
            vec_scan_bitwise = _same_result(vec["res"], scan["res"]) and all(
                torch.equal(a, b) for a, b in zip(vec["leaves"],
                                                  scan["leaves"]))
            vec_scan_diff = max(float((a - b).abs().max()) for a, b in zip(
                vec["leaves"], scan["leaves"]))
            rec = {
                "b_history": [list(map(int, b)) for b in res["scan"].b_history],
                "cut_history": [list(map(int, c))
                                for c in res["scan"].cut_history],
                "b_max": b_max, "b_max_all_pow2": pow2,
                "clock": res["scan"].clock,
                "legacy_vs_vectorized": dict(
                    loss_max_abs_diff=loss_diff, loss_excess=loss_excess,
                    acc_max_abs_diff=acc_diff,
                    param_max_abs_diff=param_diff,
                    param_excess=param_excess),
                "vectorized_vs_scan_bitwise": vec_scan_bitwise,
                "vectorized_vs_scan_param_max_abs_diff": vec_scan_diff,
                "legacy_gemm_launches_per_vectorized": (
                    leg["launches"]["batched_matmul"]
                    / max(1, vec["launches"]["batched_matmul"])),
                **{e: r["info"] for e, r in runs.items()}}
            out["policies"][pname] = rec
            for e in ("vectorized", "legacy"):
                r = res[e]
                if not (_same(r.b_history, res["scan"].b_history)
                        and _same(r.cut_history, res["scan"].cut_history)
                        and r.clock == res["scan"].clock
                        and r.rounds == res["scan"].rounds):
                    bad.append(f"{pname}: {e}'s decisions or clock differ "
                               "from scan's")
                if not _same(runs[e]["draws"], scan["draws"]) \
                        or len(scan["draws"]) != rounds * ENGINES["n_clients"]:
                    bad.append(f"{pname}: {e}'s sampler draws differ")
            if not all(math.isfinite(v) for r in res.values()
                       for v in r.train_loss + r.test_loss + r.clock):
                bad.append(f"{pname}: a non-finite loss or clock")
            if loss_excess > 0 or param_excess > 0 \
                    or acc_diff > SEED_LOOP_ACC:
                bad.append(f"{pname}: legacy and vectorized part by more "
                           f"than the seed-loop bars ({rec['legacy_vs_vectorized']})")
            if pow2 and not vec_scan_bitwise:
                bad.append(f"{pname}: vectorized is not scan bitwise at "
                           f"power-of-two b_max {b_max}")
            for e, r in runs.items():
                n = r["launches"]
                want = 0 if e == "legacy" else rounds
                if n["batched_matmul"] == 0 or n["clip_sgd"] != want \
                        or n["clip_sgd_ext"] != 0:
                    bad.append(f"{pname}: {e}'s launches {n}")
            del runs, scan, vec, leg
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    detail["engines"] = out
    check(not bad, "engines: " + "; ".join(bad))
    return out


def phase_engines_cross(detail):
    """The vectorized and legacy engines on the card against the CPU from
    the same weights: vgg9 at ``cross_device``'s sizes (N=4, 4 rounds) and
    a fp32 smollm-tiny cell (N=4, S=16, 4 rounds).  Decisions, clocks and
    the sampler's draws bitwise; losses, accuracies and every client's
    parameters within `CROSS_TOL`."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.config import SFLConfig

    t_phase = time.perf_counter()
    _register_cut("smollm-tiny", "smollm-tiny-engines")
    specs = {
        "vgg9": dict(arch="vgg9-cifar-small", n_clients=4, partition="iid",
                     n_train=400, n_test=100),
        "smollm": dict(arch="smollm-tiny-engines", n_clients=4,
                       partition="iid", n_train=128, n_test=16, seq_len=16)}
    out = {"phase": "engines_cross", "cells": {}}
    bad = []
    with _draw_log() as start:
        for name, kw in specs.items():
            for engine in ("vectorized", "legacy"):
                spec = ExperimentSpec(
                    **kw, rounds=4, eval_every=2, policy="hasfl",
                    estimate=False, engine=engine,
                    sfl=SFLConfig(lr=0.05, agg_interval=2))
                (sg, rg, dg), (sc, rc, dc) = _cross_pair(
                    spec, lambda sess: start())
                loss_err, param_err = _cross_errors(rg, rc, sg, sc)
                same = (_same(rg.b_history, rc.b_history)
                        and _same(rg.cut_history, rc.cut_history)
                        and rg.clock == rc.clock and _same(dg, dc)
                        and len(dg) == 4 * spec.n_clients)
                out["cells"][f"{name}_{engine}"] = dict(
                    decisions_clock_draws_bitwise=same,
                    loss_acc_max_err=loss_err, param_max_err=param_err,
                    b_history=[list(map(int, b)) for b in rg.b_history])
                if not same:
                    bad.append(f"{name} {engine}: decisions, clock or draws")
                if loss_err > CROSS_TOL or param_err > CROSS_TOL:
                    bad.append(f"{name} {engine}: {loss_err}, {param_err}")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    detail["engines_cross"] = out
    check(not bad, "engines_cross: " + "; ".join(bad))
    return out


def phase_cli(detail):
    """`repro_torch.launch.train.main` in process, edge mode on the card
    (`CLI_ARGS`, a CSV under build/), on the default scan engine and with
    ``--engine vectorized`` and ``--engine legacy``: one CSV row per eval,
    the ``.spec.json`` beside it reloading equal to the spec, and the
    numbers bitwise equal to `Session(spec).run()` on the card."""
    import csv
    import shutil
    import tempfile

    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.launch import train

    (ROOT / "build").mkdir(exist_ok=True)
    out = {"phase": "cli", "argv": CLI_ARGS, "engines": {}}
    bad = []
    for engine in ("scan", "vectorized", "legacy"):
        argv = CLI_ARGS + ([] if engine == "scan" else ["--engine", engine])
        d = tempfile.mkdtemp(prefix="cli_", dir=ROOT / "build")
        try:
            path = str(Path(d) / "edge.csv")
            t0 = time.perf_counter()
            spec, res = train.main(argv + ["--csv", path])
            seconds = time.perf_counter() - t0
            with open(path) as f:
                rows = list(csv.DictReader(f))
            reloaded = ExperimentSpec.load(path + ".spec.json")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        alone = Session(spec).run()
        rec = {"seconds": seconds, "engine": spec.engine,
               "csv_rows": len(rows), "evals": len(res.rounds),
               "spec_reloads_equal": reloaded == spec,
               "csv_matches": [float(r["clock"]) for r in rows] == res.clock
               and [float(r["train_loss"]) for r in rows] == res.train_loss,
               "bitwise_session_run": _same_result(res, alone),
               "test_acc": res.test_acc, "clock": res.clock}
        out["engines"][engine] = rec
        if not (rec["engine"] == engine and rec["csv_rows"] == rec["evals"]
                == spec.rounds // spec.eval_every):
            bad.append(f"{engine}: {rec['csv_rows']} CSV rows for "
                       f"{rec['evals']} evals on {rec['engine']}")
        for key in ("spec_reloads_equal", "csv_matches",
                    "bitwise_session_run"):
            if not rec[key]:
                bad.append(f"{engine}: {key}")
    clocks = [r["clock"] for r in out["engines"].values()]
    if any(c != clocks[0] for c in clocks):
        bad.append("the engines' clocks differ")
    emit(out)
    detail["cli"] = out
    check(not bad, "cli: " + "; ".join(bad))
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
    for kernel in ("batched_matmul", "clip_sgd", "clip_sgd_ext",
                   "flash_attention_bwd", "rmsnorm_bwd"):
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
        if arch == "qwen3-1.7b":
            res["decode_cases"] = _serve_cross_decode_cases(
                model, on_card, on_cpu, tol)
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
                if norm == "plain":   # serving passes no cell size
                    ops.rmsnorm = lambda x, scale, eps=1e-5, cell_size=None: \
                        RN.rmsnorm_plain(x, scale, eps)
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
        for case, r in res.get("decode_cases", {}).items():
            check(r["over_bar"] <= 0 and r["ids_equal"],
                  f"serve_cross {arch} {case}: logits differ by "
                  f"{max(r['prefill_err'], r['decode_err'])}, ids equal "
                  f"{r['ids_equal']}")
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


# ---------------------------------------------------------------------------
# Training: kernels 4 and 5 backward, kernel 2 on bf16 leaves, and the two
# training paths of the dense token models
# ---------------------------------------------------------------------------

TRAIN_LM = dict(arch="smollm-135m", n_clients=8, partition="iid",
                seq_len=128, n_train=4096, n_test=512, rounds=12,
                eval_every=4, policy="hasfl", estimate=True, seed=0)
# the step size of train_lm: at the CNN phases' 0.05 the clipped steps
# moved smollm's test loss by 4e-5 in 12 rounds on the H100 (PERF.md); at
# 1.0 it visibly learns
TRAIN_LM_LR = 1.0
SPMD = dict(arch="qwen3-1.7b", n_clients=2, cut_reps=1, batch=4, seq=512,
            steps=6, lr=3e-4, agg_interval=3)
SPMD_CLI = ["--mode", "spmd", "--steps", "4", "--seq", "128", "--layers",
            "4", "--d-model", "256", "--clients", "2", "--batch", "2",
            "--eval-every", "0"]
BWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


@contextlib.contextmanager
def _witness(clip_calls=()):
    """While a training path runs: the signature of every backward that
    `FlashAttentionFn`, `RMSNormFn` and `MLSTMScanFn` run (what they hand
    kernels 4's, 5's and 6's backward), counted, and the inputs of the update op's calls
    numbered in ``clip_calls`` (from 1; its leaves copied before their
    in-place update), under ``seen["clip"][number]``, so that
    `phase_kernels_train` checks and times the kernels at what the path
    ran.  Each wrapper runs what it wraps as the path would; the launch
    counters stay the kernels' own."""
    from collections import Counter
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import rmsnorm as RN

    seen = {"flash": Counter(), "norm": Counter(), "mlstm": Counter(),
            "clip": {}, "clip_calls": 0}
    fns = {fn: (fn.forward, fn.backward)
           for fn in (FA.FlashAttentionFn, RN.RMSNormFn, MS.MLSTMScanFn)}
    cs = CS.clip_sgd_leaves_kernel

    # the forward notes the signature on ctx (the backward must not
    # unpack the saved tensors a second time: remat allows one unpack)
    def flash_fwd(ctx, q, k, v, causal, window):
        b, sq, hq, hd = q.shape
        ctx.witness = ("flash", (b, sq, k.shape[1], hq, k.shape[2], hd,
                                 bool(causal), int(window), _dtype_name(q)))
        return fns[FA.FlashAttentionFn][0](ctx, q, k, v, causal, window)

    def norm_fwd(ctx, x, scale, eps, cells=1):
        groups = scale.shape[0] if scale.dim() == 2 else 1
        ctx.witness = ("norm", (tuple(x.shape), groups, _dtype_name(x),
                                float(eps)))
        return fns[RN.RMSNormFn][0](ctx, x, scale, eps, cells)

    def mlstm_fwd(ctx, q, k, v, i_gate, f_gate):
        ctx.witness = ("mlstm", (*q.shape, _dtype_name(q)))
        return fns[MS.MLSTMScanFn][0](ctx, q, k, v, i_gate, f_gate)

    def backward(fn):
        def bwd(ctx, grad):
            kind, sig = ctx.witness
            seen[kind][sig] += 1
            return fns[fn][1](ctx, grad)
        return bwd

    def clip(ps, gs, scale, keep_specs, participation=None, **kw):
        seen["clip_calls"] += 1
        if seen["clip_calls"] in clip_calls:
            seen["clip"][seen["clip_calls"]] = dict(ps=[p.clone() for p in ps], gs=list(gs),
                                scale=scale, keep_specs=keep_specs,
                                participation=participation, kw=kw)
        return cs(ps, gs, scale, keep_specs, participation, **kw)

    for fn, fwd in ((FA.FlashAttentionFn, flash_fwd),
                    (RN.RMSNormFn, norm_fwd), (MS.MLSTMScanFn, mlstm_fwd)):
        fn.forward = staticmethod(fwd)
        fn.backward = staticmethod(backward(fn))
    CS.clip_sgd_leaves_kernel = clip
    try:
        yield seen
    finally:
        for fn, (fwd, bwd) in fns.items():
            fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
        CS.clip_sgd_leaves_kernel = cs


def _bwd_compare(got, want, dtype, what, to_max: bool = False):
    """Max |got - want|; the bar is 2e-5·(1+|plain|) at fp32 and
    3e-2·max|plain| at bf16; ``to_max`` holds fp32 to 2e-5·max|plain|
    too (a gradient whose sums cancel terms up to its largest value)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if dtype == "float32" and not to_max:
        bar = BWD_TOL[dtype] * (1 + want.float().abs())
    else:
        bar = BWD_TOL[dtype] * want.float().abs().max()
    check(bool((diff <= bar).all()),
          f"{what}: max|kernel-plain| {err} over the bar")
    return err


def _flash_work(sig) -> int:
    b, sq, sk, hq = sig[:4]
    return b * sq * sk * hq


def _norm_work(sig) -> int:
    return math.prod(sig[0])


def _path_cases(runs, key, work):
    """[(signature, [(run, layers, launches at it, heaviest)] for each run
    that recorded it)] over every signature the runs recorded under
    ``key``; a run's heaviest signature carries the most of its work
    (launches × ``work(signature)``)."""
    cases = {}
    for run, (seen, layers) in runs.items():
        if not seen[key]:
            continue
        top = max(seen[key], key=lambda sig: seen[key][sig] * work(sig))
        for sig, count in seen[key].items():
            cases.setdefault(sig, []).append((run, layers, count,
                                              sig == top))
    return list(cases.items())


def _flash_bwd_checks(detail, runs):
    """Kernel 4's training forward (lse) and backward against their plain
    versions at the reference's cases and at every shape the training
    paths ran (``runs``: run -> (witness, layers)), each bitwise
    repeatable; each recorded shape timed as one backward's calls (a call
    a layer; eager ``ms`` and graph-replayed ``device_ms``) beside the
    bound, the plain version and ``F.scaled_dot_product_attention``'s
    forward + backward minus its forward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [(c, []) for c in FLASH_CASES] + _path_cases(runs, "flash",
                                                         _flash_work)
    worst, rows = 0.0, {}
    for case, roles in cases:
        b, sq, sk, hq, hkv, hd, causal, window, dt = case
        q = torch.randn((b, sq, hq, hd), device="cuda", generator=gen).to(
            _dtype(dt))
        k, v = (torch.randn((b, sk, hkv, hd), device="cuda",
                            generator=gen).to(_dtype(dt)) for _ in range(2))
        do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        o, lse = FA.flash_attention_kernel(q, k, v, causal=causal,
                                           window=window, lse=True)
        _, lse_plain = FA.flash_attention_plain(q, k, v, causal=causal,
                                                window=window, lse=True)
        _compare(lse, lse_plain, 1e-4, f"flash lse {case}")
        kw = dict(causal=causal, window=window)
        got = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip("qkv", got, want):
            worst = max(worst, _bwd_compare(g, w, dt,
                                            f"flash bwd d{name} {case}"))
        again = FA.flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"flash bwd {case}: not bitwise repeatable")
        pairs = _flash_pairs(sq, sk, causal, window, sk)
        flops = 10.0 * b * hq * hd * pairs
        nbytes = q.element_size() * (4.0 * b * sq * hq * hd
                                     + 4.0 * b * sk * hkv * hd) \
            + 8.0 * b * hq * sq
        peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_FP32_FLOPS
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True).backward(dot)

        for run, calls, count, heaviest in roles:
            rows.setdefault(run, []).append(dict(
                shape=list(case), calls=calls, launches_at_shape=count,
                heaviest=heaviest,
                max_abs_err=max(float((g.float() - w.float()).abs().max())
                                for g, w in zip(got, want)),
                ms=time_ms(_span(lambda: FA.flash_attention_bwd_kernel(
                    q, k, v, o, lse, do, **kw), calls)),
                # the same calls replayed from a CUDA graph: the device's
                # time alone (``ms`` carries the wrapper's host path too)
                device_ms=graph_ms(lambda: FA.flash_attention_bwd_kernel(
                    q, k, v, o, lse, do, **kw), calls),
                fwd_lse_ms=time_ms(_span(lambda: FA.flash_attention_kernel(
                    q, k, v, lse=True, **kw), calls)),
                plain_ms=time_ms(_span(lambda: FA.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, **kw), calls)),
                library_ms=time_ms(_span(sdpa_fwd_bwd, calls))
                - time_ms(_span(sdpa_fwd, calls)),
                bound_ms=calls * _bound(flops, nbytes, peak),
                bound_by="operations" if flops / peak >= nbytes / PEAK_BYTES
                else "bytes", flops=calls * flops, bytes=calls * nbytes))
        del q, k, v, o, lse, do, got, want, again, qt, kt, vt
    detail["flash_attention_bwd"] = rows
    return rows, worst


def _rmsnorm_bwd_checks(detail, runs):
    """Kernel 5's grouped-scale forward and its backward against their
    plain versions at the reference's cases and at every (shape, scale
    groups) the training paths ran, the backward bitwise repeatable; each
    recorded shape timed as one call (eager ``ms``, graph-replayed
    ``device_ms``, the wrapper's ``host_ms`` without a sync) beside the
    bound, the plain version and ``F.rms_norm``'s forward + backward
    minus its forward (one [d] weight: the library takes no grouped
    scale, so at a grouped shape it is the ungrouped norm's time), with
    the kernel launches of a call as the kernel's library counts them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(32)
    cases = [((shape, 1, dt, 1e-5), []) for shape, dt in RMSNORM_CASES] \
        + _path_cases(runs, "norm", _norm_work)
    worst, rows = 0.0, {}
    for (shape, groups, dt, eps), roles in cases:
        x = torch.randn(shape, device="cuda", generator=gen).to(_dtype(dt))
        dy = torch.randn(shape, device="cuda", generator=gen).to(x.dtype)
        d = shape[-1]
        sc = torch.rand((groups, d) if groups > 1 else (d,), device="cuda",
                        generator=gen)
        _compare(RN.rmsnorm_kernel(x, sc, eps), RN.rmsnorm_plain(x, sc, eps),
                 RMSNORM_TOL, f"rmsnorm {shape} {dt} groups {groups}")
        dx, ds = RN.rmsnorm_bwd_kernel(x, sc, dy, eps)
        pdx, pds = RN.rmsnorm_bwd_plain(x, sc, dy, eps)
        torch.cuda.synchronize()
        worst = max(worst, _compare(
            dx, pdx, 2e-5 if dt == "float32" else RMSNORM_TOL,
            f"rmsnorm bwd dx {shape} {dt}"))
        worst = max(worst, _compare(ds, pds, 1e-4,
                                    f"rmsnorm bwd dscale {shape} {dt}"))
        dx2, ds2 = RN.rmsnorm_bwd_kernel(x, sc, dy, eps)
        check(torch.equal(dx, dx2) and torch.equal(ds, ds2),
              f"rmsnorm bwd {shape}: not bitwise repeatable")
        rows_ = x.numel() // d
        nbytes = 3.0 * rows_ * d * x.element_size() + 8.0 * sc.numel()
        flops = 8.0 * rows_ * d
        xl = x.detach().requires_grad_()
        wl = sc.reshape(-1, d)[0].to(x.dtype).detach().requires_grad_()

        def lib_fwd():
            with torch.no_grad():
                F.rms_norm(xl, (d,), wl, eps)

        def lib_fwd_bwd():
            F.rms_norm(xl, (d,), wl, eps).backward(dy)

        def kernel():
            RN.rmsnorm_bwd_kernel(x, sc, dy, eps)

        for run, _, count, heaviest in roles:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                kernel()
            host_ms = (time.perf_counter() - t0) / 5 * 1e3
            torch.cuda.synchronize()
            launches = RN.bwd_kernel_launches()
            kernel()
            launches = RN.bwd_kernel_launches() - launches
            check(launches == RN.BWD_LAUNCHES,
                  f"rmsnorm bwd {shape}: {launches} launches a call")
            rows.setdefault(run, []).append(dict(
                shape=list(shape), groups=groups, launches_at_shape=count,
                heaviest=heaviest, launches_a_call=launches,
                max_abs_err=float((dx.float() - pdx.float()).abs().max()),
                ms=time_ms(kernel), device_ms=graph_ms(kernel),
                host_ms=host_ms,
                plain_ms=time_ms(lambda: RN.rmsnorm_bwd_plain(x, sc, dy,
                                                              eps)),
                library_ms=time_ms(lib_fwd_bwd) - time_ms(lib_fwd),
                bound_ms=_bound(flops, nbytes, PEAK_FP32_FLOPS),
                bound_by="bytes", bytes=nbytes))
    detail["rmsnorm_bwd"] = rows
    return rows, worst


def _mlstm_work(sig) -> int:
    b, s, h = sig[:3]
    return b * s * s * h


def _mlstm_bwd_checks(detail, runs):
    """Kernel 6's backward against its plain version (the same formulas
    in fp64, S² memory) at the reference's cases, at extreme gates at hd
    512 on each path and fp32 at `serve_cross`'s shape
    (`MLSTM_BWD_EDGES`), and at every shape the training
    paths ran (``runs``: run -> (witness, scans a step)): dq, dk, dv, di,
    df within 2e-5·(1+|plain|) at fp32 and 3e-2·max|plain| at bf16 (at
    extreme gates fp32 within 2e-5·max|plain|: a row's den cancels, and
    dq, dk sum terms up to ~5e4 into results near 1), each
    call on its path, bitwise repeatable, from a forward whose h equals
    serving's bitwise; each recorded shape timed as one step's calls
    beside its bound (5 products of hd per causal pair; q, k, v, h, dh
    read and dq, dk, dv written once, the gates, a, m, di, df in fp32) and
    the plain version (eager ``ms`` and graph-replayed ``device_ms``), with
    the kernel launches of a call as the kernel's library counts them.  No
    one PyTorch call computes this function."""
    import torch
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.timing import graph_ms

    gen = torch.Generator(device="cuda").manual_seed(33)
    cases = [((*c, "normal"), []) for c in MLSTM_CASES] \
        + [(c, []) for c in MLSTM_BWD_EDGES] \
        + [((*sig, "normal"), roles)
           for sig, roles in _path_cases(runs, "mlstm", _mlstm_work)]
    worst, rows = 0.0, {}
    for case, roles in cases:
        b, s, h, hd, dt, gates = case
        q, k, v = (torch.randn((b, s, h, hd), device="cuda",
                               generator=gen).to(_dtype(dt))
                   for _ in range(3))
        ig, fg = _mlstm_gates(gen, (b, s, h), gates)
        hh, a, m = MS.mlstm_scan_kernel(q, k, v, ig, fg, stats=True)
        check(torch.equal(hh, MS.mlstm_scan_kernel(q, k, v, ig, fg)),
              f"mlstm bwd {case}: h with and without a_t differ")
        dh = torch.randn(hh.shape, device="cuda", generator=gen).to(hh.dtype)
        ins = (q, k, v, ig, fg, hh, a, m, dh)
        path = "tc" if dt == "bfloat16" else "fp32"
        before = MS.bwd_path_launches()
        got = MS.mlstm_scan_bwd_kernel(*ins)
        after = MS.bwd_path_launches()
        want = MS.mlstm_scan_bwd_plain(*ins)
        torch.cuda.synchronize()
        check(after[path] == before[path] + 1,
              f"mlstm bwd {case}: not launched on the {path} path")
        err = 0.0
        for name, g, w in zip(("q", "k", "v", "i_gate", "f_gate"), got,
                              want):
            check(bool(torch.isfinite(g).all()),
                  f"mlstm bwd d{name} {case}: not finite")
            err = max(err, _bwd_compare(g, w, dt,
                                        f"mlstm bwd d{name} {case}",
                                        to_max=gates == "extreme"))
        worst = max(worst, err)
        again = MS.mlstm_scan_bwd_kernel(*ins)
        check(all(torch.equal(g, x) for g, x in zip(got, again)),
              f"mlstm bwd {case}: not bitwise repeatable")
        pairs = s * (s + 1) / 2
        flops = 10.0 * hd * pairs * b * h
        nbytes = 8.0 * b * s * h * hd * q.element_size() + 24.0 * b * s * h
        peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_FP32_FLOPS
        for run, calls, count, heaviest in roles:
            launches = MS.bwd_kernel_launches()
            MS.mlstm_scan_bwd_kernel(*ins)
            launches = MS.bwd_kernel_launches() - launches
            check(launches == MS.BWD_LAUNCHES[path],
                  f"mlstm bwd {case}: {launches} launches a call")
            rows.setdefault(run, []).append(dict(
                shape=list(case[:5]), calls=calls, launches_at_shape=count,
                heaviest=heaviest, path=path, max_abs_err=err,
                launches_a_call=launches,
                ms=time_ms(_span(lambda: MS.mlstm_scan_bwd_kernel(*ins),
                                 calls)),
                device_ms=graph_ms(lambda: MS.mlstm_scan_bwd_kernel(*ins),
                                   calls),
                fwd_stats_ms=time_ms(_span(lambda: MS.mlstm_scan_kernel(
                    q, k, v, ig, fg, stats=True), calls)),
                plain_ms=time_ms(_span(lambda: MS.mlstm_scan_bwd_plain(
                    *ins), calls), reps=1),
                library_ms=None, bound_ms=calls * _bound(flops, nbytes, peak),
                bound_by="operations" if flops / peak >= nbytes / PEAK_BYTES
                else "bytes", flops=calls * flops, bytes=calls * nbytes,
                workspace_bytes=MS.bwd_workspace_bytes(b, s, h)))
        del q, k, v, ig, fg, hh, a, m, dh, ins, got, want, again
    detail["mlstm_scan_bwd"] = rows
    return rows, worst


def _clip_round_checks(rec):
    """Kernel 2 on `train_lm`'s last round as the path ran it: the
    session's own leaves (bf16 weights beside fp32 ones) as they stood
    before that round's in-place update, its gradients, clip factors and
    keep flags, in one call on copies (⌈leaves/64⌉ launches), against its
    plain version in fp32 rounded once to each leaf's type (the kernel's
    arithmetic), leaf by leaf: bf16 within one bf16 ulp (2^-7 relative at
    most; the client mean's fp32 sum runs in another order, and a value
    at a rounding boundary may round to the neighbour), fp32 within
    `CLIP_TOL`.  The call timed on the copies (each span updating them
    again) beside its bytes bound and the plain version at the leaves'
    own types."""
    import torch
    from repro_torch.kernels import clip_sgd as CS

    check(rec is not None, "clip_sgd token round: the last round's call "
          "was not recorded")
    ps, gs, scale, keeps, part, kw = (rec[k] for k in (
        "ps", "gs", "scale", "keep_specs", "participation", "kw"))
    tables = -(-len(ps) // CS.CAPACITY)
    before = CS.clip_sgd_kernel.launches
    got = CS.clip_sgd_leaves_kernel([p.clone() for p in ps], gs, scale,
                                    keeps, part, **kw)
    torch.cuda.synchronize()
    check(CS.clip_sgd_kernel.launches == before + tables,
          f"clip_sgd token round: not {tables} launches for {len(ps)} "
          "leaves")
    err, nbytes = 0.0, 4.0 * scale.numel()
    for i, (p, g, out) in enumerate(zip(ps, gs, got)):
        want = CS.clip_sgd_leaves_plain(
            [p.float()], [g.float()], scale, [keeps[i]], part,
            **kw)[0].to(p.dtype).float()
        diff = (out.float() - want).abs()
        err = max(err, float(diff.max()))
        bar = 2 ** -7 * want.abs() + 1e-6 if p.dtype == torch.bfloat16 \
            else CLIP_TOL
        check(bool((diff <= bar).all()),
              f"clip_sgd token round leaf {i} {p.dtype} {tuple(p.shape)}: "
              f"{float(diff.max())} over the bar")
        nbytes += 3.0 * p.numel() * p.element_size()
    out = {"leaves": len(ps), "launches": tables,
           "bf16_leaves": sum(p.dtype == torch.bfloat16 for p in ps),
           "elements": sum(p.numel() for p in ps), "max_abs_err": err,
           "ms": time_ms(lambda: CS.clip_sgd_leaves_kernel(
               got, gs, scale, keeps, part, **kw)),
           "plain_ms": time_ms(lambda: CS.clip_sgd_leaves_plain(
               ps, gs, scale, keeps, part, **kw)),
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "bytes": nbytes}
    del got
    return out


def phase_kernels_train(detail, runs, clip):
    """The training kernels at what the training phases ran (``runs``:
    run -> (its `_witness`, the attention or mLSTM calls a backward makes
    at each of its shapes)): kernel 4's, 5's and 6's backward at the
    reference's cases and every recorded shape; ``clip`` is `_clip_round_checks` of
    `train_lm`'s last round, run as soon as `train_lm` ended (its copies
    would otherwise add 4.3 GB to `spmd`'s peak)."""
    t0 = time.perf_counter()
    flash, flash_err = _flash_bwd_checks(detail, runs)
    norm, norm_err = _rmsnorm_bwd_checks(detail, runs)
    mlstm, mlstm_err = _mlstm_bwd_checks(detail, runs)
    emit({"phase": "kernels_train", "seconds": time.perf_counter() - t0,
          "flash_attention_bwd": flash, "rmsnorm_bwd": norm,
          "mlstm_scan_bwd": mlstm, "clip_sgd_token_round": clip,
          "max_abs_err": {"flash_attention_bwd": flash_err,
                          "rmsnorm_bwd": norm_err,
                          "mlstm_scan_bwd": mlstm_err,
                          "clip_sgd_token_round": clip["max_abs_err"]}})
    detail["clip_sgd_token_round"] = clip
    return (dict(flash, max_abs_err=flash_err),
            dict(norm, max_abs_err=norm_err),
            dict(mlstm, max_abs_err=mlstm_err))


def _training_launches(launches, per: int) -> dict:
    keys = ("flash_attention", "flash_attention_bwd", "rmsnorm",
            "rmsnorm_bwd", "mlstm_scan", "mlstm_scan_bwd", "clip_sgd")
    return {k: launches[k] / per for k in keys}


def phase_train_lm(detail):
    """The simulator's token cell at full width (`TRAIN_LM`: smollm-135m,
    N=8, 12 rounds, HASFL with the online G²/σ² estimate); counters zeroed
    and read around the run.  Every flash attention and norm of the
    round's backward ran on its backward kernel; the test loss falls; no
    parameter leaf is left as it started (a leaf cut from the graph would
    be).  Memory: the policy's peak, what is resident before the run, the
    most allocated as a backward starts (`_at_backward`), the run's peak.  Returns the phase's numbers and the run's `_witness`."""
    import math
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops
    from repro_torch.utils.tree import tree_leaves

    spec = ExperimentSpec(**TRAIN_LM, sfl=SFLConfig(lr=TRAIN_LM_LR,
                                                     agg_interval=3))
    sess = Session(spec)
    start = [t.clone() for t in tree_leaves(sess.sim._stacked)]
    torch.cuda.reset_peak_memory_stats()
    spent = _timed_policies([sess])
    policy_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with _witness(clip_calls=(spec.rounds,)) as seen, \
            _at_backward() as at_bwd:
        t0 = time.perf_counter()
        res = sess.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    moved = [not torch.equal(a, b) for a, b in
             zip(start, tree_leaves(sess.sim._stacked))]
    out = {"phase": "train_lm", "arch": spec.arch,
           "n_clients": spec.n_clients, "seq_len": spec.seq_len,
           "rounds": spec.rounds, "seconds": seconds,
           "seconds_per_round": seconds / spec.rounds,
           "policy_share": spent[0] / seconds,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "resident_gb": resident, "policy_peak_gb": policy_peak,
           "at_backward_gb": max(at_bwd),
           "launches_per_round": _training_launches(launches, spec.rounds),
           "train_loss": res.train_loss, "test_loss": res.test_loss,
           "test_acc": res.test_acc, "clock": res.clock,
           "b_history": [list(map(int, b)) for b in res.b_history],
           "cut_history": [list(map(int, c)) for c in res.cut_history],
           "leaves": len(moved), "leaves_unchanged": moved.count(False),
           "launches": launches}
    emit({k: v for k, v in out.items() if k != "launches"})
    detail["train_lm"] = out
    check(all(math.isfinite(v) for v in res.train_loss + res.test_loss),
          "train_lm: non-finite loss")
    check(res.test_loss[-1] < res.test_loss[0],
          f"train_lm: the test loss did not fall {res.test_loss}")
    check(all(moved), f"train_lm: {moved.count(False)} parameter leaves "
          "never moved (no gradient reached them)")
    for k in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd", "clip_sgd"):
        check(launches[k] > 0, f"train_lm: {k} never launched")
    check(launches["clip_sgd_ext"] == 0 and launches["mlstm_scan"] == 0,
          "train_lm: a kernel off the path launched")
    check(seen["clip_calls"] == spec.rounds,
          f"train_lm: {seen['clip_calls']} update calls in {spec.rounds} "
          "rounds")
    del sess, start
    return out, seen


def _spmd_run(remat: bool):
    import torch
    from repro_torch.config import get_config
    from repro_torch.core.sfl import make_hasfl_train_step
    from repro_torch.data import make_lm_data
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = get_config(SPMD["arch"])
    n, b, s = SPMD["n_clients"], SPMD["batch"], SPMD["seq"]
    init_state, train_step = make_hasfl_train_step(
        build_model(cfg), n_clients=n, cut_reps=SPMD["cut_reps"],
        agg_interval=SPMD["agg_interval"], optimizer_name="adam",
        lr=SPMD["lr"], remat=remat)
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    tokens, labels = make_lm_data(cfg.vocab_size, n * b * SPMD["steps"], s,
                                  seed=0)
    tokens = torch.as_tensor(tokens.reshape(-1, n, b, s)).cuda()
    labels = torch.as_tensor(labels.reshape(-1, n, b, s)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times = [], []
    for t in range(SPMD["steps"]):
        t0 = time.perf_counter()
        state, m = train_step(state, {"tokens": tokens[t],
                                      "labels": labels[t]})
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    steady = sum(times[1:]) / (len(times) - 1)
    out = {"remat": remat, "loss": losses, "seconds_per_step": times,
           "steady_seconds_per_step": steady,
           "tokens_per_s": n * b * s / steady,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": _training_launches(launches, SPMD["steps"]),
           "launches": launches}
    del state, tokens, labels
    return out


def phase_spmd(detail):
    """The SPMD HASFL step at full width (`SPMD`: qwen3-1.7b, N=2,
    cut_reps=1, b=4, S=512, Adam, 6 steps), remat off and then on;
    counters zeroed and read around each run.  The loss falls; flash
    attention and RMSNorm ran forward and backward on their kernels.
    Returns the phase's numbers and both runs' `_witness`."""
    import math
    import torch

    runs = []
    with _witness() as seen:
        for remat in (False, True):
            runs.append(_spmd_run(remat))
            gc.collect()
            torch.cuda.empty_cache()
    out = {"phase": "spmd", **{k: SPMD[k] for k in (
        "arch", "n_clients", "cut_reps", "batch", "seq", "steps")},
        "runs": [{k: v for k, v in r.items() if k != "launches"}
                 for r in runs]}
    emit(out)
    detail["spmd"] = {**out, "runs": runs}
    for r in runs:
        check(all(math.isfinite(v) for v in r["loss"]),
              "spmd: non-finite loss")
        check(r["loss"][-1] < r["loss"][0],
              f"spmd: the loss did not fall {r['loss']}")
        for k in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                  "rmsnorm_bwd"):
            check(r["launches"][k] > 0, f"spmd: {k} never launched")
    return {"launches": runs[0]["launches"], "runs": runs}, seen


# ---------------------------------------------------------------------------
# Training of the other token families: MoE, hybrid, VLM, encoder-decoder
# ---------------------------------------------------------------------------

# the slice's full-width cell: the SPMD HASFL step on dbrx at its
# published widths, cut to 2 of 40 layers with cut_reps=1, so one MoE
# layer sits in the client-stacked prefix and one on the server
TRAIN_MOE = dict(name="train_moe", arch="dbrx-132b", cut=dict(n_layers=2),
                 n_clients=2, cut_reps=1, batch=2, seq=512, steps=6,
                 optimizer="sgd", lr=0.3, remat=False, attn_calls=2)
# the other families' SPMD runs, at their published widths: whisper whole
# (24 + 24 layers over 1500 stub frames, remat on), internvl2 whole with
# 256 patch stubs a sequence, jamba cut to one super-block (7 mamba, 1
# attention, 4 MoE) and to 4 of 16 experts, as serve_cross cuts it.
# ``attn_calls``: the attention calls a backward makes at each shape
TRAIN_FAMILY_SPMD = [
    dict(name="whisper", arch="whisper-medium", cut={}, n_clients=2,
         cut_reps=1, batch=2, seq=128, steps=6, optimizer="adam", lr=3e-4,
         remat=True, attn_calls=24),
    dict(name="internvl2_spmd", arch="internvl2-1b", cut={}, n_clients=2,
         cut_reps=1, batch=2, seq=512, steps=4, optimizer="adam", lr=3e-4,
         remat=False, attn_calls=24),
    dict(name="jamba", arch="jamba-v0.1-52b",
         cut=dict(n_layers=8, n_experts=4), n_clients=2, cut_reps=0,
         batch=1, seq=256, steps=4, optimizer="sgd", lr=0.1, remat=False,
         attn_calls=1)]
# internvl2 in the simulator's main path (a Session: tokens only, as the
# reference's), N=4, HASFL priors only; S=64 keeps the fp32 logits of a
# round (vocab 151655) to a few GB
TRAIN_VLM = dict(arch="internvl2-1b", n_clients=4, partition="iid",
                 seq_len=64, n_train=2048, n_test=256, rounds=6,
                 eval_every=2, policy="hasfl", estimate=False, seed=0)
# xlstm-350m at its published widths (d 1024, 4 heads, mLSTM hd 512,
# vocab 50304, bf16): the SPMD HASFL step over all 24 layers (20 mLSTM, 4
# sLSTM; one super-block of 6 in the client prefix), remat off and then
# on, 4 steps each (the sLSTM loop makes a step 2.7 s, 4.9 s under remat:
# 6 steps put the script past 600 s); and a Session cut to one period of
# the block pattern (5 mLSTM, 1 sLSTM), N=4, S=64, HASFL priors, 6 rounds
TRAIN_XLSTM = dict(name="train_xlstm", arch="xlstm-350m", cut={},
                   n_clients=2, cut_reps=1, batch=4, seq=512, steps=4,
                   optimizer="adam", lr=3e-4, remat=False, scans=20)
XLSTM_SESSION = dict(arch="xlstm-350m-6l", n_clients=4, partition="iid",
                     seq_len=64, n_train=2048, n_test=256, rounds=6,
                     eval_every=2, policy="hasfl", estimate=False, seed=0)
XLSTM_SESSION_CUT = dict(n_layers=6)


def _fingerprints(tree):
    """(Σx, Σx²) in fp64 of every non-empty leaf of ``tree``, a chunk at a
    time (no copy of a whole leaf): a leaf whose fingerprint did not
    change did not move.  Host ``[leaves, 2]``; an empty leaf (the stack
    of a prefix of no repetitions) has nothing to move and is left out."""
    import torch
    from repro_torch.utils.tree import tree_leaves

    out = []
    for leaf in tree_leaves(tree):
        if not leaf.numel():
            continue
        s = torch.zeros(2, dtype=torch.float64, device=leaf.device)
        for c in leaf.detach().reshape(-1).split(1 << 26):
            c = c.double()
            s += torch.stack([c.sum(), (c * c).sum()])
        out.append(s)
    return torch.stack(out).cpu()


def _stubs(cfg, n, b, s, gen):
    """The family's modality stubs for an ``[n, b, s]`` batch, on the
    card: patch embeddings at positions 1 .. P of every sequence (VLM),
    frame embeddings (whisper); {} for the others."""
    import torch

    out = {}
    if cfg.n_patches:
        out["patch_embeddings"] = torch.randn(
            (n, b, cfg.n_patches, cfg.d_model), device="cuda",
            generator=gen).to(torch.bfloat16)
        mask = torch.zeros((n, b, s), dtype=torch.bool, device="cuda")
        mask[..., 1:1 + cfg.n_patches] = True
        out["patch_mask"] = mask
    if cfg.is_enc_dec:
        out["frame_embeddings"] = torch.randn(
            (n, b, cfg.encoder_seq, cfg.d_model), device="cuda",
            generator=gen).to(torch.bfloat16)
    return out


def _moe_step_stats(records):
    """A forward's summed load-balance loss (over its MoE calls and
    clients) and its dropped share (mean over calls and clients), from
    `models.moe.RECORD`; (None, None) without MoE blocks."""
    import torch

    if not records:
        return None, None
    lb = float(sum(torch.as_tensor(a["lb_loss"]).detach().sum()
                   for a in records))
    drops = float(torch.stack([torch.as_tensor(a["dropped_frac"]).float(
    ).mean() for a in records]).mean())
    return lb, drops


def _family_spmd(run):
    """`make_hasfl_train_step` on ``run``'s arch at its published widths
    (cut in depth or experts as ``run["cut"]`` says), the same batch each
    step, counters zeroed and read around the steps.  Each step's loss, seconds, the MoE calls'
    load-balance loss and dropped share (`models.moe.RECORD`), and
    whether every parameter leaf moved (`_fingerprints`)."""
    import dataclasses
    import torch
    from repro_torch.config import get_config
    from repro_torch.core.sfl import make_hasfl_train_step
    from repro_torch.data import make_lm_data
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_config(run["arch"]), **run["cut"])
    n, b, s, steps = run["n_clients"], run["batch"], run["seq"], run["steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_state, train_step = make_hasfl_train_step(
        build_model(cfg), n_clients=n, cut_reps=run["cut_reps"],
        agg_interval=3, optimizer_name=run["optimizer"], lr=run["lr"],
        remat=run["remat"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(gen)
    before = _fingerprints([state["client"], state["server"]])
    # one batch, taken every step: under SGD's small steps a fresh batch a
    # step moves the loss less than one batch differs from the next
    tokens, labels = (torch.as_tensor(a.reshape(n, b, s)).cuda()
                      for a in make_lm_data(cfg.vocab_size, n * b, s, seed=0))
    batch = {"tokens": tokens, "labels": labels,
             **_stubs(cfg, n, b, s, gen)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    losses, times, lbs, drops = [], [], [], []
    M.RECORD = []
    try:
        for t in range(steps):
            t1 = time.perf_counter()
            state, m = train_step(state, batch)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t1)
            lb, dr = _moe_step_stats(M.RECORD)
            lbs.append(lb)
            drops.append(dr)
            M.RECORD.clear()
    finally:
        M.RECORD = None
    launches = ops.launch_counts()
    moved = (_fingerprints([state["client"], state["server"]])
             != before).any(dim=1).tolist()
    steady = sum(times[1:]) / (len(times) - 1)
    out = {"phase": run["name"], "arch": run["arch"], "cut": run["cut"],
           **{k: run[k] for k in ("n_clients", "cut_reps", "batch", "seq",
                                  "steps", "optimizer", "lr", "remat")},
           "init_seconds": init_s, "seconds": init_s + sum(times),
           "loss": losses, "seconds_per_step": times,
           "steady_seconds_per_step": steady,
           "tokens_per_s": n * b * s / steady,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "params": sum(x.numel() for x in tree_leaves(
               [state["client"], state["server"]])),
           "lb_loss": lbs, "dropped_share": drops,
           "launches_per_step": _training_launches(launches, steps),
           "leaves": len(moved), "leaves_unchanged": moved.count(False),
           "launches": launches}
    del state, batch
    return out


def _family_gates(out, what, moe: bool):
    """The gates of a family run: finite losses that fall, a finite
    positive load-balance loss a step (MoE), every parameter leaf moved,
    kernels 4 and 5 forward and backward launched."""
    losses = out["loss"] if "loss" in out else out["test_loss"]
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall {losses}")
    if moe:
        check(all(v is not None and math.isfinite(v) and v > 0
                  for v in out["lb_loss"]),
              f"{what}: lb_loss not finite and > 0: {out['lb_loss']}")
    check(out["leaves_unchanged"] == 0,
          f"{what}: {out['leaves_unchanged']} parameter leaves never moved")
    for k in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(out["launches"][k] > 0, f"{what}: {k} never launched")
    check(out["launches"]["mlstm_scan"] == 0
          and out["launches"]["clip_sgd_ext"] == 0,
          f"{what}: a kernel off the path launched")


def phase_train_moe(detail):
    """The slice's full-width cell (`TRAIN_MOE`): the SPMD HASFL step on
    dbrx-132b at its published widths (d 6144, 48/8 heads at hd 128, 16
    experts of 10752 top-4, vocab 100352), 2 of 40 layers, cut_reps=1,
    N=2, b=2, S=512, SGD, 6 steps.  Returns the run and its `_witness`."""
    import torch

    with _witness() as seen:
        out = _family_spmd(TRAIN_MOE)
    emit({k: v for k, v in out.items() if k != "launches"})
    detail["train_moe"] = out
    _family_gates(out, "train_moe", moe=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out, seen


def phase_train_families(detail):
    """The other families on the card: the SPMD runs of
    `TRAIN_FAMILY_SPMD` (whisper whole over 1500 frames, internvl2 with
    patch stubs, jamba's super-block) and internvl2 in a `Session`
    (`TRAIN_VLM`), each freed before the next.  Gates as `train_moe`'s;
    the Session also launches kernel 2 once a round for each 64 of its
    leaves.  Returns the runs
    and a `_witness` a run."""
    import torch
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig, get_config
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.kernels import ops

    runs, seen = {}, {}
    t_phase = time.perf_counter()
    for run in TRAIN_FAMILY_SPMD:
        with _witness() as seen[run["name"]]:
            out = _family_spmd(run)
        runs[run["name"]] = out
        _family_gates(out, f"train_families {run['name']}",
                      moe=bool(get_config(run["arch"]).n_experts))
        gc.collect()
        torch.cuda.empty_cache()
    spec = ExperimentSpec(**TRAIN_VLM, sfl=SFLConfig(lr=TRAIN_LM_LR,
                                                     agg_interval=3))
    torch.cuda.reset_peak_memory_stats()
    sess = Session(spec)
    before = _fingerprints(sess.sim._stacked)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with _witness() as seen["internvl2_session"]:
        t0 = time.perf_counter()
        res = sess.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    moved = (_fingerprints(sess.sim._stacked) != before).any(dim=1).tolist()
    vlm = {"phase": "internvl2_session", "arch": spec.arch,
           "n_clients": spec.n_clients, "seq_len": spec.seq_len,
           "rounds": spec.rounds, "seconds": seconds,
           "seconds_per_round": seconds / spec.rounds,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_round": _training_launches(launches, spec.rounds),
           "train_loss": res.train_loss, "test_loss": res.test_loss,
           "b_history": [list(map(int, b)) for b in res.b_history],
           "cut_history": [list(map(int, c)) for c in res.cut_history],
           "leaves": len(moved), "leaves_unchanged": moved.count(False),
           "launches": launches}
    runs["internvl2_session"] = vlm
    _family_gates(vlm, "train_families internvl2_session", moe=False)
    tables = -(-len(moved) // CS.CAPACITY)
    check(launches["clip_sgd"] == spec.rounds * tables,
          f"train_families internvl2_session: {launches['clip_sgd']} "
          f"update launches in {spec.rounds} rounds of {len(moved)} leaves")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "train_families",
           "seconds": time.perf_counter() - t_phase,
           "llama4": "not trained on the card at its published widths: one "
                     "MoE layer is ~16 B parameters; held in train_cross",
           "runs": {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                    for k, v in runs.items()}}
    emit(out)
    detail["train_families"] = {**out, "runs": runs}
    return runs, seen


def _xlstm_gates(out, what, scans_fwd, scans_bwd):
    """The gates of an xlstm run: finite losses that fall, every
    parameter leaf moved, kernel 6 forward and backward on the tensor
    cores at the counts given (None: at least one), kernel 5 forward and
    backward, no attention kernel and no fallback path."""
    losses = out["loss"] if "loss" in out else out["test_loss"]
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall {losses}")
    check(out["leaves_unchanged"] == 0,
          f"{what}: {out['leaves_unchanged']} parameter leaves never moved")
    launches = out["launches"]
    for k, want in (("mlstm_scan", scans_fwd), ("mlstm_scan_bwd", scans_bwd)):
        check(launches[k] > 0 if want is None else launches[k] == want,
              f"{what}: {launches[k]} {k} launches, not {want}")
    check(out["mlstm_paths"]["recurrent"] == 0
          and out["mlstm_paths"]["tc"] == launches["mlstm_scan"]
          and out["mlstm_bwd_paths"]["fp32"] == 0
          and out["mlstm_bwd_paths"]["tc"] == launches["mlstm_scan_bwd"],
          f"{what}: kernel 6 off the tensor-core path "
          f"{out['mlstm_paths']} {out['mlstm_bwd_paths']}")
    for k in ("rmsnorm", "rmsnorm_bwd"):
        check(launches[k] > 0, f"{what}: {k} never launched")
    check(launches["flash_attention"] == 0
          and launches["flash_attention_bwd"] == 0
          and launches["clip_sgd_ext"] == 0,
          f"{what}: a kernel off the path launched")


def _slstm_profile():
    """One sLSTM block's forward and backward alone at `train_xlstm`'s
    server shape (N·b = 8 sequences of 512 at d 1024, bf16, published
    widths): wall milliseconds (after a warm-up), and under
    ``torch.profiler`` the device-busy milliseconds and the kernels it
    launched — the Python loop over time is launch-bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import get_config
    from repro_torch.models import ssm as S
    from repro_torch.trace import _cuda_events, _device_times
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config(TRAIN_XLSTM["arch"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = S.slstm_init(gen, cfg.d_model, cfg.n_heads, _dtype(cfg.dtype),
                          "cuda")
    for t in tree_leaves(params):
        t.requires_grad_()
    rows = TRAIN_XLSTM["n_clients"] * TRAIN_XLSTM["batch"]
    x = torch.randn((rows, TRAIN_XLSTM["seq"], cfg.d_model), device="cuda",
                    generator=gen).to(_dtype(cfg.dtype)).requires_grad_()

    def run():
        S.slstm_block(params, x, cfg.n_heads, cfg.norm_eps).float().sum() \
            .backward()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy, top, kernels = _device_times(_cuda_events(prof))
    return {"shape": [rows, TRAIN_XLSTM["seq"], cfg.d_model],
            "wall_ms": wall, "device_busy_ms": busy, "kernels": kernels,
            "top_kernels_ms": dict(list(top.items())[:5])}


def phase_train_xlstm(detail):
    """xlstm-350m's full-width cell (`TRAIN_XLSTM`): the SPMD HASFL step
    over all 24 layers at its published widths, N=2, cut_reps=1, b=4,
    S=512, Adam, 4 steps, remat off and then on, counters zeroed and read
    around each run.  Kernel 6 launches 20 forwards and 20 backwards a
    step on the tensor cores (40 forwards under remat: the checkpointed
    super-blocks run theirs again), kernel 5 forward and backward.  Each
    step's seconds; the sLSTM loop's share of a step (`_slstm_profile`, a
    block's forward and backward at the step's shape, times the step's
    sLSTM blocks, over the remat-off run's steady step).  Returns the runs
    and their `_witness`."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import mlstm_scan as MS

    runs = []
    with _witness() as seen:
        for remat in (False, True):
            run = dict(TRAIN_XLSTM, remat=remat)
            out = _family_spmd(run)
            out.update(mlstm_paths=MS.path_launches(),
                       mlstm_bwd_paths=MS.bwd_path_launches())
            runs.append(out)
            gc.collect()
            torch.cuda.empty_cache()
    steps, scans = TRAIN_XLSTM["steps"], TRAIN_XLSTM["scans"]
    for out in runs:
        _xlstm_gates(out, f"train_xlstm remat={out['remat']}",
                     steps * scans * (2 if out["remat"] else 1),
                     steps * scans)
    slstm = _slstm_profile()
    blocks = _blocks(get_config(TRAIN_XLSTM["arch"])).count("slstm")
    slstm.update(blocks_a_step=blocks, share_of_step=blocks
                 * slstm["wall_ms"] / 1e3 / runs[0]["steady_seconds_per_step"])
    emit({"phase": "train_xlstm", "slstm": slstm,
          "runs": [{k: v for k, v in r.items() if k != "launches"}
                   for r in runs]})
    detail["train_xlstm"] = {"runs": runs, "slstm": slstm}
    return {"launches": runs[0]["launches"], "runs": runs}, seen


def phase_xlstm_session(detail):
    """xlstm-350m in the simulator's main path (`XLSTM_SESSION`): a
    `Session` at published widths cut to one period of the block pattern
    (`XLSTM_SESSION_CUT`: 5 mLSTM and 1 sLSTM layer), N=4, S=64, HASFL
    priors, 6 rounds.  Gates as `train_xlstm`'s (kernel 6's backward once
    a round for each mLSTM block), and kernel 2 once a round per 64
    leaves.  Returns the run and its `_witness`."""
    import dataclasses
    import torch
    import repro_torch.config as C
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import ops

    C.register(dataclasses.replace(C.get_config("xlstm-350m"),
                                   arch_id=XLSTM_SESSION["arch"],
                                   **XLSTM_SESSION_CUT))
    spec = ExperimentSpec(**XLSTM_SESSION, sfl=C.SFLConfig(lr=TRAIN_LM_LR,
                                                           agg_interval=3))
    scans = _blocks(C.get_config(spec.arch)).count("mlstm")
    torch.cuda.reset_peak_memory_stats()
    sess = Session(spec)
    before = _fingerprints(sess.sim._stacked)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with _witness() as seen:
        t0 = time.perf_counter()
        res = sess.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    moved = (_fingerprints(sess.sim._stacked) != before).any(dim=1).tolist()
    out = {"phase": "xlstm_session", "arch": spec.arch,
           "cut": XLSTM_SESSION_CUT, "n_clients": spec.n_clients,
           "seq_len": spec.seq_len, "rounds": spec.rounds,
           "seconds": seconds, "seconds_per_round": seconds / spec.rounds,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_round": _training_launches(launches, spec.rounds),
           "train_loss": res.train_loss, "test_loss": res.test_loss,
           "b_history": [list(map(int, b)) for b in res.b_history],
           "cut_history": [list(map(int, c)) for c in res.cut_history],
           "leaves": len(moved), "leaves_unchanged": moved.count(False),
           "mlstm_paths": MS.path_launches(),
           "mlstm_bwd_paths": MS.bwd_path_launches(),
           "mlstm_shapes": {str(k): v for k, v in seen["mlstm"].items()}}
    emit(out)
    out["launches"] = launches
    detail["xlstm_session"] = out
    _xlstm_gates(out, "xlstm_session", None, spec.rounds * scans)
    tables = -(-len(moved) // CS.CAPACITY)
    check(launches["clip_sgd"] == spec.rounds * tables,
          f"xlstm_session: {launches['clip_sgd']} update launches in "
          f"{spec.rounds} rounds of {len(moved)} leaves")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return out, seen, scans


def _register_cut(arch, name, dtype="float32", **cut):
    """Register ``arch`` `reduced` (smollm-tiny as registered, and the
    `TRAIN_CROSS_PUBLISHED` archs at their published widths) with the
    overrides ``cut`` under ``name`` in ``dtype``; returns its config."""
    import dataclasses
    import repro_torch.config as C

    cfg = C.get_config(arch)
    cfg = dataclasses.replace(cfg, **cut) \
        if arch == "smollm-tiny" or arch in TRAIN_CROSS_PUBLISHED \
        else C.reduced(cfg, **cut)
    C.register(dataclasses.replace(cfg, arch_id=name, dtype=dtype))
    return C.get_config(name)


# train_cross's fp32 cells, card against CPU: (arch, cut, session) with
# session "estimate" (HASFL with the online G²/σ² estimate), "priors", or
# "raises" (whisper: the Session makes no frames; SPMD steps only)
TRAIN_CROSS = [
    ("smollm-tiny", {}, "estimate"),
    ("qwen3-1.7b", {"n_layers": 2}, "priors"),
    ("glm4-9b", {"n_layers": 2}, "priors"),
    ("phi3-mini-3.8b", {"n_layers": 2, "head_dim": 96}, "priors"),
    ("dbrx-132b", {"n_layers": 2}, "priors"),
    ("llama4-maverick-400b-a17b", {"n_layers": 2, "n_experts": 8}, "priors"),
    ("jamba-v0.1-52b", {"n_layers": 2}, "priors"),
    ("internvl2-1b", {"n_layers": 2}, "priors"),
    ("whisper-medium", {"n_layers": 2, "n_encoder_layers": 2}, "raises"),
    ("xlstm-350m", {"n_layers": 6}, "priors")]
# the cells registered at their published widths (cut in depth only):
# ``bar``, relative, max |card − CPU| / (1 + |CPU|) — xlstm takes the
# reference's fp32 mLSTM bar (serve_cross's: its den = |n · q| cancels);
# ``sfl``, the batch cap at 4 (its CPU side differentiates the sequential
# recurrence, which keeps a [rows, 512, 512] state a step: at HASFL's b =
# 16 on 4 clients ~40 GB of host memory for 6 layers); ``rounds`` 3, not
# 6 (one aggregation; that recurrence takes ~20 s a Session round on the
# host, the script's time; at 6 rounds the fp32 cell read 5.4e-7 and
# 1.2e-6, PERF.md §5)
TRAIN_CROSS_PUBLISHED = {"xlstm-350m": dict(bar=2e-4, sfl=dict(max_batch=4),
                                            rounds=3)}
# bf16 cells (the registered type), priors only, 6 rounds, decisions and
# clocks bitwise: (arch, cut, losses held at the CPU test's 1e-3).  dbrx's
# losses are recorded, not held: its routers see bf16 activations that
# the card's kernels round otherwise than the plain versions, and a
# token whose top-k probabilities are that close takes other experts (the
# experts that differ and `_bf16_chaos`, one ulp's effect on the card
# alone, are recorded beside the losses).  xlstm's are recorded too: the
# card's bf16 mLSTM is the parallel form (h rounded once, P as two bf16
# parts), the CPU's the sequential recurrence (held to each other at
# 3e-2), so the losses part by more than 1e-3 from the first round
# (PERF.md §5); `_bf16_chaos` beside them
TRAIN_CROSS_BF16 = [("smollm-tiny", {}, True),
                    ("dbrx-132b", {"n_layers": 2}, False),
                    ("xlstm-350m", {"n_layers": 6}, False)]
TRAIN_CROSS_BF16_TOL = 1e-3


@contextlib.contextmanager
def _routing():
    """Every MoE call's chosen experts while the block runs (host copies,
    in call order), through `models.moe.RECORD`."""
    from repro_torch.models import moe as M

    experts = []
    M.RECORD = []
    try:
        yield experts
        experts.extend(a["expert_idx"].cpu() for a in M.RECORD)
    finally:
        M.RECORD = None


def _cross_session(spec):
    """``spec`` run on the card and on the CPU (each from the seeded init
    drawn on the host); per device (result, gather plans, final
    parameters, the MoE calls' experts)."""
    from repro_torch.api import Session
    from repro_torch.convert import units_to_numpy
    from repro_torch.utils.tree import tree_map

    runs = {}
    for dev in ("cuda", "cpu"):
        sess = Session(spec, device=dev)
        plans = _recording(sess)
        with _routing() as experts:
            res = sess.run()
        runs[dev] = (res, plans, units_to_numpy(
            [tree_map(lambda t: t.float(), u) for u in sess.sim._stacked]),
            experts)
    return runs


def _cross_start(cfg, model):
    """`_cross_spmd`'s start: the client and server trees (cut_reps=1,
    N=2) of the seeded init on the CPU, and 3 seeded batches (b=4, S=16,
    the family's stubs)."""
    import numpy as np
    import torch
    from repro_torch.core import split as SP

    params = model.init(torch.Generator().manual_seed(1), "cpu")
    client, server = SP.split_stacked(params, 1)
    client = SP.replicate_client(client, 2)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        batch = {k: rng.integers(0, cfg.vocab_size, (2, 4, 16))
                 for k in ("tokens", "labels")}
        if cfg.n_patches:
            batch["patch_embeddings"] = rng.standard_normal(
                (2, 4, cfg.n_patches, cfg.d_model)).astype(np.float32)
            mask = np.zeros((2, 4, 16), bool)
            mask[..., 2:2 + cfg.n_patches] = True
            batch["patch_mask"] = mask
        if cfg.is_enc_dec:
            batch["frame_embeddings"] = rng.standard_normal(
                (2, 4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        batches.append({k: torch.from_numpy(v) for k, v in batch.items()})
    return (client, server), batches


def _spmd_steps(model, start, batches, dev, first: int = 0):
    """SPMD steps (SGD at 1e-2, cut_reps=1, N=2, agg_interval 2, no
    remat) over ``batches`` from a copy of the trees ``start`` on ``dev``,
    counting steps from ``first``.  Yields after each step the step's
    [client, server] as CPU copies, its MoE calls' experts, its mLSTM
    calls' branch margins (`_scan_margins`) and its loss."""
    from repro_torch.core.sfl import make_hasfl_train_step
    from repro_torch.training.optim import make_optimizer
    from repro_torch.utils.tree import tree_map

    c = tree_map(lambda a: a.to(dev, copy=True), start[0])
    s_ = tree_map(lambda a: a.to(dev, copy=True).contiguous(), start[1])
    opt = make_optimizer("sgd", 1e-2)
    state = {"client": c, "server": s_, "step": first,
             "opt": opt.init({"client": c, "server": s_})}
    _, step = make_hasfl_train_step(
        model, n_clients=2, cut_reps=1, agg_interval=2,
        optimizer_name="sgd", lr=1e-2, remat=False)
    for batch in batches:
        with _routing() as experts, _scan_margins() as margins:
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
        # copies: the next step updates the state in place
        yield (tree_map(lambda a: a.detach().to("cpu", copy=True),
                        [state["client"], state["server"]]),
               experts, margins, float(m["loss"]))


def _cross_spmd(model, start, batches):
    """`_spmd_steps` from the same trees on the card and on the CPU; per
    device (each step's trees, the MoE calls' experts, each step's mLSTM
    margins, each step's loss)."""
    out = {}
    for dev in ("cuda", "cpu"):
        trees, experts, margins, losses = zip(
            *_spmd_steps(model, start, batches, dev))
        out[dev] = (trees, [e for es in experts for e in es], margins,
                    losses)
    return out


def _scan_margin(q, k, v, i_gate, f_gate):
    """Each row's branch margin ``log|a_t| + m_t`` of the mLSTM's ``den_t
    = max(|a_t|, exp(−m_t))`` (≥ 0: the |a_t| branch), and its
    cancellation ``Σ_s |P_ts| / den_t``, ``[B, H, S]``, in fp64 from the
    call's inputs (the parallel form, `mlstm_gate_prefix`)."""
    import torch
    from repro_torch.kernels import mlstm_scan as MS

    s, hd = q.shape[1], q.shape[-1]
    f_cum, g, m_run, _ = MS.mlstm_gate_prefix(i_gate, f_gate)
    g, m_run, f_cum = (t.permute(0, 2, 1) for t in (g, m_run, f_cum))
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    d = torch.exp((g[:, :, None, :] - m_run[:, :, :, None]).masked_fill(
        ~causal, float("-inf")))
    p = torch.einsum("bthd,bshd->bhts", q.double(), k.double()) \
        / math.sqrt(hd) * d
    a, m = p.sum(-1), f_cum + m_run
    margin = torch.log(a.abs()) + m
    den = torch.maximum(a.abs(), torch.exp(-m))
    return margin, p.abs().sum(-1) / den


@contextlib.contextmanager
def _scan_margins():
    """Every mLSTM scan's `_scan_margin` while the block runs (host
    copies, in call order), through whatever ``ops.mlstm_scan`` is."""
    import torch
    from repro_torch.kernels import ops

    scan, margins = ops.mlstm_scan, []

    def recording(q, k, v, i_gate, f_gate):
        with torch.no_grad():
            margins.append(tuple(t.cpu() for t in _scan_margin(
                q, k, v, i_gate, f_gate)))
        return scan(q, k, v, i_gate, f_gate)

    ops.mlstm_scan = recording
    try:
        yield margins
    finally:
        ops.mlstm_scan = scan


@contextlib.contextmanager
def _plain_mlstm(bwd_only: bool = False):
    """The mLSTM scan's plain version on the card while the block runs:
    autograd through the recurrence (`mlstm_scan_plain`, the CPU's
    function), or with ``bwd_only`` the forward kernel and the fp64
    backward formulas (`mlstm_scan_bwd_plain`) in `MLSTMScanFn`."""
    from repro_torch.kernels import mlstm_scan as MS
    from repro_torch.kernels import ops

    scan, bwd = ops.mlstm_scan, MS.MLSTMScanFn.backward
    if bwd_only:
        MS.MLSTMScanFn.backward = staticmethod(
            lambda ctx, dh: MS.mlstm_scan_bwd_plain(*ctx.saved_tensors,
                                                    dh.contiguous()))
    else:
        ops.mlstm_scan = MS.mlstm_scan_plain
    try:
        yield
    finally:
        ops.mlstm_scan, MS.MLSTMScanFn.backward = scan, staticmethod(bwd)


def _flips(xs, ys) -> dict:
    """Rows whose den branch differs between two runs' `_scan_margins`
    of the same calls, the largest |margin| among them on either side,
    the smallest |margin| of ``ys``, and the largest cancellation of
    either."""
    import torch

    flips = [(mx >= 0) != (my >= 0) for (mx, _), (my, _) in zip(xs, ys)]
    near = [torch.cat([mx[f].abs(), my[f].abs()])
            for f, (mx, _), (my, _) in zip(flips, xs, ys)]
    return {"flips": int(sum(int(f.sum()) for f in flips)),
            "flipped_max_abs_margin": max(
                (float(n.max()) for n in near if n.numel()), default=None),
            "min_abs_margin": min(float(my.abs().min()) for my, _ in ys),
            "max_cancellation": max(float(c.max()) for _, c in xs + ys)}


def _xlstm_spmd_witness(model, start, batches, spmd):
    """Whose the xlstm SPMD cell's card-vs-CPU difference is, step by
    step (`_spmd_steps`, SGD at 1e-2 as the cell): after each step, max
    |x − CPU| / (1 + |CPU|) of the card's run (``card``) and of the
    card's run with the scan's plain version (autograd through the
    recurrence on the card); of one step from the CPU's own weights
    before it with the kernels, with that plain version and with the fp64
    backward formulas (``one_step``); and of the card's run with one
    embedding element (of the first batch's first token) one fp32 ulp up
    against the card's own run (``one_ulp``).  With each: the rows whose
    den branch differs from the CPU's (`_flips`).  Beside them the CPU's
    loss and largest move a step, in the same measure."""
    import numpy as np
    import torch
    from repro_torch.utils.tree import tree_map

    cpu_trees, cpu_margins = spmd["cpu"][0], spmd["cpu"][2]
    out = {"card": [dict(err=_max_err(x, y, True), **_flips(mx, my))
                    for x, y, mx, my in zip(spmd["cuda"][0], cpu_trees,
                                            spmd["cuda"][2], cpu_margins)]}
    with _plain_mlstm():
        out["plain_scan_on_card"] = [
            dict(err=_max_err(x, y, True), **_flips(mx, my))
            for (x, _, mx, _), y, my in zip(
                _spmd_steps(model, start, batches, "cuda"), cpu_trees,
                cpu_margins)]
    befores = [start, *cpu_trees[:-1]]
    out["one_step"] = []
    for i, (before, batch) in enumerate(zip(befores, batches)):
        row = {}
        for name, ctx in (("kernels", contextlib.nullcontext()),
                          ("plain_scan", _plain_mlstm()),
                          ("plain_bwd", _plain_mlstm(bwd_only=True))):
            with ctx:
                (x, _, mx, _), = _spmd_steps(model, before, [batch], "cuda",
                                             i)
            row[name] = dict(err=_max_err(x, cpu_trees[i], True),
                             **_flips(mx, cpu_margins[i]))
        out["one_step"].append(row)
    bumped = tree_map(lambda a: a.clone(), start)
    emb, tok = bumped[0]["embed"], int(batches[0]["tokens"][0, 0, 0])
    emb[:, tok, 3] = torch.from_numpy(np.nextafter(
        emb[:, tok, 3].numpy(), np.float32(np.inf)))
    out["one_ulp"] = [
        dict(err=_max_err(x, y, True), **_flips(mx, my))
        for (x, _, mx, _), y, my in zip(
            _spmd_steps(model, bumped, batches, "cuda"), spmd["cuda"][0],
            spmd["cuda"][2])]
    out["one_step_max_err"] = max(r["kernels"]["err"]
                                  for r in out["one_step"])
    out["cpu_loss"] = list(spmd["cpu"][3])
    out["cpu_move"] = [_max_err(y, b, True)
                       for y, b in zip(cpu_trees, befores)]
    return out


def _moe_bwd_repeat(cfg, model):
    """Whether the MoE backward is bitwise from run to run on the card:
    ``loss``'s gradients of the same weights and batch, twice.  The
    combine's gather differentiates into an accumulating ``index_put_``;
    the finding is recorded, not gated.  Returns the leaves that differ
    and their largest difference."""
    import torch
    from repro_torch.utils.tree import tree_leaves, tree_map

    params = tree_map(lambda a: a.cuda(), model.init(
        torch.Generator().manual_seed(3), "cpu"))
    gen = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=gen
                              ).cuda() for k in ("tokens", "labels")}
    grads = []
    for _ in range(2):
        leaves = tree_map(lambda a: a.detach().requires_grad_(), params)
        loss, _ = model.loss(leaves, batch)
        loss.backward()
        grads.append([a.grad for a in tree_leaves(leaves)])
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(*grads)]
    return {"leaves": len(diffs),
            "leaves_not_bitwise": sum(not torch.equal(a, b)
                                      for a, b in zip(*grads)),
            "max_abs_diff": max(diffs)}


def _bf16_chaos(spec):
    """How far one bf16 ulp moves a Session: ``spec`` run twice on the
    card from its seeded init, the second time with one embedding element
    one ulp up; the largest train/test loss difference (recorded, not
    gated: the witness beside the bf16 MoE cell's card-vs-CPU losses)."""
    import torch
    from repro_torch.api import Session

    losses = []
    for bump in (0, 1):
        sess = Session(spec)
        if bump:
            emb = sess.sim._stacked[0]["embed"]
            emb.view(torch.int16)[:, 5, 3] += 1
        res = sess.run()
        losses.append(res.train_loss + res.test_loss)
    return max(abs(a - b) for a, b in zip(*losses))


def _max_err(xs, ys, rel: bool = False) -> float:
    """max |x − y| over every leaf (host arrays or CPU tensors), or with
    ``rel`` max |x − y| / (1 + |y|); taken in torch, whose elementwise
    ops use every core (xlstm's trees hold ~350 M elements)."""
    import torch
    from repro_torch.utils.tree import tree_leaves

    errs = []
    for a, b in zip(tree_leaves(xs), tree_leaves(ys)):
        x, y = torch.as_tensor(a), torch.as_tensor(b)
        if x.numel():
            d = (x - y).abs()
            errs.append(float((d / (1 + y.abs()) if rel else d).max()))
    return max(errs, default=0.0)


def phase_train_cross(detail):
    """The training paths on the card against the CPU, from the same
    weights (`TRAIN_CROSS`, fp32): a 6-round token `Session` (decisions,
    clocks and gather plans bitwise; losses and parameters within 1e-4)
    and 3 SPMD steps with SGD (client and server trees within 1e-4 after
    each), for every token family at 2 layers (llama4 at 8 experts, phi3
    at hd 96, internvl2 and whisper with their stubs); the MoE calls'
    experts equal on both devices.  Whisper's Session raises
    ``KeyError('frame_embeddings')`` on both, as the reference's.  xlstm
    (`TRAIN_CROSS_PUBLISHED`) at its own relative bar, its SPMD steps
    held one by one from the CPU's weights (`_xlstm_spmd_witness`).  Then
    the bf16 cells (`TRAIN_CROSS_BF16`): decisions and clocks bitwise,
    smollm's losses within 1e-3, dbrx's and xlstm's recorded."""
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    out, gates = {"phase": "train_cross"}, []
    for arch, cut, session in TRAIN_CROSS:
        t0 = time.perf_counter()
        name = f"{arch}-cross-f32"
        cfg = _register_cut(arch, name, **cut)
        rel = arch in TRAIN_CROSS_PUBLISHED
        cell = TRAIN_CROSS_PUBLISHED.get(
            arch, dict(bar=CROSS_TOL, sfl={}, rounds=6))
        tol = cell["bar"]
        spec = ExperimentSpec(
            arch=name, n_clients=4, partition="iid", n_train=256, n_test=32,
            seq_len=16, rounds=cell["rounds"], eval_every=2, policy="hasfl",
            estimate=session == "estimate",
            sfl=SFLConfig(lr=0.05, agg_interval=3, **cell["sfl"]))
        row = {}
        if session == "raises":
            for dev in ("cuda", "cpu"):
                try:
                    Session(spec, device=dev).run()
                    raised = None
                except KeyError as e:
                    raised = str(e)
                gates.append((raised is not None
                              and "frame_embeddings" in raised,
                              f"train_cross {name}: the Session did not "
                              f"raise the reference's KeyError on {dev}"))
            row["session"] = "KeyError('frame_embeddings') on both"
        else:
            runs = _cross_session(spec)
            (rg, pg, wg, eg), (rc, pc, wc, ec) = runs["cuda"], runs["cpu"]
            gates += [
                (_same(rg.b_history, rc.b_history)
                 and _same(rg.cut_history, rc.cut_history),
                 f"train_cross {name}: decisions"),
                (rg.clock == rc.clock, f"train_cross {name}: clock"),
                (_same(pg, pc), f"train_cross {name}: gather plans"),
                (_same(eg, ec), f"train_cross {name}: the Session's experts")]
            row.update(
                b_history=[list(map(int, b)) for b in rg.b_history],
                clock=rg.clock, moe_calls=len(eg),
                loss_max_err=max(abs(a - b) / (1 + abs(b) if rel else 1)
                                 for a, b in zip(
                    rg.train_loss + rg.test_loss,
                    rc.train_loss + rc.test_loss)),
                param_max_err=_max_err(wg, wc, rel))
        model = build_model(cfg)
        start, batches = _cross_start(cfg, model)
        spmd = _cross_spmd(model, start, batches)
        if arch == "dbrx-132b":
            row["moe_bwd_repeat"] = _moe_bwd_repeat(cfg, model)
        held = ["loss_max_err", "param_max_err", "spmd_param_max_err"]
        if "mlstm" in _blocks(cfg):
            # the 3-step run is recorded and each step from the CPU's own
            # weights held: step 3 carries step 2's weight difference
            # (2.7e-5) through a step that grows it ~80×, with the scan's
            # plain version on the card alike (PERF.md §5)
            row["spmd_witness"] = _xlstm_spmd_witness(model, start, batches,
                                                      spmd)
            row["spmd_one_step_max_err"] = \
                row["spmd_witness"]["one_step_max_err"]
            held[-1] = "spmd_one_step_max_err"
        gates.append((_same(spmd["cuda"][1], spmd["cpu"][1]),
                      f"train_cross {name}: the SPMD steps' experts"))
        row.update(spmd_param_err_by_step=[
            _max_err(x, y, rel) for x, y in zip(spmd["cuda"][0],
                                                spmd["cpu"][0])],
                   spmd_moe_calls=len(spmd["cuda"][1]),
                   seconds=time.perf_counter() - t0)
        row["spmd_param_max_err"] = max(row["spmd_param_err_by_step"])
        if rel:
            row["bar"] = f"{tol}·(1+|cpu|)"
        out[name] = row
        gates += [(row[k] <= tol,
                   f"train_cross {name}: {k} {row[k]} over {tol}")
                  for k in held if k in row]
    for arch, cut, held in TRAIN_CROSS_BF16:
        t0 = time.perf_counter()
        name = f"{arch}-cross-bf16"
        cfg = _register_cut(arch, name, dtype="bfloat16", **cut)
        cell = TRAIN_CROSS_PUBLISHED.get(arch, dict(sfl={}, rounds=6))
        spec = ExperimentSpec(
            arch=name, n_clients=4, partition="iid", n_train=256, n_test=32,
            seq_len=16, rounds=cell["rounds"], eval_every=2, policy="hasfl",
            estimate=False, sfl=SFLConfig(lr=0.05, agg_interval=3,
                                          **cell["sfl"]))
        runs = _cross_session(spec)
        (rg, _, wg, eg), (rc, _, wc, ec) = runs["cuda"], runs["cpu"]
        gates += [(_same(rg.b_history, rc.b_history)
                   and _same(rg.cut_history, rc.cut_history),
                   f"train_cross {name}: decisions"),
                  (rg.clock == rc.clock, f"train_cross {name}: clock")]
        err = max(abs(a - b) for a, b in zip(rg.train_loss + rg.test_loss,
                                             rc.train_loss + rc.test_loss))
        out[name] = {"loss_max_err": err, "loss_held": held,
                     "param_max_err": _max_err(wg, wc),
                     "train_loss": [rg.train_loss, rc.train_loss],
                     "test_loss": [rg.test_loss, rc.test_loss]}
        if eg:
            out[name].update(
                moe_calls=len(eg), experts_differ=sum(
                    int((a != b).sum()) for a, b in zip(eg, ec)),
                expert_choices=sum(a.numel() for a in eg),
                moe_bwd_repeat=_moe_bwd_repeat(cfg, build_model(cfg)))
        if not held:
            out[name]["one_ulp_loss_move"] = _bf16_chaos(spec)
        out[name]["seconds"] = time.perf_counter() - t0
        if held:
            gates.append((err <= TRAIN_CROSS_BF16_TOL,
                          f"train_cross {name}: losses differ by {err}"))
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    detail["train_cross"] = out
    for ok, what in gates:
        check(ok, what)
    return out


def phase_cli_spmd(detail):
    """`repro_torch.launch.train.main(SPMD_CLI)` on the card: a short
    ``--mode spmd`` run (the reference's reduced model), one logged row a
    step, finite losses."""
    import math
    from repro_torch.launch import train

    t0 = time.perf_counter()
    rows = train.main(SPMD_CLI)
    out = {"phase": "cli_spmd", "argv": SPMD_CLI,
           "seconds": time.perf_counter() - t0, "steps": len(rows),
           "loss": [r["loss"] for r in rows]}
    emit(out)
    detail["cli_spmd"] = out
    check(len(rows) == 4, f"cli_spmd: {len(rows)} rows for 4 steps")
    check(all(math.isfinite(r["loss"]) for r in rows),
          "cli_spmd: non-finite loss")
    return out



# the token cells of the grid runner, mesh mode and the dynamic edge at
# published widths (smollm-135m whole: 30 layers, d 576, vocab 49152,
# bf16), each at train_lm's step size.  grid_lm: four cells, one b bucket
# (b=16), crossing seeds (each cell reads its own data) and cuts (other
# unit masks); G·N·b·S = 4·4·16·128 tokens a round, train_lm's 8·32·128
GRID_LM = dict(arch="smollm-135m", n_clients=4, partition="iid",
               seq_len=128, n_train=2048, n_test=256, rounds=6,
               eval_every=3, estimate=False)
GRID_LM_CELLS = [dict(policy=f"fixed(b=16,cut={cut})", seed=seed)
                 for cut in (1, 3) for seed in (0, 1)]
# mesh_lm: 8 resident slots of a logical population of 1024 on 4 edge
# servers, HASFL on priors; I=2 so that the bank rotates twice in 6
# rounds (at rounds 2 and 4; at I=3 it would rotate once)
MESH_LM = dict(arch="smollm-135m", n_clients=8, partition="iid",
               seq_len=128, n_train=4096, n_test=256, rounds=6,
               eval_every=3, policy="hasfl", estimate=False)
MESH_LM_AGG = 2
# dynamic_lm: N=4 under churn-heavy with deadline faults, snapshots every
# 3 rounds (N·135 M bf16 weights: ~1.1 GB a snapshot), then the same
# cohort on the streaming plane at the traffic phase's rates
DYNAMIC_LM = dict(arch="smollm-135m", n_clients=4, partition="iid",
                  seq_len=128, n_train=2048, n_test=256, rounds=6,
                  eval_every=3, policy="hasfl", estimate=False)
DYNAMIC_LM_EVERY = 3


@contextlib.contextmanager
def _products():
    """Count the client-stacked products (`models.layers._bmm`: one
    `torch.bmm` a call, a cell's or a whole fold's) while the block runs;
    the count in a one-element list."""
    from repro_torch.models import layers as L

    bmm = L._bmm
    seen = [0]

    def counted(x, w):
        seen[0] += 1
        return bmm(x, w)

    L._bmm = counted
    try:
        yield seen
    finally:
        L._bmm = bmm


@contextlib.contextmanager
def _at_backward():
    """While a training path runs: the device memory allocated as each
    `Tensor.backward` starts (what was resident, the forward's saved
    tensors and its outputs), in GB, one entry a call, in a list."""
    import torch

    real = torch.Tensor.backward
    seen = []

    def backward(self, *a, **kw):
        seen.append(torch.cuda.memory_allocated() / 1e9)
        return real(self, *a, **kw)

    torch.Tensor.backward = backward
    try:
        yield seen
    finally:
        torch.Tensor.backward = real


def _tables(sess) -> int:
    """Kernel 2's or 3's launches a round: the unit leaves over the table's
    capacity."""
    from repro_torch.kernels.clip_sgd import CAPACITY
    from repro_torch.utils.tree import tree_leaves

    return -(-len(tree_leaves(sess.sim.units)) // CAPACITY)


def phase_grid_lm(detail):
    """`run_grid` on four smollm-135m cells at published widths
    (`GRID_LM`, `GRID_LM_CELLS`), first with ``runner="sequential"`` and
    then folded (``"grid"``); counters zeroed just before and read just
    after each.  Checks: every cell bitwise equal between the two
    (results and final parameters), the products (`_products`) the same
    count both ways (each runs a cell at a time: `layers.mm`'s
    ``cell_size``), kernel 2 ⌈members·leaves/64⌉ launches a dispatch round
    in the grid, RMSNorm and flash attention fewer launches folded than
    one after another, finite losses.  Seconds a cell-round both ways,
    policy seconds, dispatches, memory resident before each run, the
    most allocated as a backward starts (`_at_backward`) and the peak."""
    import math
    import torch
    from repro_torch.api import ExperimentSpec, Session, grid, run_grid
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.clip_sgd import CAPACITY
    from repro_torch.utils.tree import tree_leaves

    specs = [ExperimentSpec(**GRID_LM, **c, update_impl="kernel",
                            sfl=SFLConfig(lr=TRAIN_LM_LR, agg_interval=3))
             for c in GRID_LM_CELLS]
    cell_rounds = len(specs) * specs[0].rounds
    runs = {}
    for runner in ("sequential", "grid"):
        sessions = [Session(s) for s in specs]
        n_leaves = len(tree_leaves(sessions[0].sim.units))
        policy_s = _timed_policies(sessions)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9
        grid.run_group.dispatches.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        with _products() as products, _at_backward() as at_bwd:
            t0 = time.perf_counter()
            res = run_grid(sessions, runner=runner)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        leaves = [tree_leaves(s.sim._stacked) for s in sessions]
        runs[runner] = dict(
            seconds=seconds, seconds_per_cell_round=seconds / cell_rounds,
            policy_seconds=policy_s[0],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            resident_gb=resident, at_backward_gb=max(at_bwd),
            launches=ops.launch_counts(), products=products[0],
            dispatches=list(grid.run_group.dispatches), res=res,
            # the sequential cells' parameters wait on the host (their 4.4
            # GB on the card would count in the grid run's peak)
            params=[[t.cpu() for t in ls] for ls in leaves]
            if runner == "sequential" else leaves)
        del sessions, leaves
    g, q = runs["grid"], runs["sequential"]
    want_updates = sum(d.rounds * -(-len(d.members) * n_leaves // CAPACITY)
                       for d in g["dispatches"])
    res = g["res"]
    bitwise = [dict(
        results=_same_result(r, s),
        params=all(torch.equal(a.to(b.device), b) for a, b in zip(ps, pg)))
        for r, s, ps, pg in zip(res, q["res"], q["params"], g["params"])]
    keys = ("seconds", "seconds_per_cell_round", "policy_seconds", "peak_gb",
            "resident_gb", "at_backward_gb", "launches", "products")
    out = {"phase": "grid_lm", "arch": specs[0].arch,
           "n_clients": specs[0].n_clients, "seq_len": specs[0].seq_len,
           "rounds": specs[0].rounds, "leaves": n_leaves,
           "cells": [f"{s.policy} seed {s.seed}" for s in specs],
           **{k: g[k] for k in keys},
           "dispatches": [[d.t0, d.rounds, d.b_pad, list(d.members)]
                          for d in g["dispatches"]],
           "expected_update_launches": want_updates,
           "sequential": {k: q[k] for k in keys},
           "train_loss": [r.train_loss for r in res],
           "test_loss": [r.test_loss for r in res],
           "bitwise_vs_sequential": bitwise}
    emit(out)
    detail["grid_lm"] = out
    check(all(all(row.values()) for row in bitwise),
          f"grid_lm: cells differ from their sequential runs: {bitwise}")
    check(g["products"] == q["products"] > 0,
          f"grid_lm: {g['products']} products folded, {q['products']} one "
          "after another")
    check(g["launches"]["clip_sgd"] == want_updates,
          f"grid_lm: {g['launches']['clip_sgd']} update launches, not "
          f"{want_updates}")
    for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd"):
        check(0 < g["launches"][k] < q["launches"][k],
              f"grid_lm: {k} {g['launches'][k]} launches folded, "
              f"{q['launches'][k]} one after another")
    check(g["launches"]["clip_sgd_ext"] == 0,
          "grid_lm: the external-mean update launched")
    check(all(math.isfinite(v) for r in res
              for v in r.train_loss + r.test_loss + r.clock),
          "grid_lm: non-finite loss or clock")
    return out


def _clip_ext_round_checks(rec, what):
    """Kernel 3 on a round of `mesh_lm` as the path ran it (``what`` names
    the round): the rank's leaves (bf16 weights beside fp32 norm scales)
    as they stood before the round's in-place update, their gradients,
    clip factors, keep flags and the two-tier means (in the leaf's type)
    with the global count, in one call on copies, against its plain
    version in fp32 rounded once to each leaf's type (the kernel's
    arithmetic), leaf by leaf: bf16 within one bf16 ulp, fp32 within
    `CLIP_TOL`.  The call timed on the copies beside its bytes bound,
    counted from this round's flags: a keeping leaf reads p and g and
    writes p, a leaf that takes the mean reads it (in the leaf's type: the
    wrapper's widening to fp32 is the port's, not the function's) and
    writes every row, a leaf that holds moves nothing; and the plain
    version at the leaves' own types."""
    import torch
    from repro_torch.kernels import clip_sgd as CS
    from repro_torch.timing import graph_ms

    check(rec is not None, f"clip_sgd_ext {what}: the call was not "
          "recorded")
    ps, gs, scale, keeps, part, kw = (rec[k] for k in (
        "ps", "gs", "scale", "keep_specs", "participation", "kw"))
    commons, count = kw["commons"], kw["count"]
    check(commons is not None, f"clip_sgd_ext {what}: no means")
    tables = -(-len(ps) // CS.CAPACITY)
    before = CS.clip_sgd_ext_kernel.launches
    got = CS.clip_sgd_leaves_kernel([p.clone() for p in ps], gs, scale,
                                    keeps, part, **kw)
    torch.cuda.synchronize()
    check(CS.clip_sgd_ext_kernel.launches == before + tables,
          f"clip_sgd_ext {what}: not {tables} launches for {len(ps)} "
          "leaves")
    use_any = float(count) > 0
    err, nbytes = 0.0, 4.0 * scale.numel()
    for i, (p, g, c, out) in enumerate(zip(ps, gs, commons, got)):
        want = CS.clip_sgd_leaves_plain(
            [p.float()], [g.float()], scale, [keeps[i]], part,
            gamma=kw["gamma"], commons=[c.float()],
            count=count)[0].to(p.dtype).float()
        diff = (out.float() - want).abs()
        err = max(err, float(diff.max()))
        bar = 2 ** -7 * want.abs() + 1e-6 if p.dtype == torch.bfloat16 \
            else CLIP_TOL
        check(bool((diff <= bar).all()),
              f"clip_sgd_ext {what} leaf {i} {p.dtype} "
              f"{tuple(p.shape)}: {float(diff.max())} over the bar")
        if keeps[i]:
            nbytes += (2.0 * p.element_size() + g.element_size()) * p.numel()
        elif use_any:
            nbytes += (p.numel() + p.shape[1]) * p.element_size()
    out = {"leaves": len(ps), "launches": tables,
           "bf16_leaves": sum(p.dtype == torch.bfloat16 for p in ps),
           "keeping_leaves": sum(map(bool, keeps)),
           "elements": sum(p.numel() for p in ps), "max_abs_err": err,
           "ms": time_ms(lambda: CS.clip_sgd_leaves_kernel(
               got, gs, scale, keeps, part, **kw)),
           "device_ms": graph_ms(lambda: CS.clip_sgd_leaves_kernel(
               got, gs, scale, keeps, part, **kw)),
           "plain_ms": time_ms(lambda: CS.clip_sgd_leaves_plain(
               ps, gs, scale, keeps, part, **kw)),
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "bytes": nbytes}
    del got
    return out


def phase_mesh_lm(detail):
    """Mesh mode on a token cell at published widths (`MESH_LM`:
    smollm-135m, 8 slots on a world-size-1 NCCL group, 4 edge servers, a
    cohort bank over 1024 logical clients, 6 rounds at I=2); counters
    zeroed and read around the run.  Checks: kernel 3 ⌈leaves/64⌉ launches
    a round (its bf16 leaves through the external mean), kernel 2 none,
    two rotations, the test loss falls, every leaf moved.  Then kernel 3
    on copies of the last two rounds (`_clip_ext_round_checks`): the
    fifth, where the client-specific leaves keep their own SGD result and
    the rest take the mean, and the sixth, an aggregation round where
    every leaf takes it.  Seconds a round, the round's all-reduce ms,
    policy share, memory resident before the run, the most allocated as a
    backward starts and the peak.  The
    process group is destroyed at the end."""
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.api import ExperimentSpec, Session
    from repro_torch.config import SFLConfig
    from repro_torch.kernels import ops
    from repro_torch.mesh import MeshSpec
    from repro_torch.utils.tree import tree_leaves

    spec = ExperimentSpec(
        **MESH_LM, update_impl="kernel",
        sfl=SFLConfig(lr=TRAIN_LM_LR, agg_interval=MESH_LM_AGG),
        mesh=MeshSpec(devices=1, n_edges=4, population=1024))
    sess = Session(spec)
    start = [t.clone() for t in tree_leaves(sess.sim._stacked)]
    tables = _tables(sess)
    spent = _timed_policies([sess])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with _witness(clip_calls=(spec.rounds - 1, spec.rounds)) as seen, \
            _at_backward() as at_bwd:
        t0 = time.perf_counter()
        res = sess.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    leaves = tree_leaves(sess.sim._stacked)
    moved = [not torch.equal(a, b) for a, b in zip(start, leaves)]
    del start
    units = tree_leaves(sess.sim.units)
    out = {"phase": "mesh_lm", "arch": spec.arch,
           "n_clients": spec.n_clients, "mesh": spec.mesh.to_dict(),
           "agg_interval": MESH_LM_AGG, "rounds": spec.rounds,
           "seconds": seconds, "seconds_per_round": seconds / spec.rounds,
           "policy_share": spent[0] / seconds, "peak_gb": peak,
           "resident_gb": resident, "at_backward_gb": max(at_bwd),
           "rotations": sess.sim._bank.rotations,
           "leaves": len(leaves),
           "bf16_leaves": sum(t.dtype == torch.bfloat16 for t in leaves),
           "launches": launches,
           "allreduce_ms_per_round": _allreduce_ms(
               sess.sim._group, [(t.numel(), t.dtype) for t in units]),
           "train_loss": res.train_loss, "test_loss": res.test_loss,
           "clock": res.clock,
           "b_history": [list(map(int, b)) for b in res.b_history],
           "cut_history": [list(map(int, c)) for c in res.cut_history],
           "leaves_unchanged": moved.count(False)}
    keep = _clip_ext_round_checks(seen["clip"].get(spec.rounds - 1),
                                  f"mesh_lm round {spec.rounds - 1}")
    ext = _clip_ext_round_checks(seen["clip"].get(spec.rounds),
                                 f"mesh_lm round {spec.rounds}")
    out["clip_sgd_ext_round"] = ext
    out["clip_sgd_ext_keeping_round"] = keep
    emit(out)
    detail["mesh_lm"] = out
    del sess, leaves, units, seen
    gc.collect()
    dist.destroy_process_group()
    check(launches["clip_sgd_ext"] == spec.rounds * tables,
          f"mesh_lm: {launches['clip_sgd_ext']} external-mean launches, not "
          f"{tables} a round")
    check(launches["clip_sgd"] == 0, "mesh_lm: the flat update launched")
    for k in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(launches[k] > 0, f"mesh_lm: {k} never launched")
    check(out["rotations"] == 2, f"mesh_lm: {out['rotations']} rotations")
    check(0 < keep["keeping_leaves"] < keep["leaves"]
          and ext["keeping_leaves"] == 0,
          f"mesh_lm: {keep['keeping_leaves']} leaves keep in round "
          f"{spec.rounds - 1}, {ext['keeping_leaves']} in the aggregation "
          "round")
    check(all(math.isfinite(v) for v in res.train_loss + res.test_loss),
          "mesh_lm: non-finite loss")
    check(res.test_loss[-1] < res.test_loss[0],
          f"mesh_lm: the test loss did not fall {res.test_loss}")
    check(all(moved), f"mesh_lm: {moved.count(False)} parameter leaves "
          "never moved")
    return out, ext, keep


def phase_dynamic_lm(detail):
    """The dynamic edge on a token cell at published widths (`DYNAMIC_LM`:
    smollm-135m, N=4, 6 rounds): under ``churn-heavy`` with deadline
    faults, and then on the streaming plane at the traffic phase's rates
    (`TRAFFIC`), each run uninterrupted, checkpointed every 3 rounds and
    resumed from round 3 (`_dynamic_runs`).  Checks: kernel 2 ⌈leaves/64⌉
    launches a round, flash attention launched, the checkpointed and
    resumed runs bitwise equal to the uninterrupted one (results, final
    parameters, participation plans; the traffic run's event log).
    Snapshot seconds and bytes, seconds a round, peak, participation and
    the plane's events."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, TrafficSpec
    from repro_torch.config import SFLConfig

    sfl = SFLConfig(lr=TRAIN_LM_LR, agg_interval=3)
    spec = ExperimentSpec(**DYNAMIC_LM, update_impl="kernel", **SCENARIO,
                          sfl=sfl)
    runs, info = _dynamic_runs(spec, "dynamic_lm", _recording_parts,
                               every=DYNAMIC_LM_EVERY)
    tables = _tables(runs[0][0])
    out, checks = _dynamic_out("dynamic_lm", spec, runs, info,
                               every=DYNAMIC_LM_EVERY,
                               updates_a_round=tables)
    parts = np.concatenate(runs[0][2])
    out.update(mean_participation=float(parts.mean()),
               rounds_with_drops=int((parts.min(axis=1) < 1).sum()),
               parts_bitwise_resumed=_same(
                   runs[2][2], runs[0][2][-len(runs[2][2]):]))
    checks.append((out["parts_bitwise_resumed"],
                   "the resumed participation plans differ"))
    del runs
    gc.collect()
    spec_t = ExperimentSpec(**DYNAMIC_LM, update_impl="kernel",
                            scenario="churn-heavy", scenario_seed=7,
                            traffic=TrafficSpec(**TRAFFIC), sfl=sfl)
    runs, info = _dynamic_runs(spec_t, "dynamic_lm_traffic",
                               _recording_weights, every=DYNAMIC_LM_EVERY)
    traffic, checks_t = _dynamic_out("dynamic_lm_traffic", spec_t, runs,
                                     info, every=DYNAMIC_LM_EVERY,
                                     updates_a_round=tables)
    whole = runs[0][0]
    w = np.concatenate([p.ravel() for p in runs[0][2]])
    traffic.update(
        events=whole.plane.log.counts(), virtual_clock=whole.plane.clock,
        fractional_weights=int(((w > 0) & (w < 1)).sum()),
        event_log_bitwise=_same_log(runs[2][0].plane.log, whole.plane.log)
        and _same_log(runs[1][0].plane.log, whole.plane.log))
    checks_t.append((traffic["event_log_bitwise"],
                     "the event log differs from the uninterrupted run's"))
    del runs, whole
    gc.collect()
    out["traffic"] = {k: v for k, v in traffic.items() if k != "phase"}
    emit(out)
    detail["dynamic_lm"] = out
    for ok, what in checks:
        check(ok, f"dynamic_lm: {what}")
    for ok, what in checks_t:
        check(ok, f"dynamic_lm traffic: {what}")
    return out


# ---------------------------------------------------------------------------
# Decode from ring, windowed and per-sequence caches; the dry-run on meta
# ---------------------------------------------------------------------------

# serve_ring: qwen3-1.7b at published widths under the long_500k combo's
# sliding window (`launch.dryrun.SLIDING_WINDOW_500K`), batch 1 (that
# combo's batch), a ring of as many slots, a prompt of a whole ring (so
# the ring starts in order), then greedy steps that wrap it
SERVE_RING = dict(arch="qwen3-1.7b", batch=1, gen=64, seed=3)
# the same ring at fp32, where kernel and plain decode are held at 1e-4
SERVE_RING_FP32_STEPS = 16
DECODE_BAR = dict(rtol=0.07, atol=0.05)    # tests/test_decode.py's bars
# decode_positions: sequence i prefilled alone at 384 + 16·i tokens into
# row i of one cache of 576 slots, then steps taken together
DECODE_POSITIONS = dict(arch="qwen3-1.7b", batch=8, base=384, stride=16,
                        slots=576, gen=32, seed=4)
DECODE_POSITIONS_FP32_STEPS = 8
# serve_cross's two new cases (fp32, qwen3 cut to 2 layers, card vs CPU):
# a ring of 16 slots under a window of 16 from a 40-token prompt (not a
# multiple of 16: the windowed prefill's slot order, kept from the
# reference, runs on both sides) and 24 steps; four sequences of 20..44
# tokens at their own positions in a 64-slot cache, 8 steps
SERVE_CROSS_RING = dict(window=16, prompt=40, gen=24)
SERVE_CROSS_POSITIONS = dict(lengths=(20, 28, 36, 44), slots=64, gen=8)


def _clone_tree(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def _decode_run(model, params, cache, first_tokens, positions, steps,
                feed=None, window=None):
    """``steps`` decode steps from ``cache`` (updated in place), the first
    fed ``first_tokens`` [B] at ``positions`` [B] (tensors on the model's
    device), then each step's greedy ids (or ``feed[:, i]``); returns the
    fp32 logits [B, steps, V] and the ids [B, steps] on the host, and the
    seconds of the loop (ending in a sync on the card)."""
    import torch

    def sync():
        if positions.device.type == "cuda":
            torch.cuda.synchronize()

    tok, pos = first_tokens, positions
    outs, ids = [], []
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tok[:, None], "positions": pos},
            window=window)
        outs.append(logits[:, 0].float())
        ids.append(logits[:, 0].argmax(dim=-1))
        tok = ids[-1] if feed is None else feed[:, i]
        pos = pos + 1
    sync()
    secs = time.perf_counter() - t0
    return (torch.stack(outs, 1).cpu().numpy(),
            torch.stack(ids, 1).cpu().numpy(), secs)


@contextlib.contextmanager
def _plain_decode(round_p: bool = True):
    """Kernel 4's decode swapped for its plain version (on the card); with
    ``round_p`` False, the same without rounding the probabilities to the
    cache's type (the kernel keeps them fp32): the witness of what that
    rounding alone moves."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    saved = ops.flash_decode

    def plain(q, k, v, k_pos, cur_pos, *, window=0):
        if round_p:
            return FA.flash_decode_plain(q, k, v, k_pos, cur_pos,
                                         window=window)
        b, _, hq, hd = q.shape
        hkv = k.shape[2]
        qg = q.reshape(b, 1, hkv, hq // hkv, hd).float()
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) / math.sqrt(hd)
        valid = (k_pos >= 0) & (k_pos <= cur_pos[:, None])
        if window:
            valid = valid & (k_pos > cur_pos[:, None] - window)
        s = torch.where(valid[:, None, None, None, :], s, FA.NEG_INF)
        o = torch.einsum("bhrqk,bkhd->bqhrd", torch.softmax(s, dim=-1),
                         v.float())
        return o.reshape(b, 1, hq, hd).to(q.dtype)

    ops.flash_decode = plain
    try:
        yield
    finally:
        ops.flash_decode = saved


def _rel_bar(got, want, tol):
    """Max |got - want| and how far it lies over ``tol · (1 + |want|)``."""
    import numpy as np

    diff = np.abs(got - want)
    return {"max_abs_err": float(diff.max()), "tol": tol,
            "over_bar": float((diff - tol * (1 + np.abs(want))).max())}


def _close_bars(got, want):
    """Max |got - want| and how far it lies over DECODE_BAR."""
    import numpy as np

    diff = np.abs(got - want)
    over = diff - (DECODE_BAR["atol"] + DECODE_BAR["rtol"] * np.abs(want))
    return float(diff.max()), float(over.max())


def _ring_positions(s: int, c: int, steps: int):
    """The slot positions the reference's arithmetic leaves after a
    prefill of ``s`` tokens into ``c`` slots and ``steps`` decode steps:
    prefill writes the last min(s, c) positions into slots [0, take), then
    position p goes to slot p % c."""
    import numpy as np

    pos = np.full(c, -1, np.int64)
    take = min(s, c)
    pos[:take] = np.arange(s - take, s)
    for p in range(s, s + steps):
        pos[p % c] = p
    return pos


def _decode_kernel_row(cache, q_heads, cur, window, calls):
    """Kernel 4's stored-position decode at one layer's real cache: its
    ms for one forward's ``calls`` calls, the plain version's and SDPA's
    (a boolean mask built from the positions, ``enable_gqa``) on the same
    inputs, its error against the plain version, and its bound (bytes:
    the valid slots' K and V, and the positions)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    k, v, k_pos = cache["k"], cache["v"], cache["pos"]
    b, c, hkv, hd = k.shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((b, 1, q_heads, hd), device="cuda",
                    generator=gen).to(k.dtype)
    cur_t = torch.full((b,), cur, dtype=torch.int32, device="cuda")
    valid = (k_pos >= 0) & (k_pos <= cur_t[:, None])
    if window:
        valid = valid & (k_pos > cur_t[:, None] - window)
    n_valid = int(valid.sum())
    got = FA.flash_decode_kernel(q, k, v, k_pos, cur_t, window=window)
    want = FA.flash_decode_plain(q, k, v, k_pos, cur_t, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = valid[:, None, None, :]
    nbytes = 2.0 * n_valid * hkv * hd * k.element_size() \
        + k_pos.numel() * 4 + 2.0 * q.numel() * q.element_size()
    flops = 4.0 * b * q_heads * n_valid * hd
    return dict(
        shape=[b, 1, c, q_heads, hkv, hd], window=window, valid_slots=n_valid,
        calls=calls, max_abs_err=err,
        ms=time_ms(_span(lambda: FA.flash_decode_kernel(
            q, k, v, k_pos, cur_t, window=window), calls)),
        plain_ms=time_ms(_span(lambda: FA.flash_decode_plain(
            q, k, v, k_pos, cur_t, window=window), calls)),
        library_ms=time_ms(_span(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), calls)),
        bound_ms=calls * _bound(flops, nbytes, PEAK_BF16_FLOPS),
        bound_by="operations" if flops / PEAK_BF16_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        bytes=calls * nbytes, flops=calls * flops)


def _ring_case(dtype: str, n_gen: int, witness: bool):
    """One `SERVE_RING` run at ``dtype``: prefill a whole ring, then
    ``n_gen`` greedy steps with the kernel (counters zeroed and read around
    them, timed), the same steps with the plain decode fed the kernel's
    ids, and (``witness``) with the plain decode keeping fp32
    probabilities.  Returns the record, the kernel run's final cache and
    the config."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import SLIDING_WINDOW_500K
    from repro_torch.launch.serve import seeded_inputs
    from repro_torch.models import build_model

    r = SERVE_RING
    window = c = SLIDING_WINDOW_500K
    cfg = dataclasses.replace(get_config(r["arch"]), sliding_window=window,
                              dtype=dtype)
    model = build_model(cfg)
    b, s = r["batch"], c
    torch.cuda.reset_peak_memory_stats()
    params, prompts = seeded_inputs(cfg, b, s, r["seed"], "cuda")
    toks = torch.as_tensor(prompts, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, cache_len=c)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    start = _clone_tree(cache)
    first = logits[:, 0].argmax(dim=-1)
    pos0 = torch.full((b,), s, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        _decode_run(model, params, _clone_tree(start), first, pos0, 2)
        ops.reset_launch_counts()
        k_logits, k_ids, secs = _decode_run(model, params, cache, first,
                                            pos0, n_gen)
        launches, paths = ops.launch_counts(), FA.path_launches()
        peak = torch.cuda.max_memory_allocated()
        feed = torch.as_tensor(k_ids, device="cuda")
        runs = {}
        for name, rnd in (("plain", True), ("fp32_p_plain", False)):
            if name == "fp32_p_plain" and not witness:
                continue
            with _plain_decode(round_p=rnd):
                runs[name] = _decode_run(model, params, _clone_tree(start),
                                         first, pos0, n_gen, feed=feed)[:2]
    del params, start
    p_logits, p_ids = runs["plain"]
    want_pos = _ring_positions(s, c, n_gen)
    out = {"dtype": dtype, "gen": n_gen, "prefill_ms": prefill_s * 1e3,
           "decode_ms_per_step": secs * 1e3 / n_gen,
           "max_memory_allocated": peak, "launches": launches,
           "flash_paths": paths,
           "finite": bool(np.isfinite(k_logits).all()),
           "stored_pos_ok": all(
               bool((lc["b0"]["pos"].cpu().numpy()
                     == want_pos[None, None]).all())
               for lc in cache.values() if "pos" in lc.get("b0", {})),
           "greedy_ids_agree": int((k_ids == p_ids).sum()),
           "greedy_ids": int(k_ids.size),
           "vs_plain": _rel_bar(k_logits, p_logits,
                                SERVE_CROSS["default_tol"]),
           "vs_plain_decode_bars": dict(zip(("max_abs_err", "over_bar"),
                                            _close_bars(k_logits, p_logits))),
           "per_step_err_vs_plain": np.abs(k_logits - p_logits).max(
               axis=(0, 2)).tolist()}
    if witness:
        f_logits, f_ids = runs["fp32_p_plain"]
        out["witness"] = {
            "kernel_vs_fp32_p_plain_bars": _close_bars(k_logits, f_logits),
            "plain_vs_fp32_p_plain_bars": _close_bars(p_logits, f_logits),
            "fp32_p_plain_ids_agree": int((k_ids == f_ids).sum())}
    return out, cache, cfg


def phase_serve_ring(detail):
    """qwen3-1.7b at published widths decoding from a ring cache: window
    and ring of ``SLIDING_WINDOW_500K`` slots, batch 1, a prompt of a whole
    ring, then greedy steps that wrap it, positions on the card.  In bf16
    (`SERVE_RING`'s 64 steps; counters zeroed just before the decode loop
    and read just after: every step's 28 flash launches on the split-KV
    path) the run is timed, and its logits beside the same steps with
    kernel 4's decode swapped for its plain version (fed the kernel's
    ids) are recorded at `DECODE_BAR`, with the witness of what bf16
    rounding alone moves there (the plain version against itself keeping
    fp32 probabilities); the greedy ids that agree are reported.  In fp32
    (`SERVE_RING_FP32_STEPS` steps) the kernel's logits must match the
    plain decode's within ``serve_cross``'s 1e-4 · (1 + |plain|).  Every
    layer's stored positions must equal the reference's ring arithmetic
    in both.  Then kernel 4's decode at this shape on layer 0's bf16
    cache, timed beside its bound, its plain version and SDPA."""
    import torch

    r = SERVE_RING
    bf16, cache, cfg = _ring_case("bfloat16", r["gen"], witness=True)
    layers = _blocks(cfg).count("attn")
    s = cache["l0"]["b0"]["k"].shape[2]
    row = _decode_kernel_row({k: v[0] for k, v in cache["l0"]["b0"].items()},
                             cfg.n_heads, s + r["gen"] - 1,
                             cfg.sliding_window, layers)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    fp32, cache, _ = _ring_case("float32", SERVE_RING_FP32_STEPS,
                                witness=False)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "serve_ring", "arch": r["arch"], "n_layers": cfg.n_layers,
           "batch": r["batch"], "prompt": s, "window": cfg.sliding_window,
           "cache_slots": s, "wraps": (s + r["gen"] - 1) // s,
           **{k: bf16[k] for k in ("gen", "prefill_ms", "decode_ms_per_step",
                                   "max_memory_allocated", "launches",
                                   "flash_paths")},
           "bf16": bf16, "fp32": fp32, "kernel": row}
    emit(out)
    detail["serve_ring"] = out
    for run in (bf16, fp32):
        n = run["gen"]
        check(run["finite"], f"serve_ring {run['dtype']}: non-finite logits")
        check(run["flash_paths"] == {"tc": 0, "split_kv": layers * n,
                                     "fp32": 0},
              f"serve_ring {run['dtype']}: flash paths {run['flash_paths']}"
              f", expected {layers * n} split-KV")
        check(run["stored_pos_ok"], f"serve_ring {run['dtype']}: stored "
              "positions differ from the ring's")
    check(fp32["vs_plain"]["over_bar"] <= 0, "serve_ring fp32: logits "
          f"{fp32['vs_plain']['max_abs_err']} off the plain decode's")
    check(fp32["greedy_ids_agree"] == fp32["greedy_ids"],
          "serve_ring fp32: greedy ids differ from the plain decode's")
    check(row["max_abs_err"] <= FLASH_TOL["bfloat16"],
          f"serve_ring: decode kernel {row['max_abs_err']} off its plain")
    return out


def _prefill_rows(model, params, prompts, slots, dev):
    """Each prompt prefilled alone into a cache of ``slots``; returns
    their last logits [B, V] and one batch cache holding prompt i's cache
    in row i (leaves ``[R, B, ...]``)."""
    import torch
    from repro_torch.utils.tree import tree_leaves

    batch_cache = model.init_cache(len(prompts), slots, device=dev)
    firsts = []
    for i, p in enumerate(prompts):
        lg, c1 = model.prefill(
            params, {"tokens": torch.as_tensor(p, device=dev)[None]},
            cache_len=slots)
        firsts.append(lg[0, 0])
        for dst, src in zip(tree_leaves(batch_cache), tree_leaves(c1)):
            dst[:, i] = src[:, 0]
    return torch.stack(firsts), batch_cache


def _positions_case(dtype: str, n_gen: int):
    """One `DECODE_POSITIONS` run at ``dtype``: the batch's steps
    (counters zeroed and read around them, timed), then each sequence
    alone at batch 1 fed the batch run's ids.  Returns the record."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import seeded_inputs
    from repro_torch.models import build_model

    r = DECODE_POSITIONS
    cfg = dataclasses.replace(get_config(r["arch"]), dtype=dtype)
    model = build_model(cfg)
    lens = [r["base"] + r["stride"] * i for i in range(r["batch"])]
    torch.cuda.reset_peak_memory_stats()
    params, _ = seeded_inputs(cfg, 1, 1, r["seed"], "cuda")
    rng = np.random.default_rng(r["seed"])
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    with torch.no_grad():
        firsts, cache = _prefill_rows(model, params, prompts, r["slots"],
                                      "cuda")
        pos = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        logits, ids, secs = _decode_run(model, params, cache,
                                        firsts.argmax(-1), pos, n_gen)
        launches, paths = ops.launch_counts(), FA.path_launches()
        peak = torch.cuda.max_memory_allocated()
        feed = torch.as_tensor(ids, device="cuda")
        alone = []
        for i, p in enumerate(prompts):
            _, c1 = _prefill_rows(model, params, [p], r["slots"], "cuda")
            alone.append(_decode_run(
                model, params, c1, firsts[i:i + 1].argmax(-1),
                pos[i:i + 1], n_gen, feed=feed[i:i + 1])[0])
    del params, cache
    alone = np.concatenate(alone)
    return {"dtype": dtype, "gen": n_gen, "prompt_lens": lens,
            "decode_ms_per_step": secs * 1e3 / n_gen,
            "max_memory_allocated": peak, "launches": launches,
            "flash_paths": paths, "finite": bool(np.isfinite(logits).all()),
            "vs_alone": _rel_bar(logits, alone, SERVE_CROSS["default_tol"]),
            "vs_alone_decode_bars": dict(zip(("max_abs_err", "over_bar"),
                                             _close_bars(logits, alone))),
            "per_row_err": np.abs(logits - alone).max(axis=(1, 2)).tolist()}


def phase_decode_positions(detail):
    """qwen3-1.7b at published widths, 8 sequences each at its own
    position: sequence i prefilled alone at 384 + 16·i tokens into row i
    of a 576-slot batch cache, then greedy steps taken together (the
    decode counters zeroed and read around them).  Each row's logits
    beside the same sequence decoded alone at batch 1 on the card, fed the
    batch run's ids: in bf16 (32 steps, timed) recorded at `DECODE_BAR`;
    in fp32 (8 steps) held at ``serve_cross``'s 1e-4 · (1 + |alone|)."""
    import torch
    from repro_torch.config import get_config

    runs = {}
    for dtype, n_gen in (("bfloat16", DECODE_POSITIONS["gen"]),
                         ("float32", DECODE_POSITIONS_FP32_STEPS)):
        runs[dtype] = _positions_case(dtype, n_gen)
        gc.collect()
        torch.cuda.empty_cache()
    bf16, fp32 = runs["bfloat16"], runs["float32"]
    layers = _blocks(get_config(DECODE_POSITIONS["arch"])).count("attn")
    out = {"phase": "decode_positions", "arch": DECODE_POSITIONS["arch"],
           "batch": DECODE_POSITIONS["batch"],
           "cache_slots": DECODE_POSITIONS["slots"],
           **{k: bf16[k] for k in ("prompt_lens", "gen",
                                   "decode_ms_per_step",
                                   "max_memory_allocated", "launches",
                                   "flash_paths")},
           "bf16": bf16, "fp32": fp32}
    emit(out)
    detail["decode_positions"] = out
    for run in (bf16, fp32):
        check(run["finite"], f"decode_positions {run['dtype']}: non-finite")
        check(run["flash_paths"] == {"tc": 0,
                                     "split_kv": layers * run["gen"],
                                     "fp32": 0},
              f"decode_positions {run['dtype']}: paths {run['flash_paths']}")
    check(fp32["vs_alone"]["over_bar"] <= 0, "decode_positions fp32: a "
          f"row's logits off its own run by {fp32['vs_alone']}")
    return out


def _serve_cross_decode_cases(model, on_card, on_cpu, tol):
    """`SERVE_CROSS_RING` and `SERVE_CROSS_POSITIONS` card against CPU:
    each side's logits from the same prompts, the card teacher-forced
    with the CPU's ids; returns each case's errors (`_errors`)."""
    import numpy as np
    import torch

    res = {}
    rc = SERVE_CROSS_RING
    rng = np.random.default_rng(SERVE_CROSS["seed"])
    prompt = rng.integers(0, model.cfg.vocab_size, (1, rc["prompt"]))
    runs = {}
    for side, params, dev in (("cpu", on_cpu, "cpu"),
                              ("card", on_card, "cuda")):
        with torch.no_grad():
            lg, cache = model.prefill(
                params, {"tokens": torch.as_tensor(prompt, device=dev)},
                cache_len=rc["window"], window=rc["window"])
            feed = None if side == "cpu" else torch.as_tensor(
                runs["cpu"][1], device=dev)
            first = lg[:, 0].argmax(-1) if side == "cpu" else \
                torch.as_tensor(runs["cpu"][2], device=dev)
            logits, ids, _ = _decode_run(
                model, params, cache, first,
                torch.full((1,), rc["prompt"], dtype=torch.int32,
                           device=dev), rc["gen"], feed=feed,
                window=rc["window"])
        runs[side] = (np.concatenate([lg[:, :1].float().cpu().numpy(),
                                      logits], 1), ids,
                      lg[:, 0].argmax(-1).cpu().numpy())
    res["ring"] = {**_errors(runs["card"][0], runs["cpu"][0], tol),
                   "window": rc["window"], "prompt": rc["prompt"],
                   "gen": rc["gen"],
                   "ids_equal": bool((runs["card"][1]
                                      == runs["cpu"][1]).all())}
    pc = SERVE_CROSS_POSITIONS
    prompts = [rng.integers(0, model.cfg.vocab_size, n)
               for n in pc["lengths"]]
    runs = {}
    for side, params, dev in (("cpu", on_cpu, "cpu"),
                              ("card", on_card, "cuda")):
        with torch.no_grad():
            firsts, cache = _prefill_rows(model, params, prompts,
                                          pc["slots"], dev)
            feed = None if side == "cpu" else torch.as_tensor(
                runs["cpu"][1], device=dev)
            first = firsts.argmax(-1) if side == "cpu" else \
                torch.as_tensor(runs["cpu"][2], device=dev)
            logits, ids, _ = _decode_run(
                model, params, cache, first,
                torch.as_tensor(pc["lengths"], dtype=torch.int32,
                                device=dev), pc["gen"], feed=feed)
        runs[side] = (np.concatenate([firsts[:, None].float().cpu().numpy(),
                                      logits], 1), ids,
                      firsts.argmax(-1).cpu().numpy())
    res["positions"] = {**_errors(runs["card"][0], runs["cpu"][0], tol),
                        "lengths": list(pc["lengths"]), "gen": pc["gen"],
                        "ids_equal": bool((runs["card"][1]
                                           == runs["cpu"][1]).all())}
    return res


def phase_dryrun(detail, spmd, serve_ring):
    """`launch.dryrun` on the host mesh (1 x 1), on ``meta`` (no card):
    the count of ``spmd``'s step (qwen3-1.7b, N=2, cut 1, b=4, S=512,
    Adam, remat off) and of ``serve_ring``'s decode step (the long_500k
    combo: batch 1, a ring of 8192 under a window of 8192), each combo's
    FLOPs, bytes, roofline terms, model FLOPs share and predicted
    per-device bytes printed beside the phase's measured seconds and
    peak, with the card's name and power limit."""
    import torch
    from repro_torch.config import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh

    host = make_host_mesh()
    t0 = time.perf_counter()
    shape = InputShape("spmd", SPMD["seq"],
                       SPMD["n_clients"] * SPMD["batch"], "train")
    combos = {
        "spmd": (DR.run_combo(SPMD["arch"], "train_4k", False, mesh=host,
                              shape=shape, n_clients=SPMD["n_clients"],
                              cut_reps=SPMD["cut_reps"], grad_accum=1,
                              remat=False, optimizer_name="adam"),
                 spmd["runs"][0]["steady_seconds_per_step"],
                 spmd["runs"][0]["peak_gb"] * 1e9),
        "serve_ring": (DR.run_combo(SERVE_RING["arch"], "long_500k", False,
                                    mesh=host),
                       serve_ring["decode_ms_per_step"] / 1e3,
                       serve_ring["max_memory_allocated"])}
    out = {"phase": "dryrun", "seconds": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": detail.get("gpu")}
    for name, (rec, measured_s, peak) in combos.items():
        rf = rec["roofline"]
        out[name] = {"status": rec["status"], "flops": rf["flops"],
                     "bytes": rf["hbm_bytes"],
                     "t_compute_s": rf["t_compute_s"],
                     "t_memory_s": rf["t_memory_s"],
                     "t_collective_s": rf["t_collective_s"],
                     "bottleneck": rf["bottleneck"],
                     "model_flops_share": rf["useful_flops_frac"],
                     "predicted_per_device_bytes": rec["per_device_bytes"],
                     "measured_s": measured_s,
                     "measured_peak_bytes": peak,
                     "roofline_s_over_measured": max(
                         rf["t_compute_s"], rf["t_memory_s"],
                         rf["t_collective_s"]) / measured_s}
    emit(out)
    detail["dryrun"] = out
    for name in combos:
        check(out[name]["status"] == "ok" and out[name]["flops"] > 0,
              f"dryrun {name}: {out[name]['status']}")
    return out


def _engine_launches(engines, name) -> dict:
    """A kernel's launches in the engines phase, by policy and engine."""
    return {pname: {e: rec[e]["launches"][name]
                    for e in ("scan", "vectorized", "legacy")}
            for pname, rec in engines["policies"].items()}


def _token_launches(name, grid_lm, mesh_lm, dynamic_lm) -> dict:
    """A kernel's launches in the token phases of the grid runner (folded
    and one cell after another), mesh mode and the dynamic edge."""
    return {"launches_grid_lm": grid_lm["launches"][name],
            "launches_grid_lm_sequential":
                grid_lm["sequential"]["launches"][name],
            "launches_mesh_lm": mesh_lm["launches"][name],
            "launches_dynamic_lm": dynamic_lm["launches"][name]}


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
    phase_grad_moments()
    mesh = phase_mesh()
    phase_cross_device()
    phase_mesh_cross()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()  # the mesh phases' world of one
    phase_grid_cross(detail)
    grid = phase_grid(detail)
    scenario = phase_scenario(detail)
    traffic = phase_traffic(detail)
    phase_dynamic_cross(detail)
    phase_token_families(detail)
    phase_cli(detail)
    engines = phase_engines(detail)
    phase_engines_cross(detail)
    gc.collect()
    torch.cuda.empty_cache()
    train_lm, lm_seen = phase_train_lm(detail)
    clip_round = _clip_round_checks(lm_seen.pop("clip").get(TRAIN_LM["rounds"]))
    gc.collect()
    torch.cuda.empty_cache()
    spmd, spmd_seen = phase_spmd(detail)
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_seen = phase_train_moe(detail)
    families, families_seen = phase_train_families(detail)
    train_xlstm, xlstm_seen = phase_train_xlstm(detail)
    gc.collect()
    torch.cuda.empty_cache()
    xlstm_session, session_seen, session_scans = phase_xlstm_session(detail)
    from repro_torch.config import get_config

    witnesses = {"train_lm": (lm_seen,
                              get_config(TRAIN_LM["arch"]).n_layers),
                 "spmd": (spmd_seen, get_config(SPMD["arch"]).n_layers),
                 "train_moe": (moe_seen, TRAIN_MOE["attn_calls"]),
                 **{r["name"]: (families_seen[r["name"]], r["attn_calls"])
                    for r in TRAIN_FAMILY_SPMD},
                 "internvl2_session": (
                     families_seen["internvl2_session"],
                     get_config(TRAIN_VLM["arch"]).n_layers),
                 # the mLSTM scans a step (xlstm has no attention)
                 "train_xlstm": (xlstm_seen, TRAIN_XLSTM["scans"]),
                 "xlstm_session": (session_seen, session_scans)}
    flash_bwd, norm_bwd, mlstm_bwd = phase_kernels_train(detail, witnesses,
                                                         clip_round)
    del lm_seen, spmd_seen, moe_seen, families_seen, xlstm_seen, \
        session_seen, witnesses
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_cross(detail)
    phase_cli_spmd(detail)
    gc.collect()
    torch.cuda.empty_cache()
    grid_lm = phase_grid_lm(detail)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_lm, ext_round, ext_keep_round = phase_mesh_lm(detail)
    gc.collect()
    torch.cuda.empty_cache()
    dynamic_lm = phase_dynamic_lm(detail)
    # a simulator refers to itself (its segment function is a bound
    # method), so the earlier phases' sessions and their device tensors
    # go only with a collection: free them before serving's peak is read
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve("qwen3-1.7b", "serve")
    serve_ssm = phase_serve("xlstm-350m", "serve_ssm")
    serves = {name: phase_serve(arch, name, layers)
              for name, arch, layers in FAMILY_SERVES}
    serve_ring = phase_serve_ring(detail)
    decode_positions = phase_decode_positions(detail)
    phase_serve_cross()
    phase_dryrun(detail, spmd, serve_ring)

    launches = train["launches"]
    kernels = [
        {"name": "batched_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/batched_matmul.cu",
         "replaces": "src/repro/kernels/batched_conv.py:63",
         "launches": launches["batched_matmul"],
         "launches_grid": grid["launches"]["batched_matmul"],
         "launches_scenario": scenario["launches"]["batched_matmul"],
         "launches_traffic": traffic["launches"]["batched_matmul"],
         "launches_engines": _engine_launches(engines, "batched_matmul"),
         "max_abs_err": gemm["max_abs_err"], "ms": gemm["ms"],
         "plain_ms": gemm["plain_ms"], "bound_ms": gemm["bound_ms"],
         "bound_by": gemm["bound_by"], "library_ms": gemm["library_ms"],
         # the per-round engines' GEMMs: one legacy client (N=1, b=64)
         # and a vectorized b_max of 24 (N=8), each a round's shapes
         **{key: {k: gemm[key][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}
            for key in ("legacy_n1_b64", "vectorized_n8_b24")}},
        {"name": "clip_sgd", "route": "cuda",
         "source": "src/repro_torch/csrc/clip_sgd.cu",
         "replaces": "src/repro/kernels/clip_sgd.py:29",
         "launches": launches["clip_sgd"],
         "launches_grid": grid["launches"]["clip_sgd"],
         "launches_scenario": scenario["launches"]["clip_sgd"],
         "launches_traffic": traffic["launches"]["clip_sgd"],
         "launches_engines": _engine_launches(engines, "clip_sgd"),
         "max_abs_err": clip["max_abs_err"], "ms": clip["ms"],
         "device_ms": clip["device_ms"],
         "plain_ms": clip["plain_ms"], "bound_ms": clip["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "launches_train_lm": train_lm["launches"]["clip_sgd"],
         **_token_launches("clip_sgd", grid_lm, mesh_lm, dynamic_lm),
         "launches_internvl2_session":
             families["internvl2_session"]["launches"]["clip_sgd"],
         "token_round": {k: clip_round[k] for k in (
             "leaves", "bf16_leaves", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms")}},
        {"name": "clip_sgd_ext", "route": "cuda",
         "source": "src/repro_torch/csrc/clip_sgd.cu",
         "replaces": "src/repro/kernels/clip_sgd.py:44",
         "launches": mesh["launches"]["clip_sgd_ext"],
         **_token_launches("clip_sgd_ext", grid_lm, mesh_lm, dynamic_lm),
         # mesh_lm's aggregation round (every leaf takes the mean) and
         # the round before it (the client-specific leaves keep)
         **{key: {k: r[k] for k in (
             "leaves", "bf16_leaves", "keeping_leaves", "launches",
             "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")}
            for key, r in (("token_round", ext_round),
                           ("token_keeping_round", ext_keep_round))},
         "bf16_max_abs_err": ext["bf16_max_abs_err"],
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
         # the stored-position decode from a wrapped ring (serve_ring) and
         # at per-sequence positions (decode_positions): launches by path,
         # and the kernel at serve_ring's shape on its real cache
         "launches_serve_ring": serve_ring["flash_paths"],
         "launches_decode_positions": decode_positions["flash_paths"],
         "serve_ring_decode": {
             "launches": serve_ring["flash_paths"]["split_kv"],
             **{k: serve_ring["kernel"][k] for k in (
                 "shape", "window", "valid_slots", "calls", "max_abs_err",
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
         "launches_families": {name: r["launches"]["flash_attention"]
                               for name, r in serves.items()},
         "launches_train_moe": moe["launches"]["flash_attention"],
         **_token_launches("flash_attention", grid_lm, mesh_lm, dynamic_lm),
         "launches_train_families": {
             name: r["launches"]["flash_attention"]
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
                               for name, r in serves.items()},
         "launches_train_moe": moe["launches"]["rmsnorm"],
         **_token_launches("rmsnorm", grid_lm, mesh_lm, dynamic_lm),
         "launches_train_families": {name: r["launches"]["rmsnorm"]
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
             "recurrence_bound_ms")},
         # the training forward (with a_t and m_t): its launches in
         # train_xlstm's runs (remat off, on) and in xlstm_session
         "launches_train_xlstm": [r["launches"]["mlstm_scan"]
                                  for r in train_xlstm["runs"]],
         "launches_xlstm_session": xlstm_session["launches"]["mlstm_scan"]},
        # kernel 6's backward at the shape of train_xlstm's step (all of
        # its scans), xlstm_session's shapes under "shapes"
        {"name": "mlstm_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_scan_bwd.cu",
         "replaces": "src/repro/kernels/mlstm_scan.py:24",
         "launches": train_xlstm["launches"]["mlstm_scan_bwd"],
         "launches_by_path": train_xlstm["runs"][0]["mlstm_bwd_paths"],
         "launches_train_xlstm_remat":
             train_xlstm["runs"][1]["launches"]["mlstm_scan_bwd"],
         "launches_xlstm_session":
             xlstm_session["launches"]["mlstm_scan_bwd"],
         "max_abs_err": mlstm_bwd["max_abs_err"],
         **{k: v for k, v in next(
             r for r in mlstm_bwd["train_xlstm"] if r["heaviest"]).items()
            if k in ("shape", "calls", "ms", "device_ms", "fwd_stats_ms",
                     "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "workspace_bytes", "launches_a_call")},
         "shapes": [{k: v for k, v in r.items() if k in (
             "shape", "calls", "launches_at_shape", "ms", "device_ms",
             "plain_ms", "bound_ms", "bound_by")} | {"run": run}
             for run in ("train_xlstm", "xlstm_session")
             for r in mlstm_bwd.get(run, [])
             if run != "train_xlstm" or not r["heaviest"]]},
        # kernels 4's and 5's backward at the shape that carries most of
        # train_lm's work (as the run recorded it), every other recorded
        # shape of the training phases under "shapes"; launches in
        # train_lm, per round, in spmd, train_moe and each family run
        *[{"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           "launches": train_lm["launches"][name],
           "launches_per_round": train_lm["launches_per_round"][name],
           "launches_spmd": spmd["launches"][name],
           "launches_train_moe": moe["launches"][name],
           **_token_launches(name, grid_lm, mesh_lm, dynamic_lm),
           "launches_train_families": {
               run: r["launches"][name] for run, r in families.items()},
           "max_abs_err": rows["max_abs_err"],
           **{k: v for k, v in next(
               r for r in rows["train_lm"] if r["heaviest"]).items()
              if k in ("shape", "groups", "calls", "ms", "device_ms",
                       "host_ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms", "fwd_lse_ms", "launches_a_call")},
           "shapes": [{k: v for k, v in r.items() if k in (
               "shape", "groups", "calls", "launches_at_shape", "ms",
               "device_ms", "host_ms", "plain_ms", "bound_ms",
               "library_ms")}
               | {"run": run}
               for run in rows if run != "max_abs_err" for r in rows[run]
               if run != "train_lm" or not r["heaviest"]]}
          for name, source, replaces, rows in (
              ("flash_attention_bwd",
               "src/repro_torch/csrc/flash_attention_bwd.cu",
               "src/repro/kernels/flash_attention.py:31", flash_bwd),
              ("rmsnorm_bwd", "src/repro_torch/csrc/rmsnorm.cu",
               "src/repro/kernels/rmsnorm.py:11", norm_bwd))],
    ]
    detail["kernels"] = kernels
    detail["train"] = train
    detail["mesh"] = mesh
    detail["serve"] = serve
    detail["serve_ssm"] = serve_ssm
    detail.update(serves)
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
