"""RMSNorm's device time at the serving shapes, plan by plan.

    PYTHONPATH=src python3 -m repro_torch.rmsnorm_ablation [--out FILE]

For each norm shape of one qwen3-1.7b forward (prefill of 8 × 512 tokens
and one decode step, bf16) times ``csrc/rmsnorm.cu`` under every plan its
entry point takes with 16-byte vectors — threads a row from 1 to 1024, the
vectors a thread holds that follow, one warp or 256 threads a block — as
20 calls replayed from one CUDA graph (no host launch time; the calls
cycle through copies of the input that together exceed the 50 MB L2, as
a forward's norms read fresh activations), beside the
plan `rmsnorm_plan` picks, ``F.rms_norm`` and the bytes bound.  Prints one
JSON line with the card's name and power limit (and writes it to
``FILE``).  Needs a card and ``nvcc``.  The plans are launched through the
kernel's C entry point directly, so nothing here counts as a launch of
the port's main path.

    PYTHONPATH=src python3 -m repro_torch.rmsnorm_ablation --bwd [--out FILE]
        [--save DIR | --against DIR]

times the backward (`rmsnorm_bwd_kernel`, the training paths' gradient)
instead, at the shapes the training phases of `chip_smoke.py` recorded
(`BWD_SHAPES`: `train_lm`'s round and estimate, qwen3-1.7b's `spmd`,
whisper's; bf16): one call's device time from a CUDA graph (``device_ms``)
and each of its launches by name, device only, read by the profiler from
the graph's replays (`repro_torch.timing.launch_split`), beside the bytes
bound (x, dy read and dx written once, the scale read and dscale written
in fp32).  It goes through the wrapper alone, so it times whichever
kernel the tree on the path holds.  ``--save DIR`` writes dx and dscale
of every shape and of `CHECK_CASES` (fp32, single elements, a ragged last
chunk, rows of 512 and 1024 threads, rows past the registers), from inputs
made on the host from fixed seeds; ``--against DIR`` computes them again
and reports whether each equals the saved one bitwise (one tree's kernel
against another's, on one card), beside its largest difference from
`rmsnorm_bwd_plain`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.config import get_config
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels.launch import raw_stream
from repro_torch.timing import graph_ms, launch_split

CALLS = 20
COLD_BYTES = 128 << 20  # inputs a span cycles through: more than the L2
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)


def _shapes():
    """(role, shape, calls in one forward) of qwen3-1.7b's norms."""
    cfg = get_config("qwen3-1.7b")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    out = []
    for role, s in (("prefill", 512), ("decode", 1)):
        # the final norm (one position) has the decode shape
        out += [(role, (8, s, d), 2 * cfg.n_layers + (role == "decode")),
                (role, (8, s, cfg.n_heads, hd), cfg.n_layers),
                (role, (8, s, cfg.n_kv_heads, hd), cfg.n_layers)]
    return out


def _plans(rows: int, d: int, itemsize: int):
    """Every (vec, tpr, nv, rpb) with 16-byte vectors the kernel takes."""
    vec = 16 // itemsize
    nvec = d // vec
    plans, tpr = [], 1
    while tpr <= min(1024, max(nvec, 32)):
        per = -(-nvec // tpr)
        nv = 1 << (per - 1).bit_length()
        if nv <= RN.MAX_VECS:
            for block in {max(32, tpr), max(256, tpr)}:
                plans.append((vec, tpr, nv, block // tpr))
        tpr *= 2
    return plans


# (role, shape, scale groups) of the backward, bf16, as the training
# phases ran it: `train_lm`'s round (N=8 clients of 32 x 128 tokens, a
# scale a client) and its estimate; qwen3-1.7b's `spmd` (the server and
# q/k norms, then a client's); whisper's encoder and decoder
BWD_SHAPES = [("train_lm_round", (8, 32, 128, 576), 8),
              ("train_lm_estimate", (16, 128, 576), 1),
              ("spmd_server", (8, 512, 2048), 1),
              ("spmd_k_norm", (8, 512, 8, 128), 1),
              ("spmd_q_norm", (8, 512, 16, 128), 1),
              ("spmd_client", (2, 4, 512, 2048), 2),
              ("whisper_encoder", (4, 1500, 1024), 1),
              ("whisper_decoder", (4, 128, 1024), 1)]
REPLAYS = 20
# further (shape, scale groups, dtype) held against a saved run: fp32 at
# the round's shape, single elements (d = 50), a group of 100 rows (its
# second chunk 36), dbrx's rows and fp32 rows of 4096 (512 threads a
# row), rows of 1024 threads (16384) and rows past their registers
# (70000, read twice)
CHECK_CASES = [((8, 32, 128, 576), 8, "float32"),
               ((150, 50), 1, "float32"),
               ((3, 100, 64), 3, "bfloat16"),
               ((4, 512, 6144), 1, "bfloat16"),
               ((64, 4096), 1, "float32"),
               ((64, 16384), 1, "bfloat16"),
               ((4, 70000), 2, "bfloat16")]


def _inputs(shape, groups, dtype, seed):
    """x, scale and dy on the card, drawn on the host from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(getattr(torch, dtype)).cuda()
    dy = torch.randn(shape, generator=gen).to(x.dtype).cuda()
    d = shape[-1]
    sc = torch.rand((groups, d) if groups > 1 else (d,), generator=gen)
    return x, sc.cuda(), dy


def _held(name: str, x, sc, dy, save, against) -> dict:
    """dx and dscale: saved, or held against the saved ones bitwise, and
    against the plain version."""
    got = RN.rmsnorm_bwd_kernel(x, sc, dy)
    row = {}
    if save is not None:
        torch.save([g.cpu() for g in got], save / f"{name}.pt")
    if against is not None:
        old = torch.load(against / f"{name}.pt")
        row["bitwise"] = {n: bool(torch.equal(g.cpu(), o))
                          for n, g, o in zip(("dx", "dscale"), got, old)}
    want = RN.rmsnorm_bwd_plain(x, sc, dy)
    row["max_abs_err"] = {n: float((g.float() - w.float()).abs().max())
                          for n, g, w in zip(("dx", "dscale"), got, want)}
    return row


def main_bwd(smi: str, save=None, against=None) -> dict:
    """The backward at `BWD_SHAPES`: one call's device ms and its launches;
    with ``save`` or ``against`` also every case's dx and dscale."""
    rows = []
    for i, (role, shape, groups) in enumerate(BWD_SHAPES):
        x, sc, dy = _inputs(shape, groups, "bfloat16", i)

        def call():
            RN.rmsnorm_bwd_kernel(x, sc, dy)

        split = launch_split(call, REPLAYS)
        nbytes = 3.0 * x.numel() * 2 + 8.0 * sc.numel()
        rows.append(dict(
            role=role, shape=list(shape), groups=groups,
            device_ms=graph_ms(call, 1, REPLAYS), launches_by_kernel=split,
            launches=sum(r["launches"] for r in split.values()),
            bound_ms=nbytes / PEAK_BYTES * 1e3))
        if save is not None or against is not None:
            rows[-1]["held"] = _held(role, x, sc, dy, save, against)
        del x, dy, sc
    report = {"gpu": smi, "backward": rows}
    if save is not None or against is not None:
        report["cases"] = [
            dict(case=[list(c[0]), c[1], c[2]],
                 held=_held(f"case{j}", *_inputs(*c, 100 + j), save,
                            against))
            for j, c in enumerate(CHECK_CASES)]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--bwd", action="store_true",
                    help="the backward at the training shapes instead")
    held = ap.add_mutually_exclusive_group()
    held.add_argument("--save", type=Path, default=None,
                      help="(--bwd) write every case's dx, dscale here")
    held.add_argument("--against", type=Path, default=None,
                      help="(--bwd) hold every case's against this dir's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_ablation needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.bwd:
        if args.save is not None:
            args.save.mkdir(parents=True, exist_ok=True)
        return _emit(main_bwd(smi, args.save, args.against), args.out)
    fn = RN._symbol()
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = get_config("qwen3-1.7b").norm_eps
    rows_out = []
    for role, shape, per_forward in _shapes():
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        copies = min(CALLS, -(-COLD_BYTES // (2 * x.numel() * 2)))
        xs = [x] + [torch.randn_like(x) for _ in range(copies - 1)]
        outs = [torch.empty_like(x) for _ in xs]
        d = shape[-1]
        rows = x.numel() // d
        sc = torch.rand(d, device="cuda", generator=gen)
        want = RN.rmsnorm_plain(x, sc, eps)
        times = {}
        for vec, tpr, nv, rpb in _plans(rows, d, x.element_size()):
            code = RN.plan_code(1, vec, tpr, nv, rpb)

            def span(code=code):
                for i in range(CALLS):
                    j = i % len(xs)
                    err = fn(xs[j].data_ptr(), sc.data_ptr(),
                             outs[j].data_ptr(), rows, d, rows, eps, code,
                             raw_stream(x.device.index))
                    if err:
                        raise RuntimeError(f"CUDA error {err}, plan "
                                           f"{code:#x}")

            ms = graph_ms(span) / CALLS
            torch.testing.assert_close(outs[0].float(), want.float(),
                                       rtol=2e-2, atol=2e-2)
            times[f"tpr{tpr}_nv{nv}_rpb{rpb}"] = ms
        lib_sc = sc.to(x.dtype)
        lib = graph_ms(lambda: [F.rms_norm(xs[i % len(xs)], (d,), lib_sc,
                                            eps)
                                 for i in range(CALLS)]) / CALLS
        picked = RN.rmsnorm_plan(rows, d, x.element_size())
        rows_out.append(dict(
            role=role, shape=list(shape), per_forward=per_forward,
            input_copies=len(xs),
            picked="tpr{1}_nv{2}_rpb{3}".format(*picked),
            ms_per_call=times, library_ms_per_call=lib,
            bound_ms_per_call=(2.0 * x.numel() * 2 + 4.0 * d)
            / PEAK_BYTES * 1e3))
    return _emit({"gpu": smi, "calls": CALLS, "shapes": rows_out}, args.out)


def _emit(report: dict, out) -> int:
    """Print ``report`` as one JSON line (and write it to ``out``)."""
    line = json.dumps(report)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
