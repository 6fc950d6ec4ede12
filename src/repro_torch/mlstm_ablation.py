"""Where the mLSTM scan backward's time goes on the card, launch by launch.

    PYTHONPATH=src python3 -m repro_torch.mlstm_ablation --bwd [--out FILE]
        [--save DIR | --against DIR]

Times kernel 6's backward (`mlstm_scan_bwd_kernel`, ``csrc/mlstm_scan_bwd.cu``)
at the shapes the training phases of `chip_smoke.py` recorded
(`BWD_SHAPES`: xlstm-350m's `train_xlstm` step, 8 × 512 tokens, and its
`xlstm_session` round, 64 × 64; 4 heads of 512, bf16, N(0, 1) gates): one
call's device time from a CUDA graph (``device_ms``), a step's calls
(``calls`` × that), and each launch of the call by kernel name, device
only, read by the profiler from the graph's replays
(`repro_torch.timing.launch_split`), beside the bound (q, k, v, h, dh read
and dq, dk, dv written once in bf16, the gates, a, m, di, df in fp32,
against 5 products of hd per causal pair at the bf16 peak).  Prints one
JSON line with the card's name and power limit (and writes it to
``FILE``).  It goes through the wrapper alone, so it times whichever
kernel the tree on the path holds.  ``--save DIR`` writes the gradients
of every shape and of `CHECK_CASES` (fp32, and extreme gates), from
inputs made on the host from fixed seeds; ``--against DIR`` computes them
again and reports, gradient by gradient, whether they equal the saved
ones bitwise (one tree's kernel against another's, on one card), beside
each gradient's largest difference from `mlstm_scan_bwd_plain` over its
largest magnitude.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import mlstm_scan as MS
from repro_torch.timing import graph_ms, launch_split

PEAK_BYTES = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor cores (the same)
# (role, b, s, heads, hd, calls a step or round)
BWD_SHAPES = [("train_xlstm", 8, 512, 4, 512, 20),
              ("xlstm_session", 64, 64, 4, 512, 5)]
# further (b, s, heads, hd, dtype, gates) held against a saved run: the
# fp32 path and extreme gates (forget pre-activations of ±30, input ones
# at -1e30 on the first steps and 30 % of the rest) at hd 512, the small
# head dims
CHECK_CASES = [(2, 64, 4, 512, "float32", "normal"),
               (2, 256, 4, 512, "float32", "extreme"),
               (2, 256, 4, 512, "bfloat16", "extreme"),
               (2, 100, 2, 32, "bfloat16", "normal"),
               (1, 96, 4, 64, "bfloat16", "normal"),
               (2, 160, 2, 128, "bfloat16", "normal"),
               (1, 200, 2, 256, "bfloat16", "normal")]
REPLAYS = 10
NAMES = ("dq", "dk", "dv", "di", "df")


def _inputs(b, s, h, hd, dtype, gates, seed):
    """The backward's inputs on the card, drawn on the host from ``seed``
    (so two processes draw the same), with the forward's h, a and m."""
    gen = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, h, hd), generator=gen).to(dt).cuda()
               for _ in range(3))
    ig, fg = (torch.randn((b, s, h), generator=gen) for _ in range(2))
    if gates == "extreme":
        fg = torch.where(torch.rand((b, s, h), generator=gen) < 0.5, 30.0,
                         -30.0)
        ig = torch.where(torch.rand((b, s, h), generator=gen) < 0.3,
                         -1e30, ig * 5)
        ig[:, :3] = -1e30
    ig, fg = ig.cuda(), fg.cuda()
    hh, a, m = MS.mlstm_scan_kernel(q, k, v, ig, fg, stats=True)
    dh = torch.randn(hh.shape, generator=gen).to(dt).cuda()
    return (q, k, v, ig, fg, hh, a, m, dh)


def _held(name: str, ins, save, against) -> dict:
    """The gradients of ``ins``: saved, or held against the saved ones
    bitwise, and against the plain version."""
    got = MS.mlstm_scan_bwd_kernel(*ins)
    row = {}
    if save is not None:
        torch.save([g.cpu() for g in got], save / f"{name}.pt")
    if against is not None:
        old = torch.load(against / f"{name}.pt")
        row["bitwise"] = {n: bool(torch.equal(g.cpu(), o))
                          for n, g, o in zip(NAMES, got, old)}
    want = MS.mlstm_scan_bwd_plain(*ins)
    row["err_over_max"] = {
        n: float((g.double() - w.double()).abs().max()
                 / w.double().abs().max().clamp_min(1e-30))
        for n, g, w in zip(NAMES, got, want)}
    row["finite"] = all(bool(torch.isfinite(g).all()) for g in got)
    return row


def main_bwd(smi: str, save=None, against=None) -> dict:
    """The backward at `BWD_SHAPES`: one call's device ms and launches;
    with ``save`` or ``against`` also every case's gradients."""
    rows = []
    for i, (role, b, s, h, hd, calls) in enumerate(BWD_SHAPES):
        ins = _inputs(b, s, h, hd, "bfloat16", "normal", i)

        def call():
            MS.mlstm_scan_bwd_kernel(*ins)

        split = launch_split(call, REPLAYS)
        one = graph_ms(call, 1, REPLAYS)
        flops = 10.0 * hd * s * (s + 1) / 2 * b * h
        nbytes = 8.0 * b * s * h * hd * 2 + 24.0 * b * s * h
        rows.append(dict(
            role=role, shape=[b, s, h, hd, "bfloat16"], calls=calls,
            device_ms=one, step_device_ms=calls * one,
            launches_by_kernel=split,
            launches=sum(r["launches"] for r in split.values()),
            bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            workspace_bytes=MS.bwd_workspace_bytes(b, s, h)))
        if save is not None or against is not None:
            rows[-1]["held"] = _held(role, ins, save, against)
        del ins
    report = {"gpu": smi, "backward": rows}
    if save is not None or against is not None:
        report["cases"] = [
            dict(case=list(c), held=_held(f"case{j}", _inputs(*c, 100 + j),
                                          save, against))
            for j, c in enumerate(CHECK_CASES)]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true", required=True,
                    help="the backward (the one mode)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    held = ap.add_mutually_exclusive_group()
    held.add_argument("--save", type=Path, default=None,
                      help="write every case's gradients into this dir")
    held.add_argument("--against", type=Path, default=None,
                      help="hold every case's gradients against this dir's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlstm_ablation needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.save is not None:
        args.save.mkdir(parents=True, exist_ok=True)
    line = json.dumps(main_bwd(smi, args.save, args.against))
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
