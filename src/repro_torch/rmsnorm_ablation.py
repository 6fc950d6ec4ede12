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
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.config import get_config
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels.launch import raw_stream
from repro_torch.timing import graph_ms

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_ablation needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
    line = json.dumps({"gpu": smi, "calls": CALLS, "shapes": rows_out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
