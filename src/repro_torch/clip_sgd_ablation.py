"""The fused clip+SGD update's device time at the VGG-16 leaf sizes, plan by
plan.

    PYTHONPATH=src python3 -m repro_torch.clip_sgd_ablation [--out FILE]

For each of the 16 distinct VGG-16 leaf sizes, and for a whole round's 32
leaves in one launch, times ``csrc/clip_sgd.cu`` under every plan its entry
point takes — R, the rows a thread streams at once (1, 2, 4, 8), and V, the
column vectors a thread owns in a chunk (1, 2) — in four forms: the flat
update with every client keeping (elementwise, 12·N·D bytes) and with none
keeping (the client mean, 12·N·D bytes) at N=8, and the external-mean
update at N=16 with every client keeping (12·N·D bytes) and on the
aggregation round (every row written from the mean, 4·N·D + 4·D bytes).
A time is the mean of
``CALLS`` calls replayed from one CUDA graph (no host launch time), the
calls cycling through copies of the leaves that together exceed the 50 MB
L2, as a round's update finds its leaves cold.  Prints one JSON line with
the card's name and power limit, the plan the wrapper uses and the bytes
bound of each row (and writes it to ``FILE``).  Needs a card and
``nvcc``.  The plans are launched through the kernel's C entry point
directly, so nothing here counts as a launch of the port's main path.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import clip_sgd as CS
from repro_torch.kernels.launch import raw_stream
from repro_torch.timing import graph_ms

CALLS = 20
COLD_BYTES = 128 << 20  # leaves a span cycles through: more than the L2
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
GAMMA = 0.05
PLANS = [(r, v) for v in (1, 2) for r in (1, 2, 4, 8)]
FORMS = {  # name: (N, external mean, keep_spec)
    "flat_keep": (8, False, True),
    "flat_mean": (8, False, False),
    "ext_keep": (16, True, True),
    "ext_mean": (16, True, False),
}


def vgg16_leaf_sizes():
    """Per-client sizes of the 32 VGG-16 parameter leaves (b, w per unit)."""
    sizes, cin = [], 3
    for c in (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512):
        sizes += [c, 9 * cin * c]
        cin = c
    for f_in, f_out in ((512, 512), (512, 512), (512, 10)):
        sizes += [f_out, f_in * f_out]
    return sizes


def _time(sizes, n, ext, keep_spec, gen):
    """{plan: device ms of one launch} over leaves of ``sizes`` at N=n, and
    the bytes bound in ms."""
    total = float(sum(sizes))
    per_copy = 8.0 * n * total
    copies = max(1, min(CALLS, -(-COLD_BYTES // int(per_copy))))
    scale = torch.rand(n, device="cuda", generator=gen) * 0.9 + 0.1
    inputs = []
    for _ in range(copies):
        ps = [torch.randn((n, d), device="cuda", generator=gen)
              for d in sizes]
        gs = [torch.randn((n, d), device="cuda", generator=gen)
              for d in sizes]
        commons = [torch.randn(d, device="cuda", generator=gen)
                   for d in sizes] if ext else None
        inputs.append((ps, gs, commons))
    count = torch.full((1,), float(n), device="cuda")
    fn = CS.symbol()
    index = torch.cuda.current_device()
    times = {}
    for r, v in PLANS:
        code = CS.plan_code(r, v)
        tabs = [CS.tables(ps, gs, scale, [keep_spec] * len(sizes),
                          gamma=GAMMA, commons=commons, use=count,
                          use_is_count=True, vectors=v)[0]
                for ps, gs, commons in inputs]

        def span(tabs=tabs, code=code):
            stream = raw_stream(index)    # the capture stream in a capture
            for i in range(CALLS):
                for tab in tabs[i % len(tabs)]:
                    err = fn(ctypes.byref(tab), code, stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}, plan "
                                           f"{code:#x}")

        times[f"r{r}_v{v}"] = graph_ms(span) / CALLS
    nbytes = 4.0 * n * total + 4.0 * total if ext and not keep_spec \
        else 12.0 * n * total
    return times, copies, nbytes / PEAK_BYTES * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("clip_sgd_ablation needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sizes = vgg16_leaf_sizes()
    rows = []
    for form, (n, ext, keep_spec) in FORMS.items():
        for d in sorted(set(sizes)) + ["round"]:
            leaves = sizes if d == "round" else [d]
            times, copies, bound = _time(leaves, n, ext, keep_spec, gen)
            rows.append(dict(form=form, n=n, d=d, input_copies=copies,
                             device_ms=times, bound_ms=bound))
            torch.cuda.empty_cache()
    line = json.dumps({"gpu": smi, "calls": CALLS,
                       "picked": f"r{CS.ROWS}_v{CS.VECTORS}", "rows": rows})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
