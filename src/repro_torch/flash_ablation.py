"""Where the flash-attention kernel's time goes on the card, by ablation.

    PYTHONPATH=src python3 -m repro_torch.flash_ablation [--out DIR]

Builds ``csrc/flash_attention.cu`` as it is and in variants that each
switch part of the tensor-core prefill kernel off (by exact text
substitution of the source, so a variant that no longer applies fails
loudly), and times qwen3-1.7b's prefill shape (8 × 512 tokens, 16/8 heads
of 128, causal, bf16) as 28 calls replayed from one CUDA graph, so host
launch time is out of the numbers:

- ``kernel``: the kernel as it is;
- ``math_only``: no Q or K/V copies (the math on whatever shared memory
  holds);
- ``loads_only``: the copies, barriers and stores, no products and no
  softmax;
- ``one_tile``: every block stops after its first K/V tile;
- ``prologue_only``: every block returns once its Q and first tiles have
  landed;
- ``empty``: every block returns at once (the launch alone).

Beside them ``F.scaled_dot_product_attention`` at the same shape, and for
the decode shape (one token against 513 of 544 cache slots) the split-KV
kernel's device time from a graph against the wrapper's span of 28 calls
(its host path) and SDPA's.  Prints one JSON line with the card's name
and power limit.  Needs a card and ``nvcc``; variants build into ``DIR``
(default ``build/flash_ablation``).  None of the variants is correct
attention: they exist to be timed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.timing import graph_ms

_NO_MATH = [
    ("  auto softmax = [&](int tile) {\n",
     "  auto softmax = [&](int tile) {\n    c_a = c_b = 1.f;\n    return;\n"),
    ("      wgmma_ss_m64n64(s, da, db, kk > 0 ? 1 : 0);",
     "      if (kk < 0) wgmma_ss_m64n64(s, da, db, kk > 0 ? 1 : 0);"),
    ("      if (HDP == 128)\n        wgmma_rs_m64n128_mn(o, p + 4 * kk, db);",
     "      if (false)\n        wgmma_rs_m64n128_mn(o, p + 4 * kk, db);"),
    ("      else\n        wgmma_rs_m64n64_mn(o, p + 4 * kk, db);",
     "      else if (false)\n        wgmma_rs_m64n64_mn(o, p + 4 * kk, db);"),
]
VARIANTS = {
    "kernel": [],
    "math_only": [
        ("      cp16(ks + st + o, k + off, bytes);\n"
         "      cp16(vs + st + o, v + off, bytes);",
         "      if (bytes < 0) {\n        cp16(ks + st + o, k + off, bytes);\n"
         "        cp16(vs + st + o, v + off, bytes);\n      }"),
        ("    cp16(qs + sw_off(i, c, ROWS), src, bytes);",
         "    if (bytes < 0) cp16(qs + sw_off(i, c, ROWS), src, bytes);")],
    "loads_only": _NO_MATH,
    "one_tile": [("  const int n_tiles =\n      kv_end > kv_begin",
                  "  const int n_tiles = kv_end <= kv_begin ? 0 : 1;\n"
                  "  const int all_tiles =\n      kv_end > kv_begin")],
    "prologue_only": [("  wait_tile(0);\n",
                       "  wait_tile(0);\n  if (n_tiles > 0) return;\n")],
    "empty": [("  if (n_tiles == 0) {  // no visible key",
               "  if (n_tiles >= 0) return;\n"
               "  if (n_tiles == 0) {  // no visible key")],
}
CALLS = 28     # one qwen3 prefill's flash calls
REPLAYS = 10   # graph replays a time averages


def _variant_source(subs) -> str:
    src = (build.CSRC / "flash_attention.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"flash_ablation: the source no longer holds "
                               f"{old!r}; update the variant")
        src = src.replace(old, new)
    return src


def _build_all(out_dir: Path) -> dict:
    """Every variant's library, all nvcc processes started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(_variant_source(subs))
        lib = out_dir / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}{out}")
        fn = ctypes.CDLL(str(lib)).repro_flash_attention_tc
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def span_ms(fn, calls: int = CALLS, reps: int = 5) -> float:
    """Milliseconds of ``calls`` eager calls back to back (CUDA events),
    the host's launch path included, as `chip_smoke.py` times a span."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for _ in range(calls):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/flash_ablation")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    fns = _build_all(Path(args.out))
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, hq, hkv, hd = 8, 512, 16, 8, 128
    q = torch.randn((b, s, hq, hd), device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn((b, s, hkv, hd), device="cuda", generator=gen)
            .bfloat16() for _ in range(2))
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    prefill = {}
    for name, fn in fns.items():
        def call(fn=fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, s, s, hq, hkv, hd, 1, 0, s, scale, None,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {name}: CUDA error {err}")
        prefill[name] = graph_ms(call, CALLS, REPLAYS)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    prefill["sdpa"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), CALLS, REPLAYS)

    cache, valid = 544, 513
    q1 = torch.randn((b, 1, hq, hd), device="cuda", generator=gen).bfloat16()
    kc, vc = (torch.randn((b, cache, hkv, hd), device="cuda", generator=gen)
              .bfloat16() for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2) for t in (q1, kc[:, :valid],
                                              vc[:, :valid]))

    # as decode calls it: the positions stored with the cache, on the card
    slots = torch.arange(cache, dtype=torch.int32, device="cuda")
    k_pos = torch.where(slots < valid, slots, -1).expand(b, cache).contiguous()
    cur = torch.full((b,), valid - 1, dtype=torch.int32, device="cuda")

    def decode():
        FA.flash_decode_kernel(q1, kc, vc, k_pos, cur)

    def sdpa():
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)

    report = {"gpu": smi, "calls": CALLS,
              "prefill_graph_ms": prefill,
              "decode": {"kernel_graph_ms": graph_ms(decode, CALLS, REPLAYS),
                         "kernel_span_ms": span_ms(decode),
                         "sdpa_graph_ms": graph_ms(sdpa, CALLS, REPLAYS),
                         "sdpa_span_ms": span_ms(sdpa)}}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
