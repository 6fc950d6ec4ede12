"""One run of one cell of the port's benchmark, on the card.

    python3 simbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: it reads ``BENCHMARK.json`` there, the
cell's files under ``simbench/`` and the program under ``src/``.  With
``--trace 0`` the last line of standard output is one JSON object with the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy seconds and the window's, and a breakdown of the device's
time; the numbers the output check compared come last in it and, each
beside its limit, as the last lines of standard error.  Exits 2 without a
result where the card, the cell or the program is missing, and 3 where a
module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# One host thread for the CPU math libraries: the host side of a run (the
# controller's numpy, the estimate's fp64 copies) then does the same work
# the same way in every run, with no thread pools spinning beside it.
THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(THREADS)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from simbench.cell import load_benchmark

    try:
        bench = load_benchmark(ROOT)
    except FileNotFoundError as e:
        print(f"simbench: {e}", file=sys.stderr)
        return 2
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"simbench: no workload {args.workload!r}; known: "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("simbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"simbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"simbench: card {_card_line()}", file=sys.stderr)
    from simbench.harness import run_cell

    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start=T_START)
    leaked = forbidden_modules()
    if leaked:
        print(f"simbench: loaded modules of JAX or the JAX package: "
              f"{leaked}", file=sys.stderr)
        return 3
    readings = out.pop("_readings")
    print(f"simbench: readings {json.dumps(readings)}", file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
