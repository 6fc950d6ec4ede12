"""The readings the output check's limits are set from, on the card.

    python3 simbench/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--variants tf32 half label] [--no-program] [--out FILE]

For each seed it runs the program's first checked rounds through the
timed path (`harness.Run`, no window) and the plain reference, and
prints the numbers `cell.compare` reads (the lower readings); then, for
each variant of `reference.rounds` (the control in the configuration's
next precision down, and the planted faults), the same numbers with that
variant in the program's place (the upper readings).  A state left
unchanged reads 1 on the gradient and change gaps by construction and is
not run.  One JSON line a reading; the last line sums each side up.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--no-program", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from simbench import cell as C
    from simbench.harness import Run
    from simbench.reference.host import HostPlane
    from simbench.reference.params import leaf_names, leaves, make_units
    from simbench.reference.rounds import first_rounds

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = C.load_benchmark(ROOT)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.no_program:
            cell = C.find_cell(bench, args.workload)
            units0 = make_units(cell.ref, cell.arch, seed, "cuda")
            prog = None
        else:
            run = Run(bench, args.workload, seed)
            cell = run.cell
            prog = run.first_rounds()
            units0 = run.units0
            run.free()
        device = leaves(units0)[0].device
        names = leaf_names(units0)
        host = HostPlane(cell.ref, cell.arch, cell.traffic, seed)
        t_ref = time.perf_counter()
        ref = first_rounds(cell.ref, cell.arch, cell.traffic, seed, units0,
                           device, host=host)
        t_ref = time.perf_counter() - t_ref
        if prog is not None:
            rows.append({"seed": seed, "side": "program",
                         **C.compare(prog, ref, names)})
            print(json.dumps(rows[-1]), flush=True)
        for v in args.variants:
            alt = first_rounds(cell.ref, cell.arch, cell.traffic, seed,
                               units0, device, variant=v, host=host)
            rows.append({"seed": seed, "side": v, **C.compare(alt, ref, names)})
            print(json.dumps(rows[-1]), flush=True)
        print(f"control: seed {seed} {time.perf_counter() - t0:.1f} s, "
              f"the reference's rounds {t_ref:.1f} s",
              file=sys.stderr, flush=True)
        del units0
        torch.cuda.empty_cache()
    summary = {}
    for side in {r["side"] for r in rows}:
        mine = [r for r in rows if r["side"] == side]
        summary[side] = {k: [min(r[k] for r in mine), max(r[k] for r in mine)]
                         for k in C.CHECKS}
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
           "summary": summary}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, **out}) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
