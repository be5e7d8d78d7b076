"""Read the numbers that decide ``correct`` over many seeds, for the
program and for its control, to set a cell's limits from.

    python3 perfbench/limits.py --workload <name> --seeds 1,2,3 \
        --seconds <s>

In one process, for each seed: one run of the cell with a short window at
the cell's own load, then the comparison for the program and for the
control (the reference in float8 products in place of the model, the
reference controller in float32 in place of the program's), each judged
by the same comparison against the cell's limits.  One JSON line a seed
on standard output: each side's ``correct`` and every number it read.  A
limit lies above the largest program reading and below the smallest
control reading (``perfbench/README.md``).  The benchmark's own runs never
run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    """Run every seed and print its readings."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             root=ROOT, device=args.device,
                             t_start=t0,
                             control=True)
        line = {"workload": args.workload, "seed": seed,
                "correct": r["correct"], "numbers": r["numbers"],
                "control_correct": r["control"]["correct"],
                "control_numbers": r["control"]["numbers"],
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
