"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Set-up (imports, kernel builds on a checkout's first run, the
seeded weights, the server's profile and graph captures, warm-up ticks)
is timed as ``setup_s``; then ticks run back to back for ``--seconds``.
``--trace 1`` adds a traced stretch of whole ticks after the window and
reports the per-layer metrics instead of the end-to-end ones.  The last
line of standard output is the result as one JSON object; the numbers
compared to decide ``correct`` are the last lines of standard error.

Exits non-zero without a result where CUDA or the cell's cards are
missing, where the program under test cannot be imported, and where the
JAX package or JAX itself is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    """Parse the arguments, run the cell, print the result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    try:
        import torch
    except ImportError as e:
        print(f"no torch: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: no result", file=sys.stderr)
        return 2
    try:
        from perfbench import harness
        chips = harness.Bench(ROOT).cell(args.workload)["chips"]
        import repro_torch  # noqa: F401
    except (ImportError, KeyError, OSError) as e:
        print(f"cannot run {args.workload}: {e!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible: no result",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), root=ROOT,
                              t_start=T_START)
    if result is None:
        return 4
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {found}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
