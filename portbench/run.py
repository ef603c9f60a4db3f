"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; exits non-zero with no
result without them.  See portbench/README.md."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import manifest
    from portbench.harness.cell import run_cell
    cell = manifest.cell(a.workload, ROOT)
    return run_cell(cell, a.seed, a.seconds, bool(a.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
