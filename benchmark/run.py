"""Run one cell of the benchmark of `qtos_torch` on this machine's card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Prints the numbers compared with the plain reference as the last lines of
standard error and one JSON object as the last line of standard output.
Exits non-zero, printing no result, without a CUDA device (it never falls
back to the CPU) or without the program in the checkout.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here, before any import

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # import the benchmark as a package from the checkout's root
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from benchmark import harness

    return harness.run(args, T0)


if __name__ == "__main__":
    sys.exit(main())
