"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's records on earlier lines and its result as the last line
of standard output; the numbers the check compared, each beside its
limit, are the last lines of standard error.  Needs as many CUDA cards as
the cell asks for: without them it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark "
              "runs on CUDA cards only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                     t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
