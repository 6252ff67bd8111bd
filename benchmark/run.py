"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``:
each compared number beside its limit); the card's name and clocks, the
window's counts and the checks go to standard error.  Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result
and exits 3; where the process holds a module of the JAX stack once the
run is over, it names it on standard error and exits 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_start() -> float:
    """The ``time.perf_counter`` reading of this process's start: its age
    from ``/proc`` (clock ticks since boot), or now where that is not
    readable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = process_start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .harness import CellError, ForbiddenModules, run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except CellError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    except ForbiddenModules as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
