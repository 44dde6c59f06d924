"""The comparison's two readings for a cell, on the card: for each seed, a
run of the program (a short window at the cell's own load) judged as the
benchmark judges it, and the precision control, the plain reference in
bfloat16 put in the program's place, judged by the same numbers.

    python3 -m slambench.control --workload NAME --seconds S --seeds A B C

Prints one JSON line a seed: {"seed", "program": {number: value},
"control": {number: value}, "correct"}. The benchmark's own runs never run
the control. The limits in ``slambench/checks/<workload>.json`` are set
between the largest program reading over a dozen seeds or more and the
smallest control reading (PERF.md gives both).
"""
from __future__ import annotations

import argparse
import json
import sys

from slambench import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for seed in a.seeds:
        run, _, _ = R.measure(a.workload, seed, a.seconds, False,
                              device=a.device, control=True)
        print(json.dumps({
            "seed": seed, "correct": run.correct,
            "program": {n: v for n, v, _ in run.checks},
            "control": run.control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
