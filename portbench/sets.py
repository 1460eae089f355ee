"""Sets of runs of one cell, one process at a time, and their spreads.

    python3 portbench/sets.py --workload <cell> --seconds <s> \\
        --seeds 11,12,... [--repeat 2] [--trace-seeds 21,...] [--out FILE]

Runs `run.py` once per seed in order (and the whole list again per
`--repeat`: a set each, with the same seeds), then once per trace seed
with --trace 1. Prints each run's line, then for every end-to-end metric
of each set its median and its spread: the distance between the first
and third quartiles (statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        line = None
    return {"seed": seed, "trace": trace, "rc": p.returncode,
            "process_s": time.perf_counter() - t0, "line": line,
            "stderr_tail": p.stderr[-3000:]}


def spread(values) -> tuple:
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    sets, traced = [], []
    for _ in range(args.repeat):
        runs = []
        for s in ints(args.seeds):
            runs.append(one(args.workload, s, args.seconds, 0))
            print(json.dumps(runs[-1]), flush=True)
        sets.append(runs)
    for s in ints(args.trace_seeds):
        traced.append(one(args.workload, s, args.seconds, 1))
        print(json.dumps(traced[-1]), flush=True)
    summary = []
    for k, runs in enumerate(sets):
        lines = [r["line"] for r in runs if r["line"]]
        names = sorted({m for ln in lines for m in ln["metrics"]})
        for m in names:
            vals = [ln["metrics"][m]["value"] for ln in lines
                    if m in ln["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                summary.append({"set": k, "metric": m, "median": med,
                                "spread": sp, "values": vals})
    for row in summary:
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"sets": sets, "traced": traced, "summary": summary},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
