"""The readings the correctness limits are set from, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--weak-seeds 4,5,6] [--out FILE]

Set-up as a run; then, for each seed, the solves a run of that seed
judges (the seed's sample and one more, standing for the window's last)
are made at the cell's own size and judged by the reference exactly as a
run judges them. `--seeds` run the program as the configuration states
it (f64 outer loop); `--control-seeds` run the control, the program's own
lower-precision path: `poisson_solve(dtype=torch.float32)`, the nearest
precision below the f64 that sets the answer. `--weak-seeds` run the
program with a weakened preconditioner, each V-cycle with one smooth in
place of the configuration's (`numMGsmooth`): the fault that `krylov`
is compared to catch, since it leaves the f64 answer as it was. Prints
one JSON line per seed and side, then the lower reading (the largest of
the program's) and the upper readings (the smallest of the control's
and of the weakened runs') of every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import cells, run, traffic  # noqa: E402


WEAK = {"num_mg_smooth": 1}


def readings(bench: run.Bench, h, seed: int, dtype, over=None) -> dict:
    """The numbers a run of `seed` compares, for its judged solves made
    one by one (with the configuration's fields `over` replaced)."""
    wl = bench.cell.workload
    scan = traffic.Scan(wl, seed)
    nums = {"failed": 0}
    for i in traffic.sample(wl, seed) + [wl["check"]["within"]]:
        draw = scan.draw(i)
        res, _ = bench.solve({**draw, **(over or {})}, dtype)
        if res is None:
            nums["failed"] += 1
            continue
        rec = bench.keep(i, draw, res)
        res = None
        for k, v in bench.judge(h, rec).items():
            nums[k] = max(nums.get(k, 0.0), v)
    return nums


def calibrate(cell: cells.Cell, seeds, control_seeds, weak_seeds=(),
              device="cuda") -> dict:
    bench = run.Bench(cell, device)
    bench.setup()
    h = bench.hierarchy()
    out = {"hierarchy": sum(a != b for a, b in zip(h.boxes, bench.boxes))
           + abs(len(h.boxes) - len(bench.boxes)), "program": {},
           "control": {}, "weak": {}}
    for side, dtype, over, ss in (
            ("program", torch.float64, None, seeds),
            ("control", torch.float32, None, control_seeds),
            ("weak", torch.float64, WEAK, weak_seeds)):
        for s in ss:
            try:
                nums = readings(bench, h, s, dtype, over)
            except Exception as e:  # a control that crashes has failed
                if side == "program":
                    raise
                nums = {"error": repr(e)[:500]}
            out[side][s] = nums
            print(json.dumps({"side": side, "seed": s, **nums}), flush=True)
    keys = sorted({k for v in out["program"].values() for k in v})
    out["lower"] = {k: max(v.get(k, 0.0) for v in out["program"].values())
                    for k in keys}
    for side in ("control", "weak"):
        if out[side]:
            out["upper_" + side] = {
                k: min((v.get(k, float("inf")) for v in out[side].values()
                        if "error" not in v), default=float("inf"))
                for k in keys}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--weak-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(ROOT, args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = calibrate(cell, ints(args.seeds), ints(args.control_seeds),
                    ints(args.weak_seeds))
    print(json.dumps({k: out[k] for k in ("lower", "upper_control",
                                          "upper_weak", "hierarchy")
                      if k in out}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
