#!/usr/bin/env python3
"""Where the 7-level plateau comes from: the canonical configuration at
max_level = 6, carried to its plateau with each preconditioner on the card.

    python3 scripts/records_probe.py [--runs NAME,...] [--out FILE]

Runs (each load_params -> generate_hierarchy -> poisson_solve through
chip_smoke.run_solve, 6 Picard steps, the counters set to 0 before it):
  f32        precond_precision = single, the kernels (the records phase's
             plain run)
  f32_xla    the same with smoother = xla: the f32 preconditioner with no
             kernel, the arbiter of the kernels
  f64        precond_precision = double (no kernel)
  f32_avg    the f32 run with average_down = 1 (no plateau: every covered
             coarse cell is set from its children each step)
For each: the history, its relative gap to the f64 record
(docs/canonical_7level_result.json) and to the f32 record of another
machine (docs/canonical_7level_tpu_result.json), the Krylov counts,
s/iteration, peak memory, the kernel launches, and, from the final psi,
the largest gap between a covered coarse cell and the restriction of the
finer level over it (the mismatch that average_down removes), per level.
One JSON line per run, then a summary line; the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from mg_ic_code_tpu_torch.ops import kernel_counts  # noqa: E402
from mg_ic_code_tpu_torch.ops import stencils as st  # noqa: E402

RUNS = {
    "f32": ["precond_precision = single"],
    "f32_xla": ["precond_precision = single", "smoother = xla"],
    "f64": ["precond_precision = double"],
    "f32_avg": ["precond_precision = single", "average_down = 1"],
}


def covered_mismatch(geom, psi) -> list:
    """max |psi_parent - restrict_full(psi_child)| over each child's covered
    slice of its parent, per child entry."""
    out = []
    for c in range(1, geom.num_levels):
        p = geom.parent[c]
        gap = psi[p][geom.child_slices(p, c)] - st.restrict_full(psi[c])
        out.append(float(gap.abs().max()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--nl", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("records_probe: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    f64_rec = cs.record("plain")["history"]
    with open(os.path.join(ROOT, "docs", "canonical_7level_tpu_result.json")
              ) as f:
        f32_rec = json.load(f)["history"]
    cs.cuda_ext.lib()
    results = {}
    with torch.no_grad():
        for name in args.runs.split(","):
            keep: dict = {}
            kernel_counts.reset()
            run = cs.run_solve(cs.RECORDS_BASE + RUNS[name]
                               + [f"max_NL_iterations = {args.nl}"],
                               name, keep)
            h = run["history"]
            rec = {
                "run": name, "overrides": run["overrides"], "history": h,
                "rel_to_f64_record": [abs(a - b) / b
                                      for a, b in zip(h, f64_rec)],
                "rel_to_f32_record": [abs(a - b) / b
                                      for a, b in zip(h, f32_rec)],
                "linear_iters": run["linear_iters"],
                "s_per_iteration": run["s_per_iteration"],
                "max_memory_allocated": run["max_memory_allocated"],
                "hierarchy_s": run["hierarchy_s"],
                "launches": kernel_counts.snapshot()["launches"],
                "covered_mismatch": covered_mismatch(
                    keep["geom"], keep["res"].psi),
            }
            keep.clear()
            torch.cuda.empty_cache()
            results[name] = rec
            print(json.dumps(rec), flush=True)
    summary = {"card": card, "plateau": {
        n: r["history"][3:] for n, r in results.items()}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
