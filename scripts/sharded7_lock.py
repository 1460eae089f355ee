#!/usr/bin/env python3
"""Read step 1 of the 7-level lock on the sharded path (4 x-slabs on one
card) and without a mesh: with the f32 preconditioner twice on the sharded
path (does it repeat bit for bit?), and with the f64 one (does the gap
between the two paths, and to the lock, close?); then two f32 witnesses of
what moves it: the unsharded run with every depth the mesh would cut
smoothed by the whole-level march instead of gsrb_relax and the tower
(fused_sweeps.exceeds_l2 answers yes for those depths: the sharded run's
arithmetic without the mesh), and the sharded run with the shard kernel's
plain version in its place.

    python3 scripts/sharded7_lock.py [--tree DIR] [--out FILE]

--tree is the root of another checkout whose package and chip_smoke.py are
used instead of this one's, so that two trees can be read in one call (the
witnesses run in this tree only). The solves are chip_smoke's (run_solve,
sharded_solve, the SHARDED7 overrides: 7 levels, 3 Picard iterations).
Prints one JSON line per solve, with its launches, and one summary line,
and writes the summary to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


KERNELS = ("multisweep_relax_halo", "wavefront_relax", "gsrb_relax",
           "tower_down", "residual")


def solve(cs, overrides, label, sharded: bool) -> dict:
    """One solve with the launches of its run alone."""
    cs.kernel_counts.reset()
    if sharded:
        run = cs.sharded_solve(overrides, label, cs.SHARD_X,
                               cs.CANONICAL)[0]
    else:
        run = cs.run_solve(overrides, label)
    launches = cs.kernel_counts.snapshot()["launches"]
    run["launches"] = {k: launches.get(k, 0) for k in KERNELS}
    lock = cs.SCALE7[0]
    cs.emit({"label": label, "history": run["history"],
             "linear_iters": run["linear_iters"],
             "step1_rel_diff_lock": abs(run["history"][0] - lock) / lock,
             "launches": run["launches"]})
    return run


def overrides_for(cs, prec: str) -> list:
    out = [o for o in cs.SHARDED7 if "precond_precision" not in o]
    return out + [f"precond_precision = {prec}"]


def read_lock(cs) -> dict:
    lock = cs.SCALE7[0]
    out = {"lock": lock}
    for prec, sharded_runs in (("single", 2), ("double", 1)):
        ov = overrides_for(cs, prec)
        runs = [solve(cs, ov, f"unsharded_{prec}", False)]
        runs += [solve(cs, ov, f"sharded_{prec}_{i}", True)
                 for i in range(sharded_runs)]
        steps = [r["history"][0] for r in runs]
        out[prec] = {
            "step1": steps,
            "step1_rel_diff_lock": [abs(s - lock) / lock for s in steps],
            "sharded_vs_unsharded": abs(steps[1] - steps[0]) / steps[0],
            "sharded_repeats_bitwise": all(
                r["history"] == runs[1]["history"] for r in runs[1:]),
            "linear_iters": [r["linear_iters"] for r in runs],
            "launches": [r["launches"] for r in runs],
        }
    return out


def witnesses(cs) -> dict:
    """The f32 witnesses (this tree only)."""
    fs, pmesh = cs.fs, cs.pmesh
    lock = cs.SCALE7[0]
    ov = overrides_for(cs, "single")
    mesh = cs.one_card_mesh(cs.SHARD_X)
    exceeds = fs.exceeds_l2

    def cut_or_exceeds(shape, itemsize=4):
        return (pmesh.shard_counts(mesh, shape) != (1, 1, 1)
                or exceeds(shape, itemsize))

    with mock.patch.object(fs, "exceeds_l2", cut_or_exceeds):
        march = solve(cs, ov, "unsharded_march_at_cut_depths", False)
    halo_kernel = fs.multisweep_relax

    def plain_halo(u, rhs, a, *, halo=None, **kw):
        if halo is None:
            return halo_kernel(u, rhs, a, **kw)
        return fs.multisweep_relax_halo_plain(u, rhs, a, *halo, **kw)

    with mock.patch.object(fs, "multisweep_relax", plain_halo):
        plain = solve(cs, ov, "sharded_plain_halo", True)
    return {name: {"step1": r["history"][0],
                   "step1_rel_diff_lock": abs(r["history"][0] - lock) / lock,
                   "linear_iters": r["linear_iters"],
                   "launches": r["launches"]}
            for name, r in (("unsharded_march_at_cut_depths", march),
                            ("sharded_plain_halo", plain))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT, help="checkout to read")
    ap.add_argument("--out", default=None, help="JSON file to write")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("sharded7_lock: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        print(f"sharded7_lock: chip_smoke.py not found in {tree}",
              file=sys.stderr)
        return 1
    card = cs.phase_env()["card"]
    cs.phase_build()
    with torch.no_grad():
        out = {"tree": os.path.relpath(tree, ROOT), "card": card,
               **read_lock(cs)}
        if tree == ROOT:
            out["witness_single"] = witnesses(cs)
    cs.emit(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
