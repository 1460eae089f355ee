#!/usr/bin/env python3
"""Time the shard march (csrc/multisweep_halo.cu) on one card at every tile
width it is built with and at several x segment counts, to choose its launch
geometry by measurement.

    python3 scripts/shard_probe.py [--out FILE] [--cases a,b] [--tier bf16]

For each timed case of chip_smoke.SHARD_CASES (the shards the sharded paths
hand the kernel: the periodic box's 64x256x256 x-slab and 128x128x256
pencil, the 7-level finest level's 240x144x144 slab, the 64^3 base's
16x64x64 slab), f32, 2 sweeps a launch: the device time of one call
(chip_smoke.device_ms: a batch enqueued behind a wait) for each tile width
of fused_sweeps.MARCH_TILES and each segment count from 1 up to the most
the rule allows (at most 8), each forced on the wrapper by standing in for
fused_sweeps.shard_geometry_on, and the split shard_geometry_on picks.
`--tier bf16` times the forms of the bf16 tier (compute_dtype bfloat16)
instead, at the capacity of those forms.
Prints one JSON line per case and writes them all to --out. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs  # noqa: E402


def probe_case(case, tier: str = "f32") -> dict:
    cid, shape, kinds, lo, mshape, key, _ = case
    f = cs.level_fields(shape, torch.float32, seed=4)
    compute = int(tier == "bf16")
    kw = dict(nsweeps=2, kinds=kinds, rho=2.0, alpha=1.0, beta=-1.0,
              dx=0.37, lo=lo, compute_dtype="bfloat16" if compute else None)
    ops = cs.shard_operands(f, kinds, mshape, 4)[key]
    counts = tuple(mshape) + (1,) * (3 - len(mshape))
    loc = [shape[ax] // counts[ax] for ax in range(3)]
    pre = "pre" in ops
    if pre:
        name, args = "multisweep_relax_tiled_pre", ops["pre"]
        extra = dict(meta=ops["meta"], ny_global=ops["ny_global"])
    else:
        name = "multisweep_relax_halo"
        args = (ops["u"], ops["rhs"], ops["a"])
        extra = dict(pads=ops["pads"], meta=ops["meta"])

    def run():
        return fs.multisweep_launch(name, *args, **extra, **kw)

    ref = run()
    chosen = fs.shard_geometry_on(tuple(loc), 2, 4, 0, pre, compute)
    times = {}
    for tile in fs.MARCH_TILES[(4, 2)]:
        most = min(8, max(loc[0] // 16, 1))
        for nseg in range(1, most + 1):
            xseg = -(-loc[0] // nseg)
            geometry = (tile, -(-loc[0] // xseg), xseg)
            with mock.patch.object(fs, "shard_geometry_on",
                                   lambda *_: geometry):
                out = run()
                cs.check(torch.equal(out, ref) or float(
                    (out - ref).abs().max()) <= 2e-5 * float(
                        ref.abs().max()),
                    f"{cid}: tile {tile}, xseg {xseg} disagrees")
                times[f"W{tile} xseg{xseg}"] = cs.device_ms(run)
    return {"case": cid, "shard": loc, "pre": pre, "tier": tier,
            "chosen": {"tile": chosen[0], "segments": chosen[1],
                       "xseg": chosen[2]},
            "device_ms": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="JSON file to write")
    ap.add_argument("--cases", default=None,
                    help="comma-separated SHARD_CASES ids (default: the "
                    "timed ones)")
    ap.add_argument("--tier", default="f32", choices=("f32", "bf16"),
                    help="the forms timed: f32, or the bf16 tier's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_probe: no CUDA device available", file=sys.stderr)
        return 1
    wanted = args.cases.split(",") if args.cases else None
    card = cs.phase_env()["card"]
    recs = []
    with torch.no_grad():
        for case in cs.SHARD_CASES:
            if (wanted is None and case[6]) or (wanted and case[0] in wanted):
                recs.append(probe_case(case, args.tier))
                cs.emit(recs[-1])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "cases": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
