#!/usr/bin/env python3
"""Split gsrb_relax's device time on one card into its parts.

    python3 scripts/gsrb_probe.py [--out FILE]

For each of the 7-level path's four resident levels (f32, CF faces, random
fields from a seed) and each launch form that takes it (fused_sweeps.
GSRB_FORMS), the device time of one call (`chip_smoke.device_ms`: a batch
enqueued behind a wait) at 0, 1, 2 and 4 sweeps: the time at 0 sweeps is the
launch, the loads and the store; the slope per sweep is two colour passes
with their exchange and synchronisation. Then the largest tile of the slab
form alone as a one-block level (no exchange, no grid synchronisation): its
slope is the passes' own work on one SM. Prints one JSON line per level and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from mg_ic_code_tpu_torch.ops import cuda_ext  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs  # noqa: E402

C = "cf"
KINDS = ((C, C),) * 3
SHAPES = [(96, 80, 80), (128, 80, 80), (176, 64, 64), (272, 80, 80)]
SWEEPS = (0, 1, 2, 4)


def launch(f, geom, nsweeps: int) -> torch.Tensor:
    """One call of the C entry point with the geometry `geom`."""
    u = f["u"]
    nx, ny, nz = u.shape
    starts = (geom.xsplit[0] + (nx,) + geom.ysplit[0] + (ny,)
              if geom.form != "grid" else (0,))
    out = torch.empty_like(u)
    err = cuda_ext.lib().mgk_gsrb_relax(
        u.data_ptr(), f["rhs"].data_ptr(), f["a"].data_ptr(), None,
        out.data_ptr(), 0, 0, nx, ny, nz, fs.kinds_array(KINDS), 2.0, 1.0,
        -1.0, 0.37, 0, nsweeps, fs.GSRB_FORMS[geom.form], geom.per,
        geom.blocks,
        len(geom.xsplit[0]), (ctypes.c_int * len(starts))(*starts),
        geom.smem, torch.cuda.current_stream().cuda_stream)
    cuda_ext.check(err, "gsrb_relax probe")
    return out


def sweep_times(f, geom) -> dict:
    times = {n: chip_smoke.device_ms(lambda: launch(f, geom, n))
             for n in SWEEPS}
    return {"ms": times, "per_sweep_ms": (times[4] - times[0]) / 4}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gsrb_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cap = fs.gsrb_capacity(torch.device("cuda"), 4)
    lines = []
    with torch.no_grad():
        for shape in SHAPES:
            f = chip_smoke.level_fields(shape, torch.float32, seed=1)
            rec = {"shape": list(shape), "forms": {}}
            for form in ("grid", "slab"):  # the forms of one level
                geom = fs.gsrb_geometry(shape, 4, False, KINDS, cap, form)
                rec["forms"][form] = dict(blocks=geom.blocks,
                                          **sweep_times(f, geom))
            geom = fs.gsrb_geometry(shape, 4, False, KINDS, cap, "slab")
            tile = (max(geom.xsplit[1]), max(geom.ysplit[1]), shape[2])
            one = fs.gsrb_geometry(tile, 4, False, KINDS, 1, "slab")
            rec["one_tile"] = dict(shape=list(tile), **sweep_times(
                chip_smoke.level_fields(tile, torch.float32, seed=1), one))
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(dict(rec, card=card)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
