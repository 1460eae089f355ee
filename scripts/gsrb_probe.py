#!/usr/bin/env python3
"""Split gsrb_relax's device time on one card into its parts.

    python3 scripts/gsrb_probe.py [--out FILE]
    python3 scripts/gsrb_probe.py --odd [--out FILE]

For each of the 7-level path's four resident levels (f32, CF faces, random
fields from a seed) and each launch form that takes it (fused_sweeps.
GSRB_FORMS), the device time of one call (`chip_smoke.device_ms`: a batch
enqueued behind a wait) at 0, 1, 2 and 4 sweeps: the time at 0 sweeps is the
launch, the loads and the store; the slope per sweep is two colour passes
with their exchange and synchronisation. Then the largest tile of the slab
form alone as a one-block level (no exchange, no grid synchronisation): its
slope is the passes' own work on one SM. Prints one JSON line per level and
the card's name and power limit.

--odd: the cost of the wrap faces (a periodic axis of odd extent) in the
grid form, f64 and f32: 15^3 and 16^3, every axis periodic (15^3 then
launches the ODD kernel, which saves the next pass's faces after each pass)
and every face CF (no faces, the even kernel), each at 4 and 15 blocks (the
geometries pair_grid_blocks gives 16^3 and 15^3) and at the blocks it
picks, at 0, 1, 2 and 4 sweeps. Shape and blocks apart from the faces: at
one block count, 15^3 P against 15^3 CF is the faces' cost, and at one
kinds, 15 blocks against 4 the geometry's.
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


def launch(f, geom, nsweeps: int, kinds=KINDS) -> torch.Tensor:
    """One call of the C entry point with the geometry `geom` (its faces'
    scratch allocated in the call, as the wrapper does)."""
    u = f["u"]
    nx, ny, nz = u.shape
    starts = (geom.xsplit[0] + (nx,) + geom.ysplit[0] + (ny,)
              if geom.form != "grid" else (0,))
    out = torch.empty_like(u)
    faces = (torch.empty(geom.faces, dtype=u.dtype, device=u.device)
             if geom.faces else None)
    err = cuda_ext.lib().mgk_gsrb_relax(
        u.data_ptr(), f["rhs"].data_ptr(), f["a"].data_ptr(), None,
        out.data_ptr(), fs._ptr(faces), int(u.dtype == torch.float64), 0,
        nx, ny, nz, fs.kinds_array(kinds), 2.0, 1.0,
        -1.0, 0.37, 0, nsweeps, fs.GSRB_FORMS[geom.form], geom.per,
        geom.blocks,
        len(geom.xsplit[0]), (ctypes.c_int * len(starts))(*starts),
        geom.smem, torch.cuda.current_stream().cuda_stream)
    cuda_ext.check(err, "gsrb_relax probe")
    return out


def sweep_times(f, geom, kinds=KINDS) -> dict:
    times = {n: chip_smoke.device_ms(lambda: launch(f, geom, n, kinds))
             for n in SWEEPS}
    return {"ms": times, "per_sweep_ms": (times[4] - times[0]) / 4}


ODD_SHAPES = [(15, 15, 15), (16, 16, 16)]
ODD_BLOCKS = (4, 15)
P = "periodic"


def odd_faces() -> list:
    """--odd: the grid form's device time by shape, kinds and blocks."""
    lines = []
    for dtype in (torch.float64, torch.float32):
        isz = torch.tensor([], dtype=dtype).element_size()
        for shape in ODD_SHAPES:
            f = chip_smoke.level_fields(shape, dtype, seed=1)
            for kname, kinds in (("P", ((P, P),) * 3), ("CF", KINDS)):
                odd = bool(fs.odd_wrap_axes(shape, kinds))
                geom = fs.gsrb_geometry(shape, isz, False, kinds,
                                        fs.gsrb_capacity(
                                            f["u"].device, isz, 0, odd),
                                        "grid")
                rec = {"dtype": str(dtype)[6:], "shape": list(shape),
                       "kinds": kname, "face_cells": geom.faces,
                       "picked_blocks": geom.blocks, "blocks": {}}
                ref = launch(f, geom, 4, kinds)
                for blocks in sorted(set(ODD_BLOCKS + (geom.blocks,))):
                    g = geom._replace(blocks=blocks)
                    # every geometry computes the same cells
                    chip_smoke.check(torch.equal(launch(f, g, 4, kinds), ref),
                                     f"gsrb_probe {rec}: {blocks} blocks "
                                     f"differ")
                    rec["blocks"][blocks] = sweep_times(f, g, kinds)
                lines.append(rec)
                print(json.dumps(rec), flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--odd", action="store_true",
                    help="the wrap faces' cost in the grid form")
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
        for shape in SHAPES if not args.odd else ():
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
        if args.odd:
            lines = odd_faces()
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(dict(rec, card=card)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
