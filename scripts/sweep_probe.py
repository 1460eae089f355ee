#!/usr/bin/env python3
"""Probe the one-sweep and one-pass kernels (fused_sweeps.gsrb_full_sweep /
gsrb_half_sweep, csrc/gsrb_sweep.cu) on one card: their outputs in every
form against the plain versions and each other, and their times in each
form and march geometry.

    python3 scripts/sweep_probe.py [--bits] [--time] [--out FILE]

--bits: at every BIT_CASES case (f32 and f64, constant and variable b, odd
sum(lo), periodic and open faces, nz % 4 != 0, odd sizes), each half sweep
(the stream form) and each full sweep in the grid form and the march (the
rule's geometry and forced tile heights, segments and threads) against the
plain versions (max error over max|plain|, limits 2e-5 f32 and 1e-12
f64); the full sweep bit for bit two half sweeps and gsrb_relax with
nsweeps = 1, the caller's u untouched, one kernel launch a call.

--time: at every TIME_CASES level, each entry point's device time
(chip_smoke.device_ms: calls enqueued behind a wait), host time
(chip_smoke.host_us) and batched time (chip_smoke.time_ms) in the form the
rule picks, the plain version's time, the byte bound (each array read
once, out written once, at 3.35 TB/s) and the share of it reached; the full
sweep's device time in the grid form and in the march at each tile height
of TILE_ROWS_TRIED with 256 and 512 threads a block, each at
the segment count of one wave and at counts that make about 1, 2 and 4
blocks a multiprocessor.

Prints one JSON line per part and writes them to --out. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs  # noqa: E402

D, N, C, P = cs.D, cs.N, cs.C, cs.P
MIXED = ((D, N), (P, P), (C, D))
# (id, shape, kinds, lo)
BIT_CASES = [
    ("c_odd_lo", (96, 80, 80), cs.ALL_C, (49, 40, 40)),
    ("p_256", (256, 256, 256), cs.ALL_P, (0, 0, 0)),
    ("mixed_nz_odd", (37, 30, 45), MIXED, (1, 0, 0)),
    ("d_nz_6", (24, 18, 6), cs.ALL_D, (0, 1, 0)),
    ("xp_nz_10", (20, 33, 10), ((P, P), (D, C), (N, D)), (3, 2, 2)),
    ("p_4", (4, 4, 4), cs.ALL_P, (0, 0, 0)),
    ("p_8", (8, 8, 8), cs.ALL_P, (0, 0, 1)),
    ("d_960", (960, 144, 144), cs.ALL_D, (0, 0, 0)),
]
# (id, shape, kinds, lo, with_b, dtypes)
TIME_CASES = [
    ("c_96x80x80_b", (96, 80, 80), cs.ALL_C, (49, 40, 40), True,
     (torch.float32, torch.float64)),
    ("c_96x80x80", (96, 80, 80), cs.ALL_C, (49, 40, 40), False,
     (torch.float32, torch.float64)),
    ("p_256", (256, 256, 256), cs.ALL_P, (0, 0, 0), False,
     (torch.float32,)),
    ("d_960x144x144", (960, 144, 144), cs.ALL_D, (0, 0, 0), False,
     (torch.float32,)),
    ("p_4", (4, 4, 4), cs.ALL_P, (0, 0, 0), False, (torch.float32,)),
    ("p_8", (8, 8, 8), cs.ALL_P, (0, 0, 1), False, (torch.float32,)),
]
KW = dict(rho=2.0, alpha=1.0, beta=-1.0, dx=0.37)
# the march's tile heights timed: those the rule offers and taller ones
TILE_ROWS_TRIED = (32, 24) + fs.SWEEP_TILE_ROWS


def launches(fn):
    """(fn's result, kernel launches it enqueued)."""
    before = sum(kernel_counts.DEVICE_LAUNCHES.values())
    out = fn()
    return out, sum(kernel_counts.DEVICE_LAUNCHES.values()) - before


def bits_case(case, dtype, with_b) -> dict:
    cid, shape, kinds, lo = case
    f = cs.level_fields(shape, dtype, seed=11, with_b=with_b)
    args = (f["u"], f["rhs"], f["a"], f["b"])
    kw = dict(KW, kinds=kinds, lo=lo)
    u_in = f["u"].clone()
    tol = cs.TOL[dtype]
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "with_b": with_b, "checks": 0}
    worst = {"half": 0.0, "full": 0.0}

    def held(out, ref, what, n, key):
        err, rel = cs.rel_err(out, ref)
        worst[key] = max(worst[key], rel)
        cs.check(rel <= tol and bool(torch.isfinite(out).all()),
                 f"{what}: rel err {rel} > {tol}")
        cs.check(n == 1, f"{what}: {n} launches")
        cs.check(torch.equal(f["u"], u_in), f"{what}: input modified")
        rec["checks"] += 1

    halves = []
    for color in (0, 1):
        ref = fs.gsrb_half_sweep_plain(*args, color=color, **kw)
        out, n = launches(lambda: fs.gsrb_half_sweep(*args, color=color,
                                                     **kw))
        held(out, ref, f"{cid} half {color}", n, "half")
        halves.append(out)
    ref = fs.gsrb_full_sweep_plain(*args, **kw)
    two = fs.gsrb_half_sweep(halves[0], *args[1:], color=1, **kw)
    one = fs.gsrb_relax(*args, nsweeps=1, **kw)
    cs.check(torch.equal(two, one), f"{cid}: two half sweeps are not "
             f"gsrb_relax(nsweeps = 1): {cs.rel_err(two, one)}")
    forms = [("grid", None, None, None), ("march", None, None, None)] + [
        ("march", ty, None, None) for ty in fs.SWEEP_TILE_ROWS] + [
        ("march", 2, 1, 128), ("march", 4, 3, 256), ("march", 16, None, 96),
        ("march", 1, None, 512)]
    for form, ty, nseg, th in forms:
        try:
            out, n = launches(lambda: fs.sweep_launch(
                *args, full=True, form=form, ty=ty, nseg=nseg, threads=th,
                **kw))
        except ValueError:
            continue
        what = f"{cid} full {form} ty {ty} nseg {nseg} th {th}"
        held(out, ref, what, n, "full")
        cs.check(torch.equal(out, two), f"{what}: not two half sweeps: "
                 f"{cs.rel_err(out, two)}")
    rec.update(rel_err_half=worst["half"], rel_err_full=worst["full"],
               tolerance=tol)
    return rec


def nseg_candidates(shape, ty, cap, sms) -> list:
    """The rule's segment count for tile height ty (one wave of `cap`
    blocks: fused_sweeps.sweep_segments) and counts that make about 1, 2 and
    4 blocks a multiprocessor."""
    nx, ny, _ = shape
    tiles = -(-ny // ty)
    top = max(nx // fs.SWEEP_MIN_SEG, 1)
    out = {max(1, min(top, round(k * sms / tiles))) for k in (1, 2, 4)}
    out.add(fs.sweep_segments(nx, tiles, cap)[0])
    return sorted(out)


def time_case(case, dtype) -> dict:
    cid, shape, kinds, lo, with_b, _ = case
    f = cs.level_fields(shape, dtype, seed=12, with_b=with_b)
    args = (f["u"], f["rhs"], f["a"], f["b"])
    kw = dict(KW, kinds=kinds, lo=lo)
    isz, ncells = f["u"].element_size(), math.prod(shape)
    bound = cs.level_bytes(ncells, isz, 5 if with_b else 4) / cs.HBM_BYTES_S \
        * 1e3
    dev = f["u"].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = fs.periodic_axes(kinds)
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "with_b": with_b, "bound_ms": bound, "forms": {}}

    def timed(label, fn, geom=None, full_timing=True):
        r = {"device_ms": cs.device_ms(fn)}
        if full_timing:
            r.update(host_us=cs.host_us(fn), ms=cs.time_ms(fn))
        r["reached"] = bound / r["device_ms"]
        if geom is not None:
            r["geometry"] = geom._asdict()
        rec["forms"][label] = r

    for full in (False, True):
        name = "full" if full else "half"
        rule, _ = fs._sweep_launch(tuple(shape), isz, with_b, kinds,
                                   dev.index, full)
        rec[f"{name}_rule"] = rule._asdict()
        run = ((lambda: fs.gsrb_full_sweep(*args, **kw)) if full else
               (lambda: fs.gsrb_half_sweep(*args, color=0, **kw)))
        timed(f"{name} rule", run, rule)
        plain = ((lambda: fs.gsrb_full_sweep_plain(*args, **kw)) if full else
                 (lambda: fs.gsrb_half_sweep_plain(*args, color=0, **kw)))
        rec[f"{name}_plain_ms"] = cs.time_ms(plain, reps=5, warmup=1)
    timed("full grid", lambda: fs.sweep_launch(*args, full=True, form="grid",
                                               **kw))
    for ty in TILE_ROWS_TRIED:
        smem = fs.sweep_smem(shape[2], ty, isz)
        if smem > fs.SWEEP_SMEM or ty > 2 * shape[1]:
            continue
        for threads in (256, 512):
            cap = fs.sweep_capacity(dev, isz, "march", per, threads, smem)
            for nseg in nseg_candidates(shape, ty, cap, sms):
                geom, _ = fs._sweep_launch(tuple(shape), isz, with_b, kinds,
                                           dev.index, True, "march", ty,
                                           nseg, threads)
                timed(f"full march ty {ty} nseg {geom.nseg} th {threads}",
                      lambda: fs.sweep_launch(*args, full=True,
                                              form="march", ty=ty,
                                              nseg=nseg, threads=threads,
                                              **kw), geom, False)
    best = min((k for k in rec["forms"] if k.startswith("full ")),
               key=lambda k: rec["forms"][k]["device_ms"])
    rec["full_fastest"] = best
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bits", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_probe: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    cuda_ext.lib()
    regs, spills = cs.ptxas_resources()
    emit({"part": "build", "card": card, **{
        k: cuda_ext.BUILD_INFO[k] for k in ("seconds", "cached")},
        "sweep_kernels": {k: {"registers": v, "spill_stores": spills.get(k)}
                          for k, v in regs.items()
                          if "sweep" in k or "stream" in k}})
    failed = []
    try:
        with torch.no_grad():
            if args.bits:
                recs = []
                for case in BIT_CASES:
                    for dtype in (torch.float32, torch.float64):
                        for with_b in (False, True):
                            try:
                                recs.append(bits_case(case, dtype, with_b))
                            except cs.SmokeFailure as e:
                                failed.append(str(e))
                                print(f"sweep_probe FAILED: {e}",
                                      file=sys.stderr, flush=True)
                            torch.cuda.empty_cache()
                emit({"part": "bits", "card": card, "cases": recs,
                      "failed": failed})
            if args.time:
                for case in TIME_CASES:
                    for dtype in case[5]:
                        emit({"part": "time", "card": card,
                              **time_case(case, dtype)})
                        torch.cuda.empty_cache()
    finally:
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(lines, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
