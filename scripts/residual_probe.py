#!/usr/bin/env python3
"""Probe the residual kernel (csrc/residual.cu) on one card: its launch
geometry by measurement, and its output against another tree's residual.

    python3 scripts/residual_probe.py [--parent DIR] [--out FILE]
        [--cases a,b] [--geometry]

--parent DIR: builds DIR's residual kernel alone (its
mg_ic_code_tpu_torch/csrc/residual.cu with gsrb_relax.cu, which defines
make_level_params) with nvcc into build/residual_probe/, and for every
chip_smoke.LEVEL_CASES case, f32 and f64, holds this tree's `residual`
against it bit for bit (cells that differ and their largest distance in
units in the last place), and times both (chip_smoke.device_ms: a batch
enqueued behind a wait) at the timed cases: the parent's kernel through its
C entry, the same inputs, one process, one card. DIR's C entry must be the
one before the march (mgk_residual(u, rhs, a, b, res, is_double, nx, ny,
nz, kinds, rho, alpha, beta, dx, stream)).

--geometry: for each timed case, f32, both forms, the device time at each
tile height and x segment length in a grid around the one
fused_sweeps.residual_geometry picks (forced by standing in for
fused_sweeps._residual_geometry with residual_geometry's ty and xseg),
each checked against the chosen one bit for bit.

Prints one JSON line per part and writes them to --out. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mg_ic_code_tpu_torch.ops import cuda_ext  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs  # noqa: E402


def parent_residual(tree: str):
    """The parent tree's residual C entry, built alone."""
    csrc = os.path.join(os.path.abspath(tree), "mg_ic_code_tpu_torch", "csrc")
    bdir = os.path.join(ROOT, "build", "residual_probe")
    os.makedirs(bdir, exist_ok=True)
    lib = os.path.join(bdir, "libparent_residual.so")
    cmd = [cuda_ext._nvcc(), *cuda_ext.NVCC_FLAGS, "-shared", "-I", csrc,
           os.path.join(csrc, "residual.cu"),
           os.path.join(csrc, "gsrb_relax.cu"), "-o", lib]
    done = subprocess.run(cmd, capture_output=True, text=True)
    cs.check(done.returncode == 0, f"parent build: {done.stdout}"
             f"{done.stderr}")
    fn = ctypes.CDLL(lib).mgk_residual
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.restype = ci
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.POINTER(ci),
                   cd, cd, cd, cd, vp]

    def run(u, rhs, a, b, *, kinds, rho, alpha, beta, dx):
        res = torch.empty_like(u)
        nx, ny, nz = u.shape
        err = fn(u.data_ptr(), rhs.data_ptr(), a.data_ptr(),
                 None if b is None else b.data_ptr(), res.data_ptr(),
                 int(u.dtype == torch.float64), nx, ny, nz,
                 fs.kinds_array(kinds), rho, alpha, beta, dx,
                 torch.cuda.current_stream().cuda_stream)
        cuda_ext.check(err, "parent residual")
        return res
    return run


def ulps(x, y) -> int:
    """The largest distance between x and y in units in the last place."""
    it = torch.int32 if x.dtype == torch.float32 else torch.int64
    xi, yi = x.view(it).to(torch.int64), y.view(it).to(torch.int64)
    # order the bit patterns as the numbers: negative ones count down
    top = torch.iinfo(it).min
    xi = torch.where(xi < 0, top - xi, xi)
    yi = torch.where(yi < 0, top - yi, yi)
    return int((xi - yi).abs().max())


def against_parent(tree: str, cases) -> dict:
    old = parent_residual(tree)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for cid, shape, kinds, _, rho, with_b, timed in cases:
            f = cs.level_fields(shape, dtype, seed=1, with_b=with_b)
            kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
            args = (f["u"], f["rhs"], f["a"], f["b"])
            new, ref = fs.residual(*args, **kw), old(*args, **kw)
            torch.cuda.synchronize()
            rec = {"cells_differing": int((new != ref).sum()),
                   "max_ulps": ulps(new, ref)}
            if timed and dtype == torch.float32:
                rec.update(
                    parent_device_ms=cs.device_ms(lambda: old(*args, **kw)),
                    device_ms=cs.device_ms(lambda: fs.residual(*args, **kw)),
                    restrict_device_ms=cs.device_ms(
                        lambda: fs.residual_restrict(*args, **kw)))
            out[f"{cid} {str(dtype)[6:]}"] = rec
            del f
            torch.cuda.empty_cache()
    return out


def geometry_grid(cases) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for cid, shape, kinds, _, rho, with_b, timed in cases:
        if not timed:
            continue
        f = cs.level_fields(shape, torch.float32, seed=1, with_b=with_b)
        kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
        args = (f["u"], f["rhs"], f["a"], f["b"])
        for restrict in (False, True):
            name = "residual_restrict" if restrict else "residual"
            half = tuple(n // 2 for n in shape)
            dest = torch.empty(half if restrict else shape,
                               dtype=torch.float32, device="cuda")
            vz, vec = fs.residual_form(shape[2], 4, True)
            per_sm = functools.partial(fs.residual_capacity, 0, 4, vz, vec,
                                       restrict)
            chosen = fs.residual_geometry(shape, 4, vz, vec, restrict,
                                          with_b, sms, per_sm)
            fs.residual_launch(name, *args, dest, **kw)
            ref = dest.clone()
            times = {}
            tys = sorted({2, 4, 6, 8, 12, 16, 24, 32, chosen.ty})
            for ty in tys:
                try:
                    base = fs.residual_geometry(shape, 4, vz, vec, restrict,
                                                with_b, sms, per_sm, ty=ty)
                except ValueError:
                    continue
                step = 2 if restrict else 1
                lens = sorted({max(step, (base.xseg * m // 4) // step * step)
                               for m in (1, 2, 4, 8, 16)})
                for xseg in lens:
                    if xseg > shape[0] + step:
                        continue
                    try:
                        g = fs.residual_geometry(shape, 4, vz, vec, restrict,
                                                 with_b, sms, per_sm, ty=ty,
                                                 xseg=xseg)
                    except ValueError:  # no segment count gives xseg
                        continue

                    def run():
                        return fs.residual_launch(name, *args, dest, **kw)
                    # the launch arguments are kept per shape: drop them
                    # around each forced geometry
                    fs._residual_launch.cache_clear()
                    try:
                        with mock.patch.object(fs, "_residual_geometry",
                                               lambda *_, g=g: g):
                            run()
                            torch.cuda.synchronize()
                            cs.check(torch.equal(dest, ref),
                                     f"{cid} {name}: ty {ty} xseg {xseg} "
                                     f"disagrees")
                            times[f"ty{ty} xseg{g.xseg} blocks"
                                  f"{g.ntiles * g.nseg}"] = cs.device_ms(run)
                    finally:
                        fs._residual_launch.cache_clear()
            out[f"{cid} {name}"] = {"chosen": chosen._asdict(),
                                    "device_ms": times}
        del f
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of a tree whose residual to hold this one to")
    ap.add_argument("--geometry", action="store_true",
                    help="time tile heights and segment lengths")
    ap.add_argument("--cases", default=None,
                    help="comma-separated LEVEL_CASES ids (default: all)")
    ap.add_argument("--out", default=None, help="JSON lines to write")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("residual_probe: no CUDA device", file=sys.stderr)
        return 1
    cases = [c for c in cs.LEVEL_CASES
             if args.cases is None or c[0] in args.cases.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[:1]
    lines = [{"part": "card", "card": card[0] if card else None}]
    with torch.no_grad():
        if args.parent:
            lines.append({"part": "against_parent",
                          "parent": os.path.abspath(args.parent),
                          "cases": against_parent(args.parent, cases)})
            print(json.dumps(lines[-1]), flush=True)
        if args.geometry:
            lines.append({"part": "geometry", "cases": geometry_grid(cases)})
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
