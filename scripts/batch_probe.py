#!/usr/bin/env python3
"""Probe the batched kernels (fused_sweeps.gsrb_relax_batch and
residual_restrict_batch) on one card: where a group launch's host time
goes, the residual batch's launch geometry by measurement, and the batch
march's x segments.

    python3 scripts/batch_probe.py [--bits] [--host] [--residual]
        [--march] [--cases a,b] [--out FILE]

--host: at the timed chip_smoke.BATCH_CASES batches, the host time
(chip_smoke.host_us: calls back to back from an idle card) of one group
launch of each batched wrapper, of one single call of the same kernel at
the same shape, and of the pieces of a group launch: the operands checked
(check_batch_args, by cheap queries), the launch
arguments' lookup (kept per shape), the P outputs' allocation, the pointer
tables (one array a call, or a ctypes array a list), the current stream
(through
torch.cuda.current_stream or as a raw cudaStream_t), and the C entry point
called with its arguments ready.

--residual: at the same batches, residual_restrict_batch's device time
(chip_smoke.device_ms) at each tile height, x segment length and ring (5
planes, or 4 for segments of one or two plane pairs) of a grid around the
one fused_sweeps.residual_geometry picks for the batch (forced
by standing in for fused_sweeps._residual_geometry), each held bit for bit
to the chosen geometry's output, with the blocks of each launch and the
blocks the card runs at once.

--bits: at the batches the march form takes, its outputs at 2 and 4 sweeps
against P single gsrb_relax calls (cells that differ, ulps) and the plain
version.

--march: at the batches the march form applies to, gsrb_relax_batch's
device time in the march form at each x segment count from 1 to 8 (forced
by standing in for fused_sweeps.march_segments in batch_march_geometry),
each held bit for bit to the chosen form's output, beside the serial
form's, the march's at its own segments and the form the rule picks.

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


def batch_operands(case):
    """(us, rhss, as_, kw, los) of a BATCH_CASES case, f32, as the kernels
    phase makes them."""
    cid, shape, kinds, rho, los, _ = case
    fields = [cs.level_fields(shape, torch.float32, seed=20 + k)
              for k in range(len(los))]
    us, rhss, as_ = ([f[k] for f in fields] for k in ("u", "rhs", "a"))
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
    return us, rhss, as_, kw, los


def host_split(cases) -> dict:
    lib = cuda_ext.lib()
    out = {}
    for case in cases:
        us, rhss, as_, kw, los = batch_operands(case)
        n, shape = len(us), tuple(us[0].shape)
        relax = dict(nsweeps=cs.BATCH_SWEEPS, los=los, **kw)
        geom, geo = fs._batch_launch(shape, 4, kw["kinds"], 0, None, n,
                                     cs.BATCH_SWEEPS)
        outs = [torch.empty_like(u) for u in us]
        tmps = ([torch.empty_like(u) for u in us]
                if geom.form == "march" else [None] * n)
        level = (float(kw["rho"]), 1.0, -1.0, 0.37, int(sum(los[0])))
        stream = torch.cuda.current_stream(0).cuda_stream
        entry = (lib.mgk_gsrb_batch_march if geom.form == "march"
                 else lib.mgk_gsrb_relax_batch)
        # the march's scratch states, else the wrap faces' scratch
        faces = [us[0].new_empty(n * geom.faces) if geom.faces else None]
        table, _ = fs._table(us, rhss, as_, outs,
                             tmps if geom.form == "march" else faces)

        def c_call():
            return entry(table.buffer_info()[0], geo, *level, stream)
        half = tuple(s // 2 for s in shape)
        routs = [us[0].new_empty(half) for _ in us]
        rtable, ptrs = fs._table(us, rhss, as_, routs)
        _, _, rgeo = fs._residual_launch(shape, 4, kw["kinds"], True, False,
                                         True, 0, n)
        strides = (ctypes.c_longlong * (2 * n))(
            *[o.stride(0) for o in routs], *[o.stride(1) for o in routs])

        def r_call():
            return lib.mgk_residual_batch(
                rtable.buffer_info()[0], ctypes.addressof(strides),
                float(kw["rho"]), 1.0, -1.0, 0.37, rgeo, stream)
        pieces = {
            "gsrb_relax_batch": lambda: fs.gsrb_relax_batch(
                us, rhss, as_, **relax),
            "gsrb_relax single": lambda: fs.gsrb_relax(
                us[0], rhss[0], as_[0], nsweeps=cs.BATCH_SWEEPS, lo=los[0],
                **kw),
            "residual_restrict_batch": lambda: fs.residual_restrict_batch(
                us, rhss, as_, **kw),
            "residual_restrict single": lambda: fs.residual_restrict(
                us[0], rhss[0], as_[0], **kw),
            "check_batch_args": lambda: fs.check_batch_args(
                "probe", us, rhss, as_),
            "_batch_launch lookup": lambda: fs._batch_launch(
                shape, 4, kw["kinds"], 0, None, n, cs.BATCH_SWEEPS),
            "_residual_launch lookup": lambda: fs._residual_launch(
                shape, 4, kw["kinds"], True, False, True, 0, n),
            "empty_like x P": lambda: [torch.empty_like(u) for u in us],
            "empty x P": lambda: [torch.empty(shape, dtype=us[0].dtype,
                                              device=us[0].device)
                                  for _ in us],
            "empty stacked + unbind": lambda: torch.empty(
                (n,) + shape, dtype=us[0].dtype,
                device=us[0].device).unbind(0),
            "empty stacked": lambda: torch.empty(
                (n,) + shape, dtype=us[0].dtype, device=us[0].device),
            "device of a tensor": lambda: us[0].device,
            "get_device": lambda: us[0].get_device(),
            "one table": lambda: fs._table(us, rhss, as_, outs),
            "a ctypes table a list": lambda: [
                (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
                for ts in (us, rhss, as_, outs)],
            "current_stream": lambda: torch.cuda.current_stream(
                0).cuda_stream,
            "raw stream": lambda: fs._raw_stream(0),
            "gsrb_relax_batch C call": c_call,
            "residual_restrict_batch C call": r_call,
        }
        out[case[0]] = {"form": geom.form, "patches": n,
                        **{k: cs.host_us(fn) for k, fn in pieces.items()}}
        del us, rhss, as_, outs, tmps, routs
        torch.cuda.empty_cache()
    return out


def residual_grid(cases) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for case in cases:
        us, rhss, as_, kw, _ = batch_operands(case)
        n, shape = len(us), tuple(us[0].shape)
        vz, vec = fs.residual_form(shape[2], 4, True)
        per_sm = functools.partial(fs.residual_capacity, 0, 4, vz, vec, True)
        chosen = fs.residual_batch_geometry(us, rhss, as_)

        def run():
            return fs.residual_restrict_batch(us, rhss, as_, **kw)
        ref = [r.clone() for r in run()]
        times = {}
        for ty, xseg, ring in ((ty, xseg, ring)
                               for ty in sorted({2, 4, 6, 8, 10, 12, 16, 20,
                                                 chosen.ty})
                               for xseg in (2, 4, 6, 8, 12, 18, 24)
                               for ring in (fs.RESIDUAL_PAIR_RING,
                                            fs.RESIDUAL_RING)):
            if ring == fs.RESIDUAL_PAIR_RING and xseg > 4:
                continue
            try:
                g = fs.residual_geometry(shape, 4, vz, vec, True, False,
                                         sms, per_sm, ty=ty, xseg=xseg,
                                         patches=n, ring=ring)
            except ValueError:
                continue
            if xseg > shape[0]:
                continue
            fs._residual_launch.cache_clear()
            try:
                with mock.patch.object(fs, "_residual_geometry",
                                       lambda *_, g=g: g):
                    got = run()
                    torch.cuda.synchronize()
                    cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                             f"{case[0]}: ty {ty} xseg {xseg} ring {ring} "
                             f"disagrees")
                    wave = sms * per_sm(g.threads, g.smem)
                    times[f"ty{ty} xseg{g.xseg} ring{ring}"] = {
                        "device_ms": cs.device_ms(run),
                        "blocks": n * g.ntiles * g.nseg, "wave": wave}
            finally:
                fs._residual_launch.cache_clear()
        out[case[0]] = {"chosen": chosen._asdict(),
                        "chosen_device_ms": cs.device_ms(run),
                        "grid": times}
        del us, rhss, as_
        torch.cuda.empty_cache()
    return out


def march_grid(cases) -> dict:
    out = {}
    for case in cases:
        us, rhss, as_, kw, los = batch_operands(case)
        n, shape = len(us), tuple(us[0].shape)
        cap = fs.gsrb_capacity(us[0].device, 4)
        geom = fs.gsrb_geometry(shape, 4, False, kw["kinds"], cap, patches=n,
                                nsweeps=cs.BATCH_SWEEPS)
        try:
            fs.gsrb_geometry(shape, 4, False, kw["kinds"], cap, "march",
                             patches=n, nsweeps=cs.BATCH_SWEEPS)
        except ValueError:
            continue
        relax = dict(nsweeps=cs.BATCH_SWEEPS, los=los, **kw)

        def run(form=None):
            return fs.gsrb_batch_launch(us, rhss, as_, form=form, **relax)
        ref = [r.clone() for r in run()]
        times = {"serial": cs.device_ms(lambda: run("serial")),
                 "march": cs.device_ms(lambda: run("march")),
                 "chosen " + geom.form: cs.device_ms(run)}
        segments = fs.march_segments
        for nseg in range(1, 9):
            def forced(nx, tiles, capacity, nsweeps, nseg=nseg):
                xseg = -(-nx // nseg)
                return -(-nx // xseg), xseg
            fs._relax_launch.cache_clear()
            fs._batch_launch.cache_clear()
            try:
                with mock.patch.object(fs, "march_segments", forced):
                    got = run("march")
                    torch.cuda.synchronize()
                    cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                             f"{case[0]}: {nseg} segments disagree")
                    g = fs._batch_launch(shape, 4, kw["kinds"], 0, "march",
                                         n, cs.BATCH_SWEEPS)[0]
                    times[f"nseg{nseg} xseg{g.xseg} blocks{g.blocks}"] = \
                        cs.device_ms(lambda: run("march"))
            finally:
                fs._relax_launch.cache_clear()
                fs._batch_launch.cache_clear()
        assert fs.march_segments is segments
        out[case[0]] = {"chosen": geom._asdict(), "device_ms": times}
        del us, rhss, as_
        torch.cuda.empty_cache()
    return out


def ulps(x, y) -> int:
    """The largest distance between two f32 tensors in units in the last
    place (their bits as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(x) - ordered(y)).abs().max())


def march_bits(cases) -> dict:
    """The march form against P single gsrb_relax calls at 2 and 4 sweeps
    (one chunk, two): cells that differ, their largest distance in ulps,
    and the largest difference from the plain version over its max."""
    out = {}
    for case in cases:
        us, rhss, as_, kw, los = batch_operands(case)
        n, shape = len(us), tuple(us[0].shape)
        try:
            fs.gsrb_geometry(shape, 4, False, kw["kinds"], 132, "march",
                             patches=n, nsweeps=2)
        except ValueError:
            continue
        rec = {}
        for ns in fs.BATCH_MARCH_SWEEPS:
            got = fs.gsrb_batch_launch(us, rhss, as_, nsweeps=ns, los=los,
                                       form="march", **kw)
            one = [fs.gsrb_relax(u, r, a, nsweeps=ns, lo=lo, **kw)
                   for u, r, a, lo in zip(us, rhss, as_, los)]
            ref = fs.gsrb_relax_batch_plain(us, rhss, as_, nsweeps=ns,
                                            los=los, **kw)
            torch.cuda.synchronize()
            rec[f"nsweeps{ns}"] = [{
                "cells_differ": int((g != o).sum()), "max_ulps": ulps(g, o),
                "rel_err_plain": float((g - r).abs().max() / r.abs().max()),
                "finite": bool(torch.isfinite(g).all())}
                for g, o, r in zip(got, one, ref)]
        out[case[0]] = rec
        del us, rhss, as_
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", action="store_true",
                    help="split a group launch's host time")
    ap.add_argument("--residual", action="store_true",
                    help="time residual_restrict_batch's geometries")
    ap.add_argument("--march", action="store_true",
                    help="time the batch march's x segment counts")
    ap.add_argument("--bits", action="store_true",
                    help="the march form's cells against single calls")
    ap.add_argument("--cases", default=None,
                    help="comma-separated BATCH_CASES ids (default: the "
                         "timed ones)")
    ap.add_argument("--out", default=None, help="JSON lines to write")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batch_probe: no CUDA device", file=sys.stderr)
        return 1
    cases = [c for c in cs.BATCH_CASES
             if (c[5] if args.cases is None else c[0] in args.cases.split(
                 ","))]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[:1]
    lines = [{"part": "card", "card": card[0] if card else None}]
    with torch.no_grad():
        for flag, part, fn in ((args.bits, "bits", march_bits),
                               (args.host, "host", host_split),
                               (args.residual, "residual", residual_grid),
                               (args.march, "march", march_grid)):
            if flag:
                lines.append({"part": part, "cases": fn(cases)})
                print(json.dumps(lines[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
