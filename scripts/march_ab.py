#!/usr/bin/env python3
"""Time the one-launch kernels of two trees (or more) against each other on
one card: the march, the coarse towers, gsrb_relax and the residual (whole
and restricted), and one preconditioner application end to end.

    git archive <parent> | tar -x -C build/ab_parent   # where git is
    python3 scripts/march_ab.py --parent build/ab_parent \
        --out build/march_ab.json [--variant NAME=DIR ...]

Tree A is the one unpacked under --parent, tree B the one this script lies
in, and each --variant another tree, named. Each run is `chip_smoke.py
--phases env,build,kernels` from the root of its tree, one after the other
on the same card, in the order given by --order (default: A, B, the
variants, the same backwards: A B B A without variants), with the same
timer in every tree: this tree's `chip_smoke.time_ms` (CUDA events around
a batch of calls back to back, over the batch) replaces the tree's own. The
f32 times of every timed case of the march (the whole-level kernel under
`wavefront_relax` and `multisweep_relax`, the shard kernels under
`multisweep_relax_halo` and `multisweep_relax_tiled_pre`; 2 sweeps per
launch), of the towers (`tower_down`, `tower_up`: a depth chain, 4 sweeps
per depth) and of `gsrb_relax` (4 sweeps), `residual` and
`residual_restrict` (where the tree has it) at every timed level case are
read from each run's kernels line, and so are the bf16 tier's times of each
of these (under the kernel's name with _bf16, f32 operands) where the tree
has the tier. In every tree the same
probe also times each tower wrapper call on the host clock (its checks,
allocation and launches, in the kernels phase's own calls; reported per
case as the median over the run's calls, `host_us`), and, after the
kernels phase, splits one call of `gsrb_relax` and of `residual` at the
7-level path's resident levels, and of the shard marches at the timed
SHARD_CASES shards, into device time (this tree's `chip_smoke.device_ms`:
the batch enqueued behind a wait) and host time (`chip_smoke.host_us`),
and times the whole-level march's device time at its timed cases, under
"split"; the towers' and gsrb_relax's device times from the kernels line
("<kernel> <case> device_ms" under "cases"). Last, the same probe times one
preconditioner application (composite.precond, two AMR V-cycles in f32)
on the 7-level hierarchy and on the periodic box from the initial psi,
each without a mesh and (PRECOND_CASES) with the sharded phase's meshes of
one card named four times: the
wall time to completion on the card, the host's time to enqueue it from an
idle card, and the card's busy time (the kernels and copies torch.profiler
sees), with the wrapper calls it made; and the staged chain the periodic
box's 256^3 depth was restricted with before the fused kernel
(stencils.restrict_residual of the ghost-filled level, f32) beside
`residual_restrict` where the tree has it, under "precond". A case a tree
lacks is left out of that tree's columns. The sweep probe, run in every
tree after the split probe, times gsrb_full_sweep and gsrb_half_sweep at
every SWEEP_SHAPES level (device, host, batched and wall time, the plain
version's time, the byte bound and the share of it reached), under
"sweep". The JSON written to --out holds
every run's times and, per case, each tree's runs, median and spread
(largest over smallest of its runs, minus one) and each tree's speed-up
over A (A's median over its own), for the times under "cases", the host
times under "host_us" and the split under "split". Each run's whole output
goes beside it (<out>.<i><tree>.log). Exits non-zero when a run fails.

`--phases` widens the chip_smoke.py run of every tree (default
env,build,kernels; the kernels phase must be among them). With `sharded`
among them the summary has a "sharded" field as well: per sharded run of
that phase (sharded_x, sharded_pencil, sharded7) the median seconds per
Picard iteration and, where the tree's phase measures it, the wall time of
one preconditioner application with the mesh and without; the kernels
phase's whole-level sharded relax at the timed shard cases (per call,
resident where the tree has it, unsharded) is under "cases" as
"<kernel> <case> whole_level_<form>".

`--bitwise` holds every tree's outputs bit for bit to tree A's: in each
tree's first run the bitwise probe hashes the f32 and f64 outputs of every
gsrb_relax form at every level case, every gsrb_relax_batch form at every
batch, the one-sweep and one-pass entry points (at the odd-lo box and at
every SWEEP_SHAPES level, constant and variable b), both towers at every chain,
the whole-level marches at every WAVE_CASES and MULTI_CASES case but 512^3
and the shard marches at every SHARD_CASES case (nsweeps 2 and 4), and the
bf16 tier's outputs of each of these where the tree has the tier's form
(each tree's own case tables and seeds), and keeps the Picard histories,
Krylov counts and K of the 4-level canonical solve, the records' patches
run, scale7 and the periodic box, and of the tier's runs where the tree has
them (the 4-level solve with average_down; scale7 and the box), as exact
decimal strings. The summary's "bitwise" field lists, per tree, the keys
equal to A's, those that differ and those one tree lacks; the script exits
1 when a key differs.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARCH = ("wavefront_relax", "multisweep_relax", "multisweep_relax_halo",
         "multisweep_relax_tiled_pre", "tower_down", "tower_up",
         "gsrb_relax", "residual", "residual_restrict",
         # the bf16 tier's forms of the same kernels (f32 operands), where
         # the tree has them
         "wavefront_relax_bf16", "multisweep_relax_bf16",
         "multisweep_relax_halo_bf16", "multisweep_relax_tiled_pre_bf16",
         "gsrb_relax_bf16", "tower_down_bf16", "tower_up_bf16",
         # the batched forms at the timed BATCH_CASES, where the tree has
         # them
         "gsrb_relax_batch", "residual_restrict_batch")
TOWERS = ("tower_down", "tower_up")

# Run in every tree after its chip_smoke module is imported: wraps the tower
# wrappers of that tree so that each call's host time is kept under
# "<kernel> <case> <dtype>" (the case of chip_smoke.TOWER_CASES whose shape
# and faces the chain has), and prints them as one line when main() is done.
HOST_PROBE = """
_host = {}


def _host_timed(name, fn):
    cases = {(tuple(c[1]), c[2]): c[0] for c in chip_smoke.TOWER_CASES}

    def call(spec, d, first, *args, **kw):
        t0 = time.perf_counter()
        out = fn(spec, d, first, *args, **kw)
        dt = (time.perf_counter() - t0) * 1e6
        cid = cases.get((tuple(spec.boxes[d].shape), spec.kinds))
        if cid is not None and first.is_cuda:
            key = f"{name} {cid} {str(first.dtype)[6:]}"
            _host.setdefault(key, []).append(dt)
        return out
    return call


for _name in TOWERS:
    setattr(chip_smoke.ct, _name,
            _host_timed(_name, getattr(chip_smoke.ct, _name)))
"""

# Run in every tree after its chip_smoke.main(): the device and host time of
# one call of gsrb_relax (4 sweeps) and residual at each split case (the
# LEVEL_CASES of the 7-level path's resident levels), the device time of the
# whole-level march (2 sweeps) at its timed cases, and of the shard marches
# (2 sweeps) on the shard of every timed SHARD_CASES case, with this tree's
# device_ms and host_us, printed as one line.
SPLIT_PROBE = """
_split = {}
with torch.no_grad():
    for _c in chip_smoke.LEVEL_CASES:
        if _c[0] not in SPLIT_CASES:
            continue
        _f = chip_smoke.level_fields(_c[1], torch.float32, seed=1)
        _kw = dict(kinds=_c[2], rho=_c[4], alpha=1.0, beta=-1.0, dx=0.37)
        _fns = [("gsrb_relax", lambda: chip_smoke.fs.gsrb_relax(
                    _f["u"], _f["rhs"], _f["a"], None, nsweeps=4, lo=_c[3],
                    **_kw)),
                ("residual", lambda: chip_smoke.fs.residual(
                    _f["u"], _f["rhs"], _f["a"], None, **_kw))]
        if hasattr(chip_smoke.fs, "residual_restrict"):
            _fns.append(("residual_restrict",
                         lambda: chip_smoke.fs.residual_restrict(
                             _f["u"], _f["rhs"], _f["a"], None, **_kw)))
        for _name, _fn in _fns:
            _split[f"{_name} {_c[0]}"] = {"device_ms": device_ms(_fn),
                                         "host_us": host_us(_fn)}
    for _name, (_fn, _, _, _cases) in chip_smoke.one_launch_kernels().items():
        for _c in _cases:
            if not _c[5]:
                continue
            _f = chip_smoke.level_fields(_c[1], torch.float32, seed=3)
            _kw = dict(kinds=_c[2], rho=_c[4], alpha=1.0, beta=-1.0,
                       dx=0.37, lo=_c[3], nsweeps=2)
            _split[f"{_name} {_c[0]}"] = {
                "device_ms": device_ms(lambda fn=_fn, f=_f, kw=_kw: fn(
                    f["u"], f["rhs"], f["a"], **kw))}
            del _f
            torch.cuda.empty_cache()
    for _c in chip_smoke.SHARD_CASES:
        if not _c[6]:
            continue
        _f = chip_smoke.level_fields(_c[1], torch.float32, seed=4)
        _kw = dict(kinds=_c[2], rho=2.0, alpha=1.0, beta=-1.0, dx=0.37,
                   lo=_c[3], nsweeps=2)
        _ops = chip_smoke.shard_operands(_f, _c[2], _c[4], 4)[_c[5]]
        if "pads" in _ops:
            _name = "multisweep_relax_halo"
            _fn = (lambda o=_ops, kw=_kw: chip_smoke.fs.multisweep_relax(
                o["u"], o["rhs"], o["a"], halo=o["pads"] + (o["meta"],),
                **kw))
        else:
            _name = "multisweep_relax_tiled_pre"
            _fn = (lambda o=_ops, kw=_kw:
                   chip_smoke.fs.multisweep_relax_tiled_pre(
                       *o["pre"], o["meta"], ny_global=o["ny_global"], **kw))
        _split[f"{_name} {_c[0]}"] = {"device_ms": device_ms(_fn),
                                     "host_us": host_us(_fn)}
print(json.dumps({"phase": "gsrb_split", "split": _split}), flush=True)
"""
# Run in every tree after the split probe: one preconditioner application
# on each PRECOND_CASES configuration, and the staged 256^3 chain, printed
# as one line (see the module docstring).
PRECOND_PROBE = """
def _busy_ms(fn):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
                for e in prof.key_averages())
    return total / 1e3 if total else None  # us -> ms; None: nothing seen


def _clock_ms(fn, sync, reps=15):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _timed(fn):
    return {"wall_ms": _clock_ms(fn, True), "host_ms": _clock_ms(fn, False),
            "busy_ms": _busy_ms(fn)}


_precond = {}
with torch.no_grad():
    for _label, _over, _params, _mshape in PRECOND_CASES:
        _params = getattr(chip_smoke, _params)
        _cfg = chip_smoke.mgt.load_params(_params, overrides=list(_over))
        _geom = chip_smoke.generate_hierarchy(_cfg)
        _dev = torch.device("cuda")
        _mesh = None if _mshape is None else chip_smoke.one_card_mesh(
            _mshape)
        _spec = chip_smoke.comp.make_amr_spec(_geom, _cfg, _dev, _mesh)
        _fields = [chip_smoke.ld.problem_fields(_geom, _cfg, l, torch.float64,
                                                _dev)
                   for l in range(_geom.num_levels)]
        _psi = chip_smoke.ld.initial_state(_geom, _cfg, torch.float64,
                                           _dev)["psi"]
        if _mesh is not None and hasattr(chip_smoke.comp, "place"):
            # a tree whose solve holds the cut levels on their shards
            _fields = chip_smoke.pmesh.shard_fields(_fields, _mesh, _geom)
            _psi = chip_smoke.comp.place(_spec, _psi)
        _a, _rhs, _ = chip_smoke.nl.prepare_iteration(_geom, _cfg, _fields,
                                                      _psi)
        _coefs = chip_smoke.comp.build_coefs(_spec, _a)
        _run = lambda: chip_smoke.comp.precond(_spec, _coefs, _rhs)
        _run()
        torch.cuda.synchronize()
        _k0 = dict(chip_smoke.kernel_counts.LAUNCHES)
        _h0 = dict(getattr(chip_smoke.kernel_counts, "HALO", {}))
        _run()
        _calls = {k: v - _k0[k]
                  for k, v in chip_smoke.kernel_counts.LAUNCHES.items()
                  if v != _k0[k]}
        for _k, _v in _timed(_run).items():
            _precond[f"{_label} {_k}"] = _v
        _precond[f"{_label} calls"] = _calls
        if _h0:
            _precond[f"{_label} halo"] = {
                k: v - _h0[k]
                for k, v in chip_smoke.kernel_counts.HALO.items()}
        del _spec, _fields, _psi, _a, _rhs, _coefs, _run
        torch.cuda.empty_cache()
    _spec = chip_smoke.chain_spec((256, 256, 256), (0, 0, 0), chip_smoke.ALL_P,
                                  dx0=0.0625)
    _f = chip_smoke.level_fields((256, 256, 256), torch.float32, seed=2)
    _stage = lambda: chip_smoke.st.restrict_residual(
        chip_smoke.mg._ghost(_spec, 0, _f["u"]), _f["rhs"], _f["a"], None,
        _spec.alpha, _spec.beta, _spec.dx[0])
    for _k, _v in _timed(_stage).items():
        _precond[f"staged_256 {_k}"] = _v
    if hasattr(chip_smoke.fs, "residual_restrict"):
        _fused = lambda: chip_smoke.fs.residual_restrict(
            _f["u"], _f["rhs"], _f["a"], None, kinds=chip_smoke.ALL_P,
            rho=_spec.rho[0], alpha=_spec.alpha, beta=_spec.beta,
            dx=_spec.dx[0])
        for _k, _v in _timed(_fused).items():
            _precond[f"fused_256 {_k}"] = _v
print(json.dumps({"phase": "precond_probe", "precond": _precond}),
      flush=True)
"""
# Run in a tree's first run with --bitwise, after the other probes: hashes of
# the f32 and f64 outputs of gsrb_relax (4 sweeps) in every form that takes
# the level at every LEVEL_CASES and GSRB_CASES case, gsrb_relax_batch
# (every form) at every BATCH_CASES batch, the one-sweep and one-pass entry
# points, tower_down / tower_up at every TOWER_CASES chain, the whole-level
# marches (chip_smoke.one_launch_kernels) at every case but 512^3 and the
# shard marches at every SHARD_CASES case, each at nsweeps 2 and 4, with the
# tree's own tables and seeds (chip_smoke.level_fields: the same inputs in
# every tree); the bf16 tier's outputs of gsrb_relax, the towers and the
# marches where the tree has the tier's form (keys a parent lacks are
# listed, not failed); and the exact decimal strings of the Picard
# histories, Krylov counts and K of the 4-level canonical solve, the
# records' patches configuration with average_down, scale7 and the
# periodic box, and of the tier's runs where the tree has them, printed as
# one line.
BITWISE_PROBE = """
import hashlib


def _digest(ts):
    torch.cuda.synchronize()
    m = hashlib.sha256()
    for t in ts:
        m.update(t.detach().contiguous().cpu().numpy().tobytes())
    return m.hexdigest()[:20]


_cs, _hash = chip_smoke, {}
# the tier's forms this tree has: gsrb_relax and the towers, the marches
_bf16 = "gsrb_relax_bf16" in _cs.kernel_counts.KERNELS
_bf16_march = "multisweep_relax_bf16" in _cs.kernel_counts.KERNELS
_B16 = dict(compute_dtype="bfloat16")
with torch.no_grad():
    for _dt in (torch.float32, torch.float64):
        _n = str(_dt)[6:]
        _cases = [(c[0], c[1], c[2], c[3], c[4], c[5], 1)
                  for c in _cs.LEVEL_CASES]
        _cases += [(c[0], c[1], c[2], c[3], 2.0, c[4], 5)
                   for c in _cs.GSRB_CASES]
        for _cid, _shape, _kinds, _lo, _rho, _wb, _seed in _cases:
            _f = _cs.level_fields(_shape, _dt, seed=_seed, with_b=_wb)
            _kw = dict(kinds=_kinds, rho=_rho, alpha=1.0, beta=-1.0, dx=0.37)
            for _form in _cs.gsrb_forms(_f["u"], _wb, _kinds)[1]:
                _hash[f"gsrb_relax {_cid} {_n} {_form}"] = _digest([
                    _cs.fs.gsrb_launch(_f["u"], _f["rhs"], _f["a"], _f["b"],
                                       nsweeps=4, lo=_lo, form=_form, **_kw)])
            if _bf16 and _dt == torch.float32 and not _wb:
                for _form in _cs.gsrb_forms(_f["u"], False, _kinds, 1)[1]:
                    _hash[f"gsrb_relax_bf16 {_cid} {_form}"] = _digest([
                        _cs.fs.gsrb_launch(_f["u"], _f["rhs"], _f["a"], None,
                                           nsweeps=4, lo=_lo, form=_form,
                                           **_kw, **_B16)])
            del _f
            torch.cuda.empty_cache()
        for _cid, _shape, _kinds, _rho, _los, _ in _cs.BATCH_CASES:
            _fs = [_cs.level_fields(_shape, _dt, seed=20 + k)
                   for k in range(len(_los))]
            _us, _rs, _as = ([f[k] for f in _fs] for k in ("u", "rhs", "a"))
            _kw = dict(kinds=_kinds, rho=_rho, alpha=1.0, beta=-1.0, dx=0.37)
            for _form in _cs.batch_forms(_shape, _us[0].element_size(),
                                         _kinds, len(_los))[1]:
                _hash[f"gsrb_relax_batch {_cid} {_n} {_form}"] = _digest(
                    _cs.fs.gsrb_batch_launch(_us, _rs, _as, nsweeps=4,
                                             los=_los, form=_form, **_kw))
        _f = _cs.level_fields((96, 80, 80), _dt, seed=7, with_b=True)
        _kw = dict(kinds=_cs.ALL_C, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37,
                   lo=(49, 40, 40))
        _args = (_f["u"], _f["rhs"], _f["a"], _f["b"])
        _hash[f"gsrb_full_sweep {_n}"] = _digest(
            [_cs.fs.gsrb_full_sweep(*_args, **_kw)])
        _hash[f"gsrb_half_sweep {_n}"] = _digest(
            [_cs.fs.gsrb_half_sweep(*_args, color=c, **_kw) for c in (0, 1)])
        for _cid, _shape, _kinds, _lo, _ in SWEEP_SHAPES:
            for _wb in (False, True):
                _f = _cs.level_fields(_shape, _dt, seed=13, with_b=_wb)
                _args = (_f["u"], _f["rhs"], _f["a"], _f["b"])
                _kw = dict(kinds=getattr(_cs, _kinds), rho=2.0, alpha=1.0,
                           beta=-1.0, dx=0.37, lo=_lo)
                _t = f"{_cid} {_n} b{int(_wb)}"
                _hash[f"gsrb_full_sweep {_t}"] = _digest(
                    [_cs.fs.gsrb_full_sweep(*_args, **_kw)])
                _hash[f"gsrb_half_sweep {_t}"] = _digest(
                    [_cs.fs.gsrb_half_sweep(*_args, color=c, **_kw)
                     for c in (0, 1)])
                del _f, _args
                torch.cuda.empty_cache()
        for _cid, _shape, _kinds, _lo, _ in _cs.TOWER_CASES:
            _spec = _cs.chain_spec(_shape, _lo, _kinds, dx0=0.11)
            _f = _cs.level_fields(_shape, _dt, seed=2)
            _al = [_f["a"]]
            for _ in range(1, _spec.ndepths):
                _al.append(_cs.st.coarsen_coef(_al[-1], "harmonic")
                           .contiguous())
            _u, _r, _b = _cs.ct.tower_down(_spec, 0, _f["u"], _f["rhs"], _al)
            _hash[f"tower_down {_cid} {_n}"] = _digest(
                list(_u) + list(_r) + [_b])
            _hash[f"tower_up {_cid} {_n}"] = _digest([_cs.ct.tower_up(
                _spec, 0, 0.5 * _b, list(_u), [_f["rhs"]] + list(_r)[:-1],
                _al[:-1])])
            if _bf16 and _dt == torch.float32:
                _sp = _cs.dataclasses.replace(_spec,
                                              smoother_compute="bfloat16")
                _u, _r, _b = _cs.ct.tower_down(_sp, 0, _f["u"], _f["rhs"],
                                               _al)
                _hash[f"tower_down_bf16 {_cid}"] = _digest(
                    list(_u) + list(_r) + [_b])
                _hash[f"tower_up_bf16 {_cid}"] = _digest([_cs.ct.tower_up(
                    _sp, 0, 0.5 * _b, list(_u), [_f["rhs"]] + list(_r)[:-1],
                    _al[:-1])])
        _tiers = [(None, "")]
        if _bf16_march and _dt == torch.float32:
            _tiers.append((_B16, " bf16"))
        for _name, (_fn, _, _chunks, _mc) in (
                _cs.one_launch_kernels().items()):
            for _cid, _shape, _kinds, _lo, _rho, _ in _mc:
                if _cid == "periodic_512":
                    continue
                _f = _cs.level_fields(_shape, _dt, seed=3)
                _kw = dict(kinds=_kinds, rho=_rho, alpha=1.0, beta=-1.0,
                           dx=0.37, lo=_lo)
                for _ns in _chunks:
                    for _x, _t in _tiers:
                        _hash[f"{_name} {_cid} {_n} ns{_ns}{_t}"] = _digest(
                            [_fn(_f["u"], _f["rhs"], _f["a"], nsweeps=_ns,
                                 **_kw, **(_x or {}))])
                del _f
                torch.cuda.empty_cache()
        for _cid, _shape, _kinds, _lo, _ms, _key, _ in _cs.SHARD_CASES:
            _f = _cs.level_fields(_shape, _dt, seed=4)
            _kw = dict(kinds=_kinds, rho=2.0, alpha=1.0, beta=-1.0, dx=0.37,
                       lo=_lo)
            for _ns in _cs.fs.MULTISWEEP_CHUNKS:
                _o = _cs.shard_operands(_f, _kinds, _ms, 2 * _ns,
                                        h_max=_cs.SHARD_COEF_HMAX.get(_cid))
                _o = _o[_key]
                for _x, _t in _tiers:
                    if "pads" in _o:
                        _out = _cs.fs.multisweep_relax(
                            _o["u"], _o["rhs"], _o["a"], nsweeps=_ns,
                            halo=_o["pads"] + (_o["meta"],), **_kw,
                            **(_x or {}))
                    else:
                        _out = _cs.fs.multisweep_relax_tiled_pre(
                            *_o["pre"], _o["meta"],
                            ny_global=_o["ny_global"], nsweeps=_ns, **_kw,
                            **(_x or {}))
                    _hash[f"shard {_cid} {_n} ns{_ns}{_t}"] = _digest([_out])
            del _f
            torch.cuda.empty_cache()
    _runs = [("solve", ["max_level = 3", "precond_precision = single",
                        "verbosity = 0"], _cs.CANONICAL),
             ("patches_avgdown", _cs.RECORDS_BASE + _cs.PATCHES,
              _cs.CANONICAL),
             ("scale7", ["max_level = 6", "max_NL_iterations = 3",
                         "precond_precision = single", "verbosity = 0"],
              _cs.CANONICAL),
             ("periodic", _cs.PERIODIC_BASE, _cs.PERIODIC)]
    if _bf16:
        _runs.append(("solve_avgdown_bf16",
                      _cs.BF16_SOLVE + _cs.BF16_OVERRIDE, _cs.CANONICAL))
    for _label, _over, _params in _runs:
        _run = _cs.run_solve(list(_over), _label, params=_params)
        for _k in ("history", "linear_iters", "K_history"):
            _hash[f"{_label} {_k}"] = [repr(x) for x in _run[_k]]
    # the tier on the march rungs, converged or not
    if _bf16_march:
        for _label, _over, _params in (
                ("scale7_bf16", _cs.BF16_SCALE7, _cs.CANONICAL),
                ("periodic_bf16", _cs.PERIODIC_BASE, _cs.PERIODIC)):
            _run = _cs.tier_solve(list(_over) + _cs.BF16_OVERRIDE, _label,
                                  _params)
            for _k in ("history", "linear_iters", "K_history", "raised"):
                _hash[f"{_label} {_k}"] = repr(_run[_k])
print(json.dumps({"phase": "bitwise", "hashes": _hash}), flush=True)
"""
PRECOND_CASES = (
    ("scale7", ("max_level = 6", "precond_precision = single",
                "verbosity = 0"), "CANONICAL", None),
    ("periodic", ("precond_precision = single", "verbosity = 0"),
     "PERIODIC", None),
    # the sharded phase's meshes, one card named four times
    ("periodic_x4", ("precond_precision = single", "verbosity = 0"),
     "PERIODIC", (4,)),
    ("periodic_2x2", ("precond_precision = single", "verbosity = 0"),
     "PERIODIC", (2, 2)),
    ("scale7_x4", ("max_level = 6", "precond_precision = single",
                   "verbosity = 0"), "CANONICAL", (4,)))
# The one-sweep and one-pass entry points' levels (the sweep probe and the
# bitwise probe): (id, shape, face kinds by chip_smoke's name, lo, the
# dtypes timed, with variable b at 96x80x80 and constant b everywhere)
SWEEP_SHAPES = (
    ("96x80x80", (96, 80, 80), "ALL_C", (49, 40, 40),
     ("float32", "float64")),
    ("256_P", (256, 256, 256), "ALL_P", (0, 0, 0), ("float32",)),
    ("960x144x144", (960, 144, 144), "ALL_D", (0, 0, 0), ("float32",)),
    ("4_P", (4, 4, 4), "ALL_P", (0, 0, 0), ("float32",)),
    ("8_P", (8, 8, 8), "ALL_P", (0, 0, 1), ("float32",)),
)
# Run in every tree after the split probe: gsrb_full_sweep and
# gsrb_half_sweep (colour 0) at each SWEEP_SHAPES level and timed dtype
# (constant b; at 96x80x80 variable b too), with this tree's device_ms,
# host_us, time_ms and wall_ms, the plain version's time and the byte bound
# (each array read once, out written once, at 3.35 TB/s), printed as one
# line.
SWEEP_PROBE = """
_sweep = {}
with torch.no_grad():
    for _cid, _shape, _kinds, _lo, _dts in SWEEP_SHAPES:
        for _dn in _dts:
            for _wb in ((False, True) if _cid == "96x80x80" else (False,)):
                _dt = getattr(torch, _dn)
                _f = chip_smoke.level_fields(_shape, _dt, seed=13,
                                             with_b=_wb)
                _args = (_f["u"], _f["rhs"], _f["a"], _f["b"])
                _kw = dict(kinds=getattr(chip_smoke, _kinds), rho=2.0,
                           alpha=1.0, beta=-1.0, dx=0.37, lo=_lo)
                _fs = chip_smoke.fs
                _bound = ((5 if _wb else 4) * _f["u"].numel()
                          * _f["u"].element_size() / 3.35e12 * 1e3)
                for _name, _fn, _plain in (
                        ("gsrb_full_sweep",
                         lambda: _fs.gsrb_full_sweep(*_args, **_kw),
                         lambda: _fs.gsrb_full_sweep_plain(*_args, **_kw)),
                        ("gsrb_half_sweep",
                         lambda: _fs.gsrb_half_sweep(*_args, color=0, **_kw),
                         lambda: _fs.gsrb_half_sweep_plain(*_args, color=0,
                                                           **_kw))):
                    _key = f"{_name} {_cid}{'_b' if _wb else ''} {_dn}"
                    _dev = device_ms(_fn)
                    _sweep[f"{_key} device_ms"] = _dev
                    _sweep[f"{_key} host_us"] = host_us(_fn)
                    _sweep[f"{_key} ms"] = time_ms(_fn)
                    _sweep[f"{_key} wall_ms"] = wall_ms(_fn)
                    _sweep[f"{_key} plain_ms"] = time_ms(_plain, reps=5,
                                                         warmup=1)
                    _sweep[f"{_key} bound_ms"] = _bound
                    _sweep[f"{_key} reached"] = _bound / _dev
                del _f, _args
                torch.cuda.empty_cache()
print(json.dumps({"phase": "sweep_probe", "sweep": _sweep}), flush=True)
"""
SPLIT_CASES = ("path_l0_64", "path_l1_96x80x80", "path_l2_128x80x80",
               "path_l3_176x64x64", "path_l4_272x80x80")
PHASES = "env,build,kernels"


def timer_source(name: str = "time_ms") -> str:
    """The source of this tree's `chip_smoke.<name>`: time_ms, which every
    run uses in place of its own tree's (a parent may time otherwise), and
    the split probe's device_ms and host_us."""
    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        src = f.read()
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(src, node)
    raise RuntimeError(f"{path}: no {name}")


def runner(phases: str = PHASES, bitwise: bool = False) -> str:
    """Runs chip_smoke.py's main() in the tree whose root is the working
    directory, with this tree's time_ms in place of its own and the host
    probe of the tower wrappers; then the split and precond probes, and
    with `bitwise` the bitwise probe."""
    return ("import json, os, statistics, sys, time\n"
            "sys.path.insert(0, os.getcwd())\n"
            f"sys.argv = ['chip_smoke.py', '--phases', '{phases}']\n"
            "import chip_smoke\n"
            "import torch\n"
            + timer_source() + "\n"
            "chip_smoke.time_ms = time_ms\n"
            f"TOWERS = {TOWERS!r}\n"
            + HOST_PROBE +
            "rc = chip_smoke.main()\n"
            "print(json.dumps({'phase': 'tower_host_us', 'host_us': {\n"
            "    k: statistics.median(v) for k, v in _host.items()}}),\n"
            "    flush=True)\n"
            + timer_source("device_ms") + "\n" + timer_source("host_us")
            + "\n" + timer_source("wall_ms")
            + f"\nSPLIT_CASES = {SPLIT_CASES!r}\n" + SPLIT_PROBE
            + f"SWEEP_SHAPES = {SWEEP_SHAPES!r}\n" + SWEEP_PROBE
            + f"PRECOND_CASES = {PRECOND_CASES!r}\n" + PRECOND_PROBE
            + (BITWISE_PROBE if bitwise else "") +
            "sys.exit(rc)\n")


def kernels_record(stdout: str) -> dict:
    """The kernels phase's line of one chip_smoke.py run."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "kernels"' in line:
            return json.loads(line)
    raise RuntimeError("no kernels line in the run's output")


def march_times(rec: dict) -> dict:
    """{"<kernel> <case>": ms} of the timed f32 march cases (and of the bf16
    tier's, under the kernel's _bf16 name), and
    {"<kernel> <case> device_ms": ms} where the record has the device's own
    time (the towers, gsrb_relax); for the batched kernels also the group
    launch's host time ("... host_us"), each form's device and host time
    ("... device_ms <form>", "... host_us <form>") and one single call's
    host time ("... single_host_us")."""
    out = {}
    for c in rec["checks"]:
        if c.get("dtype") != "float32":
            continue
        for name in MARCH:
            r = c.get(name, {})
            if r.get("ms") is not None:
                out[f"{name} {c['case']}"] = r["ms"]
            if r.get("device_ms") is not None:
                out[f"{name} {c['case']} device_ms"] = r["device_ms"]
            if name.endswith("_batch") and r.get("ms") is not None:
                for k in ("host_us", "group_host_us", "single_host_us"):
                    if r.get(k) is not None:
                        out[f"{name} {c['case']} {k}"] = r[k]
                for k in ("device_ms", "host_us"):
                    for form, v in r.get(f"forms_{k}", {}).items():
                        out[f"{name} {c['case']} {k} {form}"] = v
            for form, ms in r.get("whole_level_relax_ms", {}).items():
                out[f"{name} {c['case']} whole_level_{form}"] = ms
    return out


def sharded_times(stdout: str) -> dict:
    """{"<run> s_per_iteration": median, "<run> precond_<form>_ms": wall}
    of the sharded phase's line of one run ({} where it did not run)."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "sharded"' in line:
            rec = json.loads(line)
            break
    else:
        return {}
    out = {}
    for run in ("sharded_x", "sharded_pencil", "sharded7"):
        r = rec[run]
        out[f"{run} s_per_iteration"] = statistics.median(
            r["s_per_iteration"])
        out[f"{run} unsharded_s_per_iteration"] = statistics.median(
            r["unsharded_s_per_iteration"])
        for form, app in r.get("precond_application", {}).items():
            out[f"{run} precond_{form}_ms"] = app["wall_ms"]
    return out


def host_times(stdout: str) -> dict:
    """{"<kernel> <case>": us} of the f32 tower calls: the host probe's
    line of one run."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "tower_host_us"' in line:
            return {k[:-len(" float32")]: v
                    for k, v in json.loads(line)["host_us"].items()
                    if k.endswith(" float32")}
    raise RuntimeError("no tower_host_us line in the run's output")


def split_times(stdout: str) -> dict:
    """{"<kernel> <case> device_ms|host_us": value}: the split probe's line
    of one run."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "gsrb_split"' in line:
            return {f"{k} {m}": v for k, rec in json.loads(line)[
                "split"].items() for m, v in rec.items()}
    raise RuntimeError("no gsrb_split line in the run's output")


def sweep_times(stdout: str) -> dict:
    """{"<entry point> <level> <dtype> <metric>": value}: the sweep probe's
    line of one run."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "sweep_probe"' in line:
            return json.loads(line)["sweep"]
    raise RuntimeError("no sweep_probe line in the run's output")


def precond_times(stdout: str) -> dict:
    """{"<case> wall_ms|host_ms|busy_ms": value} and the wrapper calls of
    one application ("<case> calls"): the precond probe's line of one
    run."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "precond_probe"' in line:
            return json.loads(line)["precond"]
    raise RuntimeError("no precond_probe line in the run's output")


def build_seconds(stdout: str):
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "build"' in line:
            return json.loads(line)["seconds"]
    return None


def bitwise_hashes(stdout: str) -> dict | None:
    """The bitwise probe's hashes of one run, None where it did not run."""
    for line in stdout.splitlines():
        if line.startswith("{") and '"phase": "bitwise"' in line:
            return json.loads(line)["hashes"]
    return None


def bitwise_summary(runs: list, trees) -> dict:
    """Every tree's bitwise hashes against tree A's: the keys equal, the
    keys that differ, and the keys one of the two lacks."""
    hashes = {r["tree"]: r["bitwise"] for r in runs
              if r.get("bitwise") is not None}
    a, out = hashes["A"], {}
    for tree in trees[1:]:
        b = hashes[tree]
        common = sorted(set(a) & set(b))
        out[tree] = {"equal": sum(a[k] == b[k] for k in common),
                     "differ": [k for k in common if a[k] != b[k]],
                     "only_A": sorted(set(a) - set(b)),
                     "only_" + tree: sorted(set(b) - set(a))}
    return out


def run_tree(root: str, log_path: str, timeout: float,
             phases: str = PHASES,
             bitwise: bool = False) -> tuple[dict, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", runner(phases, bitwise)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=timeout)
    with open(log_path, "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        tail = "\n".join(proc.stdout.splitlines()[-20:])
        raise RuntimeError(f"{root}: chip_smoke.py exit {proc.returncode}:\n"
                           f"{tail}")
    return ({"times": march_times(kernels_record(proc.stdout)),
             "host_us": host_times(proc.stdout),
             "split": split_times(proc.stdout),
             "sweep": sweep_times(proc.stdout),
             "precond": precond_times(proc.stdout),
             "sharded": sharded_times(proc.stdout),
             "bitwise": bitwise_hashes(proc.stdout),
             "build_s": build_seconds(proc.stdout)},
            time.perf_counter() - t0)


def summarize(runs: list, trees, field: str = "times") -> dict:
    """Per numeric case of `field`: each tree's runs, median and spread
    (the trees that have it), and its speed-up over tree A where A has it
    too."""
    cases = sorted(set.union(*(set(r[field]) for r in runs)))
    out = {}
    for case in cases:
        row = {}
        for tree in trees:
            ts = [r[field][case] for r in runs if r["tree"] == tree
                  and isinstance(r[field].get(case), (int, float))]
            if not ts:
                continue
            row[tree] = ts
            row[f"{tree}_median"] = statistics.median(ts)
            row[f"{tree}_spread"] = max(ts) / min(ts) - 1.0
        for tree in trees:
            if tree != "A" and "A" in row and tree in row:
                row[f"{tree}_speedup"] = row["A_median"] / row[f"{tree}_median"]
        if row:
            out[case] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of tree A (an unpacked git archive)")
    ap.add_argument("--out", required=True, help="JSON file to write")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=DIR: one more tree to time, named")
    ap.add_argument("--order", default=None,
                    help="tree names in the order they run, comma-separated")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds one run may take")
    ap.add_argument("--phases", default=PHASES,
                    help="chip_smoke.py phases of every run (with kernels)")
    ap.add_argument("--bitwise", action="store_true",
                    help="also hold every tree's outputs bit for bit to "
                         "tree A's (the bitwise probe, in each tree's "
                         "first run); exit 1 where one differs")
    args = ap.parse_args()
    if "kernels" not in args.phases.split(","):
        print("--phases must include kernels", file=sys.stderr)
        return 2
    roots = {"A": os.path.abspath(args.parent), "B": ROOT}
    for v in args.variant:
        name, _, path = v.partition("=")
        if not name or not path or name in roots:
            print(f"--variant {v!r}: want a new NAME=DIR", file=sys.stderr)
            return 2
        roots[name] = os.path.abspath(path)
    order = (args.order.split(",") if args.order else
             list(roots) + list(roots)[::-1])
    if set(order) != set(roots):
        print(f"--order {order} must name every tree {list(roots)}",
              file=sys.stderr)
        return 2
    for name, root in roots.items():
        if not os.path.exists(os.path.join(root, "chip_smoke.py")):
            print(f"{name}: {root}: no chip_smoke.py", file=sys.stderr)
            return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    runs = []
    for i, tree in enumerate(order):
        rec, secs = run_tree(roots[tree], f"{args.out}.{i}{tree}.log",
                             args.timeout, args.phases,
                             args.bitwise and tree not in order[:i])
        runs.append({"tree": tree, "seconds": secs, **rec})
        print(f"run {i} {tree}: {secs:.1f} s", flush=True)
    result = {"card": card[0] if card else None, "order": order,
              "roots": roots, "runs": runs,
              "cases": summarize(runs, list(roots)),
              "host_us": summarize(runs, list(roots), "host_us"),
              "split": summarize(runs, list(roots), "split"),
              "sweep": summarize(runs, list(roots), "sweep"),
              "precond": summarize(runs, list(roots), "precond"),
              "sharded": summarize(runs, list(roots), "sharded")}
    if args.bitwise:
        result["bitwise"] = bitwise_summary(runs, list(roots))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for case, row in result["cases"].items():
        print(case + ": " + ", ".join(
            f"{t} {row[t + '_median']:.4f} ms"
            + (f" x{row[t + '_speedup']:.3f}" if t + "_speedup" in row
               else "")
            for t in roots if t in row), flush=True)
    for case, row in result["host_us"].items():
        print(case + " host: " + ", ".join(
            f"{t} {row[t + '_median']:.1f} us" for t in roots if t in row),
            flush=True)
    for field in ("split", "sweep", "precond", "sharded"):
        for case, row in result[field].items():
            print(case + ": " + ", ".join(
                f"{t} {row[t + '_median']:.4g}" for t in roots if t in row),
                flush=True)
    if args.bitwise:
        print("bitwise: " + json.dumps(result["bitwise"]), flush=True)
        if any(v["differ"] for v in result["bitwise"].values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
