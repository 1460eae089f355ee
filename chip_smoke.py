#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # all phases (needs one CUDA device)
    python3 chip_smoke.py --phases env,build,kernels

Phases, each printing one JSON line; any failure exits non-zero:

  env      card name and power limit (nvidia-smi), torch / CUDA versions,
           whether h5py imports
  build    compiles csrc/*.cu with nvcc for sm_90a; seconds, registers
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           f32 and f64, at the main path's level shapes and at awkward ones
           (odd parity offset, mixed faces, a periodic axis, a 20M-cell
           level), with its time, the plain version's time and its bound
  solve    the canonical binary-black-hole configuration with max_level = 3
           through load_params -> generate_hierarchy -> poisson_solve on
           the card; the launch counters show the path went through every
           kernel and through no plain version; the same solve with the
           staged smoother (no kernels) must agree
  lock3    max_level = 2 against the recorded first-step norm and plateau
  scale7   max_level = 6 (7 levels, 28.5M refined cells), 3 Picard steps,
           against the recorded f64 history

Then one line {"kernels": [...]} (per kernel: launches on the main path =
wrapper calls that reached the card, device_launches = the kernel launches
those calls enqueued, error against the plain version, time, plain time,
bound), the nvidia-smi
line, and the final {"ok": true, "device": {...}} line.

The recorded values are the Picard histories of the same configuration in
double precision on a CPU (7 levels: 0.27342222391586096 ->
1.0170868859107062e-4 -> 2.888833383836128e-7; 3 levels, first step:
0.2643130351285558).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import mg_ic_code_tpu_torch as mgt  # noqa: E402
from mg_ic_code_tpu_torch.grid.boxes import Box  # noqa: E402
from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy  # noqa: E402
from mg_ic_code_tpu_torch.ops import coarse_tower as ct  # noqa: E402
from mg_ic_code_tpu_torch.ops import cuda_ext, kernel_counts  # noqa: E402
from mg_ic_code_tpu_torch.ops import fused_sweeps as fs  # noqa: E402
from mg_ic_code_tpu_torch.ops import stencils as st  # noqa: E402
from mg_ic_code_tpu_torch.solver import multigrid as mg  # noqa: E402
from mg_ic_code_tpu_torch.solver.nonlinear import poisson_solve  # noqa: E402

CANONICAL = os.path.join(os.path.dirname(mgt.__file__), "params",
                         "canonical.txt")

# recorded double-precision histories of the canonical configuration
LOCK3_FIRST = 0.2643130351285558
SCALE7 = (0.27342222391586096, 1.0170868859107062e-4)
SCALE7_SHAPES = [(64, 64, 64), (96, 80, 80), (128, 80, 80), (176, 64, 64),
                 (272, 80, 80), (512, 96, 96), (960, 144, 144)]

# NVIDIA H100 SXM data sheet: device memory rate and f32 rate outside the
# tensor cores (the bound of a kernel is the larger of bytes / HBM_BYTES_S
# and operations / F32_FLOPS)
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12

TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
D, N, P, C = "dirichlet", "neumann", "periodic", "cf"
ALL_D = ((D, D), (D, D), (D, D))
ALL_C = ((C, C), (C, C), (C, C))

SOURCES = {
    "gsrb_relax": ("mg_ic_code_tpu_torch/csrc/gsrb_relax.cu",
                   "mg_ic_code_tpu/ops/fused_sweeps.py:1032"),
    "residual": ("mg_ic_code_tpu_torch/csrc/residual.cu",
                 "mg_ic_code_tpu/ops/fused_sweeps.py:1055"),
    "tower_down": ("mg_ic_code_tpu_torch/csrc/tower.cu",
                   "mg_ic_code_tpu/ops/coarse_tower.py:206"),
    "tower_up": ("mg_ic_code_tpu_torch/csrc/tower.cu",
                 "mg_ic_code_tpu/ops/coarse_tower.py:234"),
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 12, warmup: int = 3) -> float:
    """Median over `reps` of one call's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


# ------------------------------------------------------------------- env


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    try:
        import h5py  # noqa: F401

        h5 = True
    except ImportError:
        h5 = False
    from mg_ic_code_tpu_torch.grid import br_native

    out = {
        "phase": "env", "card": card, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "h5py": h5, "native_clustering": br_native.native_available(),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
    }
    check(not out["tf32_matmul"] and not out["tf32_cudnn"], "TF32 is on")
    emit(out)
    return out


# ----------------------------------------------------------------- build


def phase_build() -> dict:
    t0 = time.perf_counter()
    cuda_ext.lib()
    info = dict(cuda_ext.BUILD_INFO)
    regs = {}
    if os.path.exists(info["log"]):
        log = open(info["log"]).read()
        # ptxas -v: "Compiling entry function '<mangled>' ..." then
        # "Used N registers"
        for name, used in re.findall(
            r"Compiling entry function '([^']+)'.*?Used (\d+) registers",
            log, flags=re.S,
        ):
            regs[name] = max(int(used), regs.get(name, 0))
    out = {
        "phase": "build", "seconds": round(time.perf_counter() - t0, 3),
        "cached": info["cached"], "library": os.path.relpath(
            info["library"], ROOT),
        "flags": list(cuda_ext.NVCC_FLAGS),
        "max_registers": max(regs.values()) if regs else None,
        "entry_functions": len(regs),
    }
    emit(out)
    return out


# --------------------------------------------------------------- kernels


def level_fields(shape, dtype, seed: int, with_b: bool = False):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mk = lambda: torch.randn(shape, dtype=dtype, device="cuda", generator=g)
    f = {"u": mk(), "rhs": mk(),
         "a": 0.5 + 1.5 * torch.rand(shape, dtype=dtype, device="cuda",
                                     generator=g)}
    f["b"] = (0.5 + 1.5 * torch.rand(shape, dtype=dtype, device="cuda",
                                     generator=g)) if with_b else None
    return f


def rel_err(out, ref):
    """(max abs error, that error over max|ref|)."""
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def chain_spec(shape, lo, kinds, dx0: float, nsmooth: int = 4):
    """A LevelMGSpec whose depth chain coarsens `shape` while it stays
    2-coarsenable with every side >= 4 (what make_level_spec builds from a
    hierarchy)."""
    boxes = [Box.from_shape(tuple(shape), tuple(lo))]
    while boxes[-1].coarsenable(2) and min(
            boxes[-1].coarsen(2).shape) >= 4:
        boxes.append(boxes[-1].coarsen(2))
    n = len(boxes)
    return mg.LevelMGSpec(
        kinds=kinds, boxes=tuple(boxes),
        dx=tuple(dx0 * 2**d for d in range(n)),
        rho=tuple(2.0 ** (1 - d) for d in range(n)),
        alpha=1.0, beta=-1.0, nsmooth=nsmooth, smoother="pallas",
    )


def level_bytes(ncells: int, itemsize: int, arrays: int) -> float:
    return float(arrays * ncells * itemsize)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# level cases: (id, shape, kinds, lo, rho, with_b, timed)
LEVEL_CASES = [
    ("path_l0_64", (64, 64, 64), ALL_D, (0, 0, 0), 2.0, False, True),
    ("path_l1_96x80x80", (96, 80, 80), ALL_C, (48, 40, 40), 2.0, False, True),
    ("path_l2_128x80x80", (128, 80, 80), ALL_C, (160, 120, 120), 2.0, False,
     True),
    ("path_l3_176x64x64", (176, 64, 64), ALL_C, (416, 288, 288), 2.0, False,
     True),
    ("odd_lo_96x80x80", (96, 80, 80), ALL_C, (49, 40, 40), 2.0, False,
     False),
    ("mixed_faces", (40, 56, 48), ((D, C), (N, D), (C, N)), (3, 0, 8), 2.0,
     True, False),
    ("periodic_axis", (32, 48, 40), ((P, P), (D, C), (C, N)), (0, 7, 0), 0.5,
     False, False),
    ("big_960x144x144", (960, 144, 144), ALL_C, (0, 0, 0), 2.0, False, True),
]

# tower cases: (id, shape, kinds, lo, timed); the first is the main path's
TOWER_CASES = [
    ("path_l0_64", (64, 64, 64), ALL_D, (0, 0, 0), True),
    ("l3_176x64x64", (176, 64, 64), ALL_C, (416, 288, 288), False),
    ("mixed_faces", (32, 48, 40), ((D, C), (N, D), (C, N)), (16, 0, 8),
     False),
    ("periodic_axis", (32, 32, 32), ((P, P), (D, C), (C, N)), (0, 0, 0),
     False),
]


def check_level_case(case, dtype) -> dict:
    cid, shape, kinds, lo, rho, with_b, timed = case
    f = level_fields(shape, dtype, seed=1, with_b=with_b)
    kw = dict(kinds=kinds, rho=rho, alpha=1.0, beta=-1.0, dx=0.37)
    ncells = shape[0] * shape[1] * shape[2]
    isz = f["u"].element_size()
    rec = {"case": cid, "shape": list(shape), "dtype": str(dtype)[6:],
           "tolerance": TOL[dtype]}

    relax = lambda fn: fn(f["u"], f["rhs"], f["a"], f["b"], nsweeps=4,
                          lo=lo, **kw)
    out, ref = relax(fs.gsrb_relax), relax(fs.gsrb_relax_plain)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    rec["gsrb_relax"] = {"max_abs_err": err, "rel_err": rel}
    check(rel <= TOL[dtype] and bool(torch.isfinite(out).all()),
          f"gsrb_relax {cid} {dtype}: rel err {rel} > {TOL[dtype]}")
    # the input is not modified (the kernel sweeps a copy in place)
    check(not torch.equal(out, f["u"]), f"gsrb_relax {cid}: no update")

    resid = lambda fn: fn(f["u"], f["rhs"], f["a"], f["b"], **kw)
    out, ref = resid(fs.residual), resid(fs.residual_plain)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    rec["residual"] = {"max_abs_err": err, "rel_err": rel}
    check(rel <= TOL[dtype], f"residual {cid} {dtype}: rel err {rel}")

    if timed:
        narr = 4 + (1 if with_b else 0)
        b, by = bound_ms(level_bytes(ncells, isz, narr), 4 * 32.0 * ncells)
        rec["gsrb_relax"].update(
            ms=time_ms(lambda: relax(fs.gsrb_relax)),
            plain_ms=time_ms(lambda: relax(fs.gsrb_relax_plain), reps=10,
                             warmup=1),
            bound_ms=b, bound_by=by)
        b, by = bound_ms(level_bytes(ncells, isz, narr), 16.0 * ncells)
        rec["residual"].update(
            ms=time_ms(lambda: resid(fs.residual)),
            plain_ms=time_ms(lambda: resid(fs.residual_plain), reps=10,
                             warmup=1),
            bound_ms=b, bound_by=by)
    return rec


def check_tower_case(case, dtype) -> dict:
    cid, shape, kinds, lo, timed = case
    spec = chain_spec(shape, lo, kinds, dx0=0.11)
    ndep = spec.ndepths
    check(ct.tower_supported(spec, {"b": (None,) * ndep}, 0),
          f"tower case {cid} not tower-shaped")
    f = level_fields(shape, dtype, seed=2)
    a_list = [f["a"]]
    for _ in range(1, ndep):
        a_list.append(st.coarsen_coef(a_list[-1], "harmonic").contiguous())
    rec = {"case": cid, "shape": list(shape), "depths": ndep,
           "dtype": str(dtype)[6:], "tolerance": TOL[dtype]}

    down = lambda fn: fn(spec, 0, f["u"], f["rhs"], a_list)
    (ku, kr, kb), (pu, pr, pb) = down(ct.tower_down), down(
        ct.tower_down_plain)
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for k, p in zip(list(ku) + list(kr) + [kb], list(pu) + list(pr) + [pb]):
        err, rel = rel_err(k, p)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    rec["tower_down"] = {"max_abs_err": worst_abs, "rel_err": worst_rel}
    check(worst_rel <= TOL[dtype],
          f"tower_down {cid} {dtype}: rel err {worst_rel}")

    # up pass from the plain down pass's outputs, on both sides
    e_bot = 0.5 * pb
    rhs_list = [f["rhs"]] + list(pr)
    up = lambda fn: fn(spec, 0, e_bot, list(pu), rhs_list[:-1], a_list[:-1])
    out, ref = up(ct.tower_up), up(ct.tower_up_plain)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    rec["tower_up"] = {"max_abs_err": err, "rel_err": rel}
    check(rel <= TOL[dtype], f"tower_up {cid} {dtype}: rel err {rel}")

    if timed:
        isz = f["u"].element_size()
        cells = [b.num_cells for b in spec.boxes]
        # down: reads u0, rhs0 and every a_d; writes every u_d and the
        # restricted rhs_d (d >= 1)
        nbytes = isz * (2 * cells[0] + sum(cells) + sum(cells)
                        + sum(cells[1:]))
        flops = sum((4 * 32.0 + 16.0) * c for c in cells)
        b, by = bound_ms(nbytes, flops)
        rec["tower_down"].update(
            ms=time_ms(lambda: down(ct.tower_down)),
            plain_ms=time_ms(lambda: down(ct.tower_down_plain), reps=10,
                             warmup=1),
            bound_ms=b, bound_by=by)
        # up: reads e_bot and u_d, rhs_d, a_d above the bottom; writes u_0
        up_cells = sum(cells[:-1])
        nbytes = isz * (cells[-1] + 3 * up_cells + cells[0])
        b, by = bound_ms(nbytes, (4 * 32.0 + 1.0) * up_cells)
        rec["tower_up"].update(
            ms=time_ms(lambda: up(ct.tower_up)),
            plain_ms=time_ms(lambda: up(ct.tower_up_plain), reps=10,
                             warmup=1),
            bound_ms=b, bound_by=by)
    return rec


def phase_kernels() -> dict:
    checks = []
    for dtype in (torch.float32, torch.float64):
        for case in LEVEL_CASES:
            checks.append(check_level_case(case, dtype))
            torch.cuda.empty_cache()
        for case in TOWER_CASES:
            checks.append(check_tower_case(case, dtype))
    # wrappers raise on what the kernels do not take (no silent fallback)
    u = torch.zeros((8, 8, 8), dtype=torch.float32, device="cuda")
    kw = dict(nsweeps=1, kinds=ALL_D, rho=2.0, alpha=1.0, beta=-1.0, dx=1.0,
              lo=(0, 0, 0))
    for bad in (u.to(torch.float16), u[:, :, ::2], u[:4]):
        try:
            fs.gsrb_relax(bad, u, u, **kw)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure("gsrb_relax accepted a bad operand")
    out = {"phase": "kernels",
           "kernels": ["gsrb_relax", "residual", "tower_down", "tower_up"],
           "tolerance": {"float32": TOL[torch.float32],
                         "float64": TOL[torch.float64],
                         "of": "max|reference| (4 sweeps per relaxation)"},
           "checks": checks}
    emit(out)
    return out


# ---------------------------------------------------------------- solves


def run_solve(overrides, label: str) -> dict:
    """load_params -> generate_hierarchy -> poisson_solve on the card."""
    cfg = mgt.load_params(CANONICAL, overrides=list(overrides))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, calls, reserved = [], [], []

    def hook(nl_iter, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        calls.append(dict(kernel_counts.LAUNCHES))
        reserved.append(torch.cuda.memory_reserved())

    t0 = time.perf_counter()
    geom = generate_hierarchy(cfg)
    t_hier = time.perf_counter() - t0
    res = poisson_solve(cfg, geom=geom, verbose=False, output_hook=hook)
    torch.cuda.synchronize()
    hook(None, None)
    per_iter = [b - a for a, b in zip(stamps, stamps[1:])]
    # wrapper calls that reached the card, per Picard iteration, as
    # [gsrb_relax, residual, tower_down, tower_up]
    calls_per_iter = [[b[k] - a[k] for k in kernel_counts.KERNELS]
                      for a, b in zip(calls, calls[1:])]
    for p in res.psi:
        check(p.is_cuda and p.dtype == torch.float64, "psi not f64 on cuda")
        check(bool(torch.isfinite(p).all()), "psi not finite")
        check(0.5 < float(p.min()) and float(p.max()) < 2.0,
              "psi out of range")
    return {
        "label": label, "overrides": list(overrides),
        "levels": [list(b.shape) for b in geom.boxes],
        "history": res.dpsi_norm_history, "linear_iters": res.linear_iters,
        "linear_residuals": res.linear_residuals,
        "hierarchy_s": t_hier, "s_per_iteration": per_iter,
        "kernel_calls_per_iteration": calls_per_iter,
        "memory_reserved_per_iteration": reserved[1:],
        "total_s": time.perf_counter() - t0,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def phase_solve() -> dict:
    base = ["max_level = 3", "precond_precision = single", "verbosity = 0"]
    kernel_counts.reset()
    main = run_solve(base, "main")
    counts = kernel_counts.snapshot()  # the main path's run, nothing else
    h, it = main["history"], main["linear_iters"]
    check(main["levels"] == [list(s) for s in SCALE7_SHAPES[:4]],
          f"unexpected hierarchy {main['levels']}")
    check(all(v > 0 for v in counts["launches"].values()),
          f"a kernel was never launched: {counts}")
    check(all(v == 0 for v in counts["plain_calls"].values()),
          f"a plain version ran on the card's path: {counts}")
    check(h[0] > h[1] > h[2], f"history not decreasing: {h}")
    check(all(i <= 4 for i in it), f"linear iters {it}")
    staged = run_solve(base + ["smoother = xla", "max_NL_iterations = 2"],
                       "staged")
    rel = abs(staged["history"][0] - h[0]) / h[0]
    check(rel <= 1e-6, f"staged smoother first step differs: {rel}")
    n_iter = len(h)
    out = {
        "phase": "solve", "main": main, "staged_first_step":
        staged["history"][0], "staged_rel_diff": rel,
        "staged_s_per_iteration": staged["s_per_iteration"],
        # launches = wrapper calls that reached the card; each enqueues
        # several kernel launches from one C call (device_launches)
        "launches": counts["launches"],
        "device_launches": counts["device_launches"],
        "plain_calls": counts["plain_calls"],
        "launches_per_picard_iteration": {
            k: v / n_iter for k, v in counts["launches"].items()},
    }
    emit(out)
    return out


def phase_lock3() -> dict:
    run = run_solve(["max_level = 2", "precond_precision = single",
                     "verbosity = 0"], "lock3")
    h = run["history"]
    rel = abs(h[0] - LOCK3_FIRST) / LOCK3_FIRST
    check(rel <= 1e-6, f"3-level first step {h[0]} vs {LOCK3_FIRST}")
    check(min(h) < 5e-8, f"3-level plateau {min(h)}")
    out = {"phase": "lock3", "first_step_rel_diff": rel, "plateau": min(h),
           **run}
    emit(out)
    return out


def phase_scale7() -> dict:
    run = run_solve(["max_level = 6", "max_NL_iterations = 3",
                     "precond_precision = single", "verbosity = 0"],
                    "scale7")
    h, it = run["history"], run["linear_iters"]
    check(run["levels"] == [list(s) for s in SCALE7_SHAPES],
          f"unexpected hierarchy {run['levels']}")
    rel1 = abs(h[0] - SCALE7[0]) / SCALE7[0]
    rel2 = abs(h[1] - SCALE7[1]) / SCALE7[1]
    check(rel1 <= 1e-5, f"7-level step 1 {h[0]} vs {SCALE7[0]}")
    check(rel2 <= 2e-2, f"7-level step 2 {h[1]} vs {SCALE7[1]}")
    check(h[2] < 1e-6, f"7-level step 3 {h[2]}")
    check(all(i <= 3 for i in it), f"7-level linear iters {it}")
    out = {"phase": "scale7", "step1_rel_diff": rel1, "step2_rel_diff": rel2,
           **run}
    emit(out)
    return out


# --------------------------------------------------------------- summary


def kernels_line(kernels: dict | None, solve: dict | None) -> dict:
    """The per-kernel summary: numbers of the f32 main-path shapes (the
    largest level of the slice's hierarchy for the two level kernels, the
    64^3 depth chain for the towers)."""
    rows = []
    pick = {"gsrb_relax": "path_l3_176x64x64", "residual":
            "path_l3_176x64x64", "tower_down": "path_l0_64",
            "tower_up": "path_l0_64"}
    for name in kernel_counts.KERNELS:
        rec = {}
        if kernels is not None:
            for c in kernels["checks"]:
                if (c["case"] == pick[name] and c["dtype"] == "float32"
                        and name in c and "ms" in c[name]):
                    rec = dict(c[name], shape=c["shape"])
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": solve["launches"][name] if solve else None,
            "device_launches": (solve["device_launches"][name] if solve
                                else None),
            "max_abs_err": rec.get("max_abs_err"),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"), "library_ms": None,
            "shape": rec.get("shape"), "dtype": "float32",
        })
    return {"kernels": rows}


PHASES = ("env", "build", "kernels", "solve", "lock3", "scale7")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    wanted = [p for p in args.phases.split(",") if p]
    unknown = [p for p in wanted if p not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    fns = {"env": phase_env, "build": phase_build, "kernels": phase_kernels,
           "solve": phase_solve, "lock3": phase_lock3,
           "scale7": phase_scale7}
    done: dict = {}
    try:
        with torch.no_grad():
            for name in PHASES:
                if name in wanted:
                    done[name] = fns[name]()
        bad = [m for m in sys.modules
               if m in ("jax", "jaxlib", "mg_ic_code_tpu")
               or m.startswith(("jax.", "mg_ic_code_tpu."))]
        check(not bad, f"foreign modules were imported: {bad}")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    emit({"phase": "done", "phases": wanted,
          "seconds": round(time.perf_counter() - t_start, 1)})
    emit(kernels_line(done.get("kernels"), done.get("solve")))
    card = done["env"]["card"] if "env" in done else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
