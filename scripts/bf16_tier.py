#!/usr/bin/env python3
"""The bf16 tier (smoother_precision = bfloat16) end to end: whole solves of
one or more configurations at the f32 tier and at the bf16 one, through the
port on the card or the CPU, or through the JAX package on the CPU (its
Pallas kernels in interpret mode), with smoother = pallas and the f32
preconditioner. One JSON line per run: the Picard history, the Krylov counts
and final linear residuals, the solver's NonConvergenceError where it
raised, the hierarchy's cells, the seconds.

    JAX_PLATFORMS=cpu python scripts/bf16_tier.py --package jax \
        --configs small,canonical1            # the JAX package, CPU
    python scripts/bf16_tier.py --configs small --device cpu   # the port
    python scripts/bf16_tier.py --device cuda --configs patches6 \
        --relax kernel,plain,twin --tiers bfloat16   # the port on the card

`--relax` (the port on the card only) picks what sweeps the levels and the
towers (chip_smoke.install_relax): `kernel` the CUDA kernels (the solver's
own path); `plain` the kernels' plain versions on the card's tensors in
place of every relax wrapper the solver reaches (gsrb_relax, the marches
wavefront_relax and multisweep_relax, the shard marches, the towers: the
JAX body's arithmetic, its arithmetic colour select included); `twin` the
same with the kernels' colour select (`_where`), the arithmetic the tier's
kernels are held to bit for bit. The residual and restriction kernels run
in every mode. It answers whether a
run of the tier that misses a limit or fails on the card does so because of
the kernels or because of the tier's arithmetic, which the plain version
shares with the JAX package (tests/test_torch_bf16_tier.py).

Configurations (name: what, Picard iterations by default):
  small_ad0 / small_ad1  the small BBH set of tests/test_torch_nonlinear.py
                         (16^3 base, L = 16, one refined level),
                         average_down 0 / 1; 3
  small_ml2 / small_ml4  the same refined to max_level 2 / 4, average_down; 4
  canonical1             the canonical parameter file at max_level = 1; 2
  canonical3             at max_level = 3 (chip_smoke.py's solve phase); 6
  patchesN               the canonical file with level_decomposition =
                         patches and average_down = 1 at max_level = N
                         (N = 2..6; 6 is the records' configuration); 12
  patches6_t05           patches6 with refine_threshold = 0.5: the deepest
                         level's dx (100/4096) with small patches; 8
  scale7                 the canonical file at max_level = 6 (the wave
                         rung at 512x96x96 and 960x144x144); 2
  periodic               the periodic box (params/periodic.txt, 256^3: the
                         multisweep rung); 3
Groups: small (small_ad0, small_ad1), deep (small_ml2, small_ml4).
The JAX package's solves take minutes each here (canonical3: about half an
hour on the CPU); the full-size configurations (patches5, patches6) are for
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CANONICAL = os.path.join(ROOT, "mg_ic_code_tpu_torch", "params",
                         "canonical.txt")
PERIODIC = os.path.join(ROOT, "mg_ic_code_tpu_torch", "params",
                        "periodic.txt")
KERNEL_PATH = ["precond_precision = single", "smoother = pallas"]
PATCHES = ["level_decomposition = patches", "average_down = 1"]

# tests/test_nonlinear.py::small_bbh_cfg (16^3 base, L = 16, weak punctures)
SMALL_BBH = dict(
    alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16), max_level=1,
    refine_threshold=0.5, block_factor=4, buffer_size=3,
    num_mg_smooth=4, num_mg_iterations=2, max_iterations=100,
    max_nl_iterations=6, tolerance=1e-10,
    coefficient_average_type="harmonic",
    is_periodic=False, bc_lo=(0, 0, 0), bc_hi=(0, 0, 0), bc_value=0.0,
    G_Newton=1.0, phi_amplitude=0.05, phi_wavelength=1.0,
    bh1_bare_mass=0.2, bh2_bare_mass=0.2,
    bh1_offset=2.0, bh2_offset=-2.0,
    bh1_momentum=0.02, bh2_momentum=-0.02,
    bh1_spin=0.02, bh2_spin=0.02, verbosity=0,
    precond_precision="single", smoother="pallas")

# name: ("small", keyword arguments, iterations), or ("canonical" /
# "periodic", parameter-file overrides, iterations)
CONFIGS = {
    "small_ad0": ("small", dict(average_down=0), 3),
    "small_ad1": ("small", dict(average_down=1), 3),
    "small_ml2": ("small", dict(average_down=1, max_level=2), 4),
    "small_ml4": ("small", dict(average_down=1, max_level=4), 4),
    "canonical1": ("canonical", ["max_level = 1"], 2),
    "canonical3": ("canonical", ["max_level = 3"], 6),
    **{f"patches{n}": ("canonical", [f"max_level = {n}"] + PATCHES, 12)
       for n in range(2, 7)},
    "patches6_t05": ("canonical", ["max_level = 6", "refine_threshold = 0.5"]
                     + PATCHES, 8),
    "scale7": ("canonical", ["max_level = 6"], 2),
    "periodic": ("periodic", [], 3),
}
PARAMS = {"canonical": CANONICAL, "periodic": PERIODIC}
GROUPS = {"small": ["small_ad0", "small_ad1"],
          "deep": ["small_ml2", "small_ml4"]}


def run_port(name: str, tier: str, iterations: int, device: str) -> dict:
    import torch

    import mg_ic_code_tpu_torch as port
    from mg_ic_code_tpu_torch.config import SolverConfig
    from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy
    from mg_ic_code_tpu_torch.solver import nonlinear as nl

    kind, over, _ = CONFIGS[name]
    if kind == "small":
        cfg = SolverConfig(**dict(SMALL_BBH, **over, smoother_precision=tier,
                                  max_nl_iterations=iterations))
    else:
        cfg = port.load_params(PARAMS[kind], overrides=[
            *over, *KERNEL_PATH, f"max_NL_iterations = {iterations}",
            "verbosity = 0", f"smoother_precision = {tier}"])
    geom = generate_hierarchy(cfg, device=device)
    cells = sum(int(torch.tensor(geom.shape(l)).prod())
                for l in range(geom.num_levels))
    log: list = []
    inner = nl.nl_iteration

    def logged(*args, **kw):
        out = inner(*args, **kw)
        log.append([float(out[2]), int(out[4]["iters"]),
                    float(out[4]["final_rnorm"])])
        return out

    nl.nl_iteration = logged
    try:
        nl.poisson_solve(cfg, geom=geom, device=device, verbose=False)
        raised = None
    except nl.NonConvergenceError as e:
        raised = f"NonConvergenceError: {e}"
    finally:
        nl.nl_iteration = inner
    return {"levels": geom.num_levels, "cells": cells, "raised": raised,
            "history": [x[0] for x in log],
            "linear_iters": [x[1] for x in log],
            "linear_residuals": [x[2] for x in log]}


def run_jax(name: str, tier: str, iterations: int) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401  (JAX on the CPU, x64)

    import mg_ic_code_tpu as jax_pkg
    from mg_ic_code_tpu.config import SolverConfig
    from mg_ic_code_tpu.solver import nonlinear as nl

    kind, over, _ = CONFIGS[name]
    if kind == "small":
        cfg = SolverConfig(**dict(SMALL_BBH, **over, smoother_precision=tier,
                                  max_nl_iterations=iterations))
    else:
        cfg = jax_pkg.load_params(PARAMS[kind], overrides=[
            *over, *KERNEL_PATH, f"max_NL_iterations = {iterations}",
            "verbosity = 0", f"smoother_precision = {tier}"])
    try:
        res = nl.poisson_solve(cfg, verbose=False)
    except nl.NonConvergenceError as e:
        return {"raised": f"NonConvergenceError: {e}"}
    return {"raised": None,
            "history": [float(x) for x in res.dpsi_norm_history],
            "linear_iters": [int(x) for x in res.linear_iters],
            "linear_residuals": [float(x) for x in res.linear_residuals]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default="port", choices=("port", "jax"))
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--relax", default="kernel",
                    help="kernel,plain,twin (the port on the card)")
    ap.add_argument("--configs", default="small,deep,canonical1")
    ap.add_argument("--tiers", default="auto,bfloat16")
    ap.add_argument("--iterations", type=int, default=None,
                    help="Picard iterations (default: the configuration's)")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args()
    if args.package == "jax" and args.device != "cpu":
        ap.error("the JAX package runs on the CPU only")
    modes = args.relax.split(",")
    if set(modes) - {"kernel", "plain", "twin"} or (
            args.device == "cpu" and modes != ["kernel"]):
        ap.error("--relax takes kernel, plain, twin; plain and twin on the "
                 "card only (the CPU runs the plain versions)")
    names = [n for c in args.configs.split(",") for n in GROUPS.get(c, [c])]
    for n in names:
        if n not in CONFIGS:
            ap.error(f"unknown configuration {n!r}")
    if args.package == "port":
        import torch

        torch.set_num_threads(min(8, os.cpu_count() or 1))
    for mode in modes:
        if args.package == "port" and args.device == "cuda":
            from chip_smoke import install_relax

            install_relax(mode)
        for name in names:
            for tier in args.tiers.split(","):
                iters = args.iterations or CONFIGS[name][2]
                t0 = time.perf_counter()
                out = (run_jax(name, tier, iters) if args.package == "jax"
                       else run_port(name, tier, iters, args.device))
                line = json.dumps({
                    "config": name, "package": args.package,
                    "device": args.device, "relax": mode,
                    "smoother_precision": tier, **out,
                    "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
