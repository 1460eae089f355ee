"""Entry points of the port for a compile check and a multi-device dry run.

The counterparts of the repo root's `__graft_entry__.py` (which drives the
JAX package):

* `entry()` returns a forward step of the flagship model and its
  arguments: one AMR V-cycle preconditioner application on a 2-level BBH
  hierarchy (prepare, coefficients, initial residual, preconditioner), the
  hot path of the production solve.
* `dryrun_multichip(n)` places every level of a hierarchy on an
  n-position mesh (each level the mesh cuts as its shards,
  parallel/mesh.shard_level_list) and runs ONE full Picard step (prepare,
  coefficients, MG-preconditioned composite BiCGStab, psi update) over it,
  beside the same step without a mesh: a 64^3-base 2-level hierarchy on
  x-slabs, two sibling 32^3 patches under the same base, and, where n is
  even and at least 4, a 32^3-base 2-level hierarchy on (n/2, 2) pencils.
  The dpsi norms must agree (NORM_RTOL), and every cut level of the result
  must come back as its shards. Each case reports its batch groups
  (composite.AMRSolverSpec.batch_groups: the same-shape sibling patches
  swept as one batch), as the JAX package's dry run prints them.

Both run on the CUDA device unless the caller names another (`device`);
a mesh names that device n times unless `devices` lists the positions.
"""

from __future__ import annotations

import torch

from mg_ic_code_tpu_torch import precision

# the step's norm with and without a mesh. With the preconditioner at the
# operands' f64 (the CPU's `auto`) the two differ by the plain sharded ops'
# order of additions only. With the card's f32 preconditioner a cut depth
# is smoothed by the shard march and a whole one by gsrb_relax and the
# tower: each f64 solve stops below 1e-10 of its initial residual, but at
# another point, and the norms differ by ~1e-7 (9e-8 read on an H100):
# the limit is the sharded phase's on step 1 (chip_smoke.py)
NORM_RTOL = {None: 1e-10, "float32": 1e-5}


def tiny_setup(n: int = 16, max_level: int = 1, boxes=None, parent=None):
    """(cfg, geom) of the JAX package's `_tiny_setup`: a 2-level BBH on a
    side-16 box, a base of n^3 and each finer level the middle half of the
    one above refined by 2 (`boxes` / `parent` name another forest)."""
    from mg_ic_code_tpu_torch.config import SolverConfig
    from mg_ic_code_tpu_torch.grid.boxes import Box
    from mg_ic_code_tpu_torch.grid.geometry import geom_from_config

    cfg = SolverConfig(
        alpha=1.0, beta=-1.0, L=16.0, n_cells=(n, n, n),
        max_level=max_level, num_mg_smooth=4, num_mg_iterations=1,
        max_iterations=8, max_nl_iterations=2, tolerance=1e-10,
        coefficient_average_type="harmonic",
        bh1_bare_mass=0.2, bh2_bare_mass=0.2,
        bh1_offset=2.0, bh2_offset=-2.0,
        bh1_momentum=0.02, bh2_momentum=-0.02,
        bh1_spin=0.02, bh2_spin=0.02,
        phi_amplitude=0.05, phi_wavelength=1.0,
    )
    if boxes is None:
        boxes = [Box.from_shape((n, n, n))]
        for _ in range(1, max_level + 1):
            prev = boxes[-1]
            quarter = tuple(s // 4 for s in prev.shape)
            half = tuple(s // 2 for s in prev.shape)
            inner = Box.from_shape(
                half, lo=tuple(l0 + q for l0, q in zip(prev.lo, quarter)))
            boxes.append(inner.refine(2))
    return cfg, geom_from_config(cfg, tuple(boxes), parent)


def _state(cfg, geom, device):
    from mg_ic_code_tpu_torch.physics import level_data as ld

    fields = [ld.problem_fields(geom, cfg, l, torch.float64, device)
              for l in range(geom.num_levels)]
    return fields, ld.initial_state(geom, cfg, torch.float64, device)


def entry(device=None):
    """(fn, example_args): one AMR V-cycle preconditioner application on
    the 2-level 16^3 hierarchy; fn(psi_list, dpsi_list) -> dpsi + e."""
    from mg_ic_code_tpu_torch.solver import composite as comp
    from mg_ic_code_tpu_torch.solver.nonlinear import prepare_iteration

    device = precision.resolve_device(device)
    cfg, geom = tiny_setup(n=16, max_level=1)
    spec = comp.make_amr_spec(geom, cfg, device)
    fields, state = _state(cfg, geom, device)

    @torch.no_grad()
    def step(psi_list, dpsi_list):
        a_list, rhs_list, _ = prepare_iteration(geom, cfg, fields, psi_list)
        coefs = comp.build_coefs(spec, a_list)
        res = comp.composite_residual(spec, coefs, dpsi_list, rhs_list,
                                      False)
        e = comp.precond(spec, coefs, res)
        return [d + ei for d, ei in zip(dpsi_list, e)]

    return step, (state["psi"], state["dpsi"])


@torch.no_grad()
def full_step(cfg, geom, device, mesh=None):
    """One Picard step (prepare, coefficients, solve_linear, finish) from
    psi = 1, dpsi = 0, with the levels placed on `mesh` (None: whole on
    `device`): (psi, dpsi, dpsi norm, K, Krylov iterations, the
    preconditioner's precision: composite.AMRSolverSpec.precond_dtype)."""
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh
    from mg_ic_code_tpu_torch.solver import composite as comp
    from mg_ic_code_tpu_torch.solver.nonlinear import (
        finish_iteration, prepare_iteration,
    )

    fields, state = _state(cfg, geom, device)
    psi, dpsi = state["psi"], state["dpsi"]
    if mesh is not None:
        psi = pmesh.shard_level_list(psi, mesh, geom)
        dpsi = pmesh.shard_level_list(dpsi, mesh, geom)
        fields = pmesh.shard_fields(fields, mesh, geom)
    spec = comp.make_amr_spec(geom, cfg, device, mesh)
    a_list, rhs_list, k = prepare_iteration(geom, cfg, fields, psi)
    coefs = comp.build_coefs(spec, a_list)
    out = comp.solve_linear(spec, coefs, rhs_list, dpsi)
    psi_new, norm = finish_iteration(geom, psi, out.x)
    return psi_new, out.x, float(norm), float(k), int(out.iters), (
        spec.precond_dtype)


def _check_cut(geom, mesh, psi, what: str) -> list:
    """Every level of `psi` placed as the mesh cuts it; the cuts."""
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh
    from mg_ic_code_tpu_torch.parallel.shards import ShardSet

    cuts = []
    for l, p in enumerate(psi):
        counts = pmesh.shard_counts(mesh, geom.shape(l))
        placed = (isinstance(p, ShardSet) and p.counts == counts) if (
            counts != (1, 1, 1)) else isinstance(p, torch.Tensor)
        assert placed, f"{what}: level {l} lost its placement ({counts})"
        cuts.append(counts)
    return cuts


def dryrun_multichip(n_devices: int, device=None, devices=None) -> dict:
    """ONE full Picard step over an n-position mesh against the same step
    without one (module docstring): x-slabs on a 64^3-base 2-level
    hierarchy, a 2-patch forest under the same base, (n/2, 2) pencils on a
    32^3 base where n is even and at least 4. Returns {case: {norm,
    serial_norm, rel_diff, limit, krylov, cuts, batch_groups}}; raises
    where a norm differs by more than NORM_RTOL or a cut level lost its
    placement."""
    from mg_ic_code_tpu_torch.grid.boxes import Box
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh
    from mg_ic_code_tpu_torch.solver import composite as comp

    device = precision.resolve_device(device)
    devices = list(devices) if devices is not None else [device] * n_devices
    assert len(devices) == n_devices, (len(devices), n_devices)
    cases = {"x_slabs": (tiny_setup(n=64, max_level=1), None),
             "forest": (tiny_setup(
                 n=64, max_level=1, parent=(-1, 0, 0),
                 boxes=(Box.from_shape((64, 64, 64)),
                        Box.from_shape((32, 32, 32), lo=(8, 48, 48)),
                        Box.from_shape((32, 32, 32), lo=(88, 48, 48)))),
                 None)}
    if n_devices >= 4 and n_devices % 2 == 0:
        cases["pencils"] = (tiny_setup(n=32, max_level=1),
                            (n_devices // 2, 2))
    out = {}
    for name, ((cfg, geom), shape) in cases.items():
        mesh = pmesh.make_mesh(devices, shape)
        _, _, serial, _, it_serial, prec = full_step(cfg, geom, device)
        psi, _, norm, _, it, _ = full_step(cfg, geom, device, mesh)
        rel = abs(norm - serial) / abs(serial)
        assert norm > 0 and rel <= NORM_RTOL[prec], (
            f"dryrun_multichip({n_devices}) {name}: sharded dpsi norm "
            f"{norm!r} != serial {serial!r} ({rel} > {NORM_RTOL[prec]})")
        out[name] = {"norm": norm, "serial_norm": serial, "rel_diff": rel,
                     "limit": NORM_RTOL[prec], "krylov": it,
                     "serial_krylov": it_serial, "mesh": mesh.shape,
                     "cuts": _check_cut(geom, mesh, psi, name),
                     "batch_groups": comp.make_amr_spec(
                         geom, cfg, device, mesh).batch_groups}
    return out
