"""Per-level problem-data setup: the physics formulas of the Picard loop.

Vectorised port of the reference's SetLevelData.cpp point loops:
`set_initial_conditions`, `set_rhs`, `set_constant_K_integrand`,
`set_regrid_condition`, `set_m_value`, `set_a_coef`, `set_b_coef`,
`set_output_data`.

Static problem fields (phi, bar A_ij, A^2, rho_grad, psi_bh) depend only on
coordinates, so they are evaluated once per level; only psi evolves across
nonlinear iterations. rho_grad is computed from phi evaluated analytically
on a one-cell-grown box — exactly how the reference gets phi ghosts (it
evaluates the profile over the entire ghosted box).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.physics import bowen_york as by
from mg_ic_code_tpu_torch.physics.scalar_field import phi_profile
from mg_ic_code_tpu_torch.physics.variables import (
    GRCHOMBO_INDEX, NUM_GRCHOMBO_VARS,
)
from mg_ic_code_tpu_torch.precision import resolve_device


def m_value(cfg: SolverConfig, constant_K):
    """m(K, rho) = 2/3 K^2 - 16 pi G rho, with rho = 1/2 Pi^2 + V(phi) = 0
    for now (the gradient part of rho is kept separate)."""
    rho = 0.0
    return (2.0 / 3.0) * constant_K * constant_K - 16.0 * math.pi * cfg.G_Newton * rho


def problem_fields(
    geom: HierarchyGeom, cfg: SolverConfig, level: int,
    dtype=torch.float64, device=None, region=None,
) -> dict:
    """Static per-level fields: phi, rho_grad, A^2, psi_bh (+ raw A_ij for
    output). Everything the reference stores in multigrid_vars except psi.
    `region` (slices of the level's array, e.g. one shard's) evaluates the
    fields of that part only, from the same cell coordinates."""
    device = resolve_device(device)

    def dev(c):
        return torch.as_tensor(c, dtype=dtype, device=device)

    x, y, z = geom.coords(level)
    xg, yg, zg = geom.coords(level, grow=1)
    shape = geom.shape(level)
    if region is not None:
        cut = lambda c, ax, g: np.take(  # noqa: E731
            c, range(region[ax].start, region[ax].stop + 2 * g), axis=ax)
        x, y, z = cut(x, 0, 0), cut(y, 1, 0), cut(z, 2, 0)
        xg, yg, zg = cut(xg, 0, 1), cut(yg, 1, 1), cut(zg, 2, 1)
        shape = tuple(sl.stop - sl.start for sl in region)
    x, y, z = dev(x), dev(y), dev(z)
    xg, yg, zg = dev(xg), dev(yg), dev(zg)

    phi_gh = torch.broadcast_to(
        phi_profile(xg, yg, zg, cfg), tuple(s + 2 for s in shape)
    )
    rho_grad = st.grad_energy(phi_gh, geom.dx[level])

    aij = by.binary_bh_aij(x, y, z, cfg)
    aij = {
        k: torch.broadcast_to(v.to(dtype), shape).contiguous()
        for k, v in aij.items()
    }
    return {
        "phi": phi_gh[1:-1, 1:-1, 1:-1].contiguous(),
        "rho_grad": rho_grad,
        "aij": aij,
        "aij2": by.aij_squared(aij),
        "psi_bh": torch.broadcast_to(
            by.psi_bh(x, y, z, cfg).to(dtype), shape
        ).contiguous(),
    }


def initial_state(
    geom: HierarchyGeom, cfg: SolverConfig, dtype=torch.float64, device=None
) -> dict:
    """psi = 1 (regular part only; the singular psi_bh is analytic and never
    stored) and dpsi = 0 on every level."""
    device = resolve_device(device)
    psi = [torch.ones(geom.shape(l), dtype=dtype, device=device)
           for l in range(geom.num_levels)]
    dpsi = [torch.zeros(geom.shape(l), dtype=dtype, device=device)
            for l in range(geom.num_levels)]
    return {"psi": psi, "dpsi": dpsi}


def set_rhs(psi_gh, fields, cfg: SolverConfig, dx, constant_K):
    """rhs = 1/8 m psi_0^5 - 1/8 A^2 psi_0^-7 - 2 pi G rho_grad psi_0
           - Lap(psi). psi_gh carries ghosts."""
    psi0 = psi_gh[1:-1, 1:-1, 1:-1] + fields["psi_bh"]
    m = m_value(cfg, constant_K)
    return (
        0.125 * m * psi0**5
        - 0.125 * fields["aij2"] * psi0**-7
        - 2.0 * math.pi * cfg.G_Newton * fields["rho_grad"] * psi0
        - st.laplacian(psi_gh, dx)
    )


def set_a_coef(psi, fields, cfg: SolverConfig, constant_K):
    """aCoef = -0.625 m psi_0^4 - A^2 psi_0^-8 + 2 pi G rho_grad. Needs no
    ghosts."""
    psi0 = psi + fields["psi_bh"]
    m = m_value(cfg, constant_K)
    return (
        -0.625 * m * psi0**4
        - fields["aij2"] * psi0**-8
        + 2.0 * math.pi * cfg.G_Newton * fields["rho_grad"]
    )


def constant_k_integrand(psi_gh, fields, cfg: SolverConfig, dx):
    """integrand = -1.5 m + 1.5 A^2 psi_0^-12 + 24 pi G rho_grad psi_0^-4
    + 12 Lap(psi) psi_0^-5, with m evaluated at K=0."""
    psi0 = psi_gh[1:-1, 1:-1, 1:-1] + fields["psi_bh"]
    m = m_value(cfg, 0.0)
    return (
        -1.5 * m
        + 1.5 * fields["aij2"] * psi0**-12
        + 24.0 * math.pi * cfg.G_Newton * fields["rho_grad"] * psi0**-4
        + 12.0 * st.laplacian(psi_gh, dx) * psi0**-5
    )


def regrid_condition(psi, fields, cfg: SolverConfig):
    """Abs-valued refinement indicator + log(psi_0) BH-proximity term, m at
    K=0."""
    psi0 = psi + fields["psi_bh"]
    m = m_value(cfg, 0.0)
    return (
        1.5 * abs(m)
        + 1.5 * fields["aij2"] * psi0**-7
        + 24.0 * math.pi * cfg.G_Newton * torch.abs(fields["rho_grad"]) * psi0
        + torch.log(psi0)
    )


def grchombo_output_vars(psi, fields, cfg: SolverConfig, constant_K):
    """The 29-component GRChombo evolution state: chi = psi_0^-4,
    conformally flat h_ij = delta_ij, lapse = 1, K constant,
    tilde A_ij = bar A_ij * chi^1.5, phi copied, everything else zero.
    Returns a dict name -> array (missing names are implicitly zero)."""
    psi0 = psi + fields["psi_bh"]
    chi = psi0**-4
    factor = chi**1.5
    ones = torch.ones_like(psi)
    out = {
        "chi": chi,
        "h11": ones, "h22": ones, "h33": ones,
        "lapse": ones,
        "K": torch.full_like(psi, float(constant_K)),
        "phi": fields["phi"],
    }
    names = {(0, 0): "A11", (0, 1): "A12", (0, 2): "A13",
             (1, 1): "A22", (1, 2): "A23", (2, 2): "A33"}
    for comp, name in names.items():
        out[name] = fields["aij"][comp] * factor
    return out


def grchombo_output_stack(psi, fields, cfg: SolverConfig, constant_K):
    """All NUM_GRCHOMBO_VARS components stacked in enum order, zeros for the
    unused evolution variables (Theta, Gamma_i, shift, B, Pi, Ham, Mom)."""
    named = grchombo_output_vars(psi, fields, cfg, constant_K)
    zeros = torch.zeros_like(psi)
    comps = [
        named.get(name, zeros)
        for name in GRCHOMBO_INDEX
    ]
    assert len(comps) == NUM_GRCHOMBO_VARS
    return torch.stack(comps, dim=0)
