"""Reference-independent physics diagnostics for the solved initial data.

The reference's only correctness oracle is its own convergence monitor
(Main_PoissonSolver.cpp:208-225). This module provides *a-posteriori*
checks that the solved conformal factor actually satisfies the physics,
written independently of the solver path:

  * hamiltonian_residual — the nonlinear Hamiltonian constraint
    (the set_rhs formula, reference SetLevelData.cpp:73-127) evaluated at
    the converged psi with an INDEPENDENT 4th-order Laplacian and the
    ANALYTIC gradient energy, on interior cells only. At the discrete
    solution this is O(dx^2) — a sign/consistency error in the solve
    leaves it O(1).
  * momentum_constraint_divergence — Bowen-York bar A_ij is transverse
    analytically (d_j A_ij = 0, Alcubierre eq. 3.4.20-22); its central-
    difference divergence on the grid must vanish at O(dx^2). This is a
    true oracle for the Aij construction (SetBinaryBH.H:24-83): any sign
    slip in the momentum or spin terms breaks transversality.
  * adm_mass_surface / adm_mass_volume — the ADM mass of the solved data
    from (a) the flux of psi through a coordinate-box surface and (b) the
    Gauss-theorem volume form re-derived from the constraint. The two agree
    only if the solved field satisfies the PDE with the correct signs; for
    P = J = 0 both must equal 2*(m1+m2) (the reference's psi_bh carries the
    m/r convention, SetBinaryBH.H:85-99, so the 1/r coefficient M/2 = m).

All functions are plain PyTorch over the dense level arrays; the
coordinates are made on the device and in the dtype of the `psi` they are
given (`momentum_constraint_divergence` takes no array and so takes
`dtype` and `device`; None means the CUDA device, as everywhere in the
package).
"""

from __future__ import annotations

import math

import torch

from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.physics import bowen_york as by
from mg_ic_code_tpu_torch.physics.level_data import m_value
from mg_ic_code_tpu_torch.physics.scalar_field import phi_profile
from mg_ic_code_tpu_torch.precision import resolve_device

_I2 = slice(2, -2)


def _coords(geom, level: int, dtype, device, grow: int = 0):
    return [torch.as_tensor(c, dtype=dtype, device=device)
            for c in geom.coords(level, grow=grow)]


def laplacian4(u, dx):
    """4th-order 13-point Laplacian on the [2:-2] interior of a ghost-free
    array (coefficients -1/12, 4/3, -5/2 per axis). Independent of the
    solver's 7-point stencil (ops/stencils.laplacian)."""
    inv = 1.0 / (12.0 * dx * dx)
    n = u.shape
    out = None
    for axis in range(3):
        acc = -30.0 * u[_I2, _I2, _I2]
        for off, w in ((-2, -1.0), (-1, 16.0), (1, 16.0), (2, -1.0)):
            sl = tuple(
                slice(2 + off, n[d] - 2 + off) if d == axis else _I2
                for d in range(3)
            )
            acc = acc + w * u[sl]
        out = acc if out is None else out + acc
    return out * inv


def rho_grad_exact(x, y, z, cfg: SolverConfig):
    """Analytic gradient energy 1/2 |grad phi|^2 for the configured profile
    (closed form; no finite differences anywhere)."""
    phi = phi_profile(x, y, z, cfg)
    if cfg.phi_profile == "sine":
        Lx, Ly, Lz = cfg.domain_length
        w = cfg.phi_wavelength
        two_pi = 2.0 * math.pi
        gx = cfg.phi_amplitude * (two_pi * w / Lx) * torch.cos(two_pi * x * w / Lx)
        gy = cfg.phi_amplitude * (two_pi * w / Ly) * torch.cos(two_pi * y * w / Ly)
        gz = cfg.phi_amplitude * (two_pi * w / Lz) * torch.cos(two_pi * z * w / Lz)
        return 0.5 * (gx * gx + gy * gy + gz * gz)
    # gaussian: grad phi = phi * (-2 r_vec / lambda)
    r2 = x * x + y * y + z * z
    return 2.0 * phi * phi * r2 / (cfg.phi_wavelength**2)


def hamiltonian_residual(
    geom, cfg: SolverConfig, psi, level: int, constant_K: float = 0.0
):
    """Nonlinear Hamiltonian constraint residual at `psi` (that level's
    REGULAR conformal factor array), evaluated on the [2:-2] interior with
    the 4th-order Laplacian and analytic sources:

        H = 1/8 m psi_0^5 - 1/8 A^2 psi_0^-7 - 2 pi G rho_grad psi_0
            - Lap(psi)

    (SetLevelData.cpp:105-124 is the spec; everything here is recomputed
    from coordinates, not taken from the solver's cached fields). Returns
    the residual array on the clipped interior; its norm at a converged
    solution is O(dx^2)."""
    x, y, z = _coords(geom, level, psi.dtype, psi.device)
    xc, yc, zc = x[_I2, :, :], y[:, _I2, :], z[:, :, _I2]
    psi_bh = by.psi_bh(xc, yc, zc, cfg)
    aij = by.binary_bh_aij(xc, yc, zc, cfg)
    a2 = by.aij_squared(aij)
    rho = rho_grad_exact(xc, yc, zc, cfg)
    psi0 = psi[_I2, _I2, _I2] + psi_bh
    m = m_value(cfg, constant_K)
    return (
        0.125 * m * psi0**5
        - 0.125 * a2 * psi0**-7
        - 2.0 * math.pi * cfg.G_Newton * rho * psi0
        - laplacian4(psi, geom.dx[level])
    )


def momentum_constraint_divergence(
    geom, cfg: SolverConfig, level: int, dtype=torch.float64, device=None
):
    """(div A, |A|) on the [1:-1] interior: d_j bar A_ij by 2nd-order
    central differences for each i, plus the pointwise Frobenius magnitude
    for relative scaling. Bowen-York data is transverse-traceless
    analytically, so div A must shrink at O(dx^2) wherever A is smooth."""
    device = resolve_device(device)
    x, y, z = _coords(geom, level, dtype, device, grow=1)
    aij = by.binary_bh_aij(x, y, z, cfg)
    shape = tuple(s + 2 for s in geom.shape(level))
    full = {k: torch.broadcast_to(v, shape) for k, v in aij.items()}

    def comp(i, j):
        return full[(i, j)] if (i, j) in full else full[(j, i)]

    inv2dx = 0.5 / geom.dx[level]
    _i = slice(1, -1)
    divs = []
    for i in range(3):
        acc = 0.0
        for j in range(3):
            a = comp(i, j)
            hi = tuple(slice(2, None) if d == j else _i for d in range(3))
            lo = tuple(slice(0, -2) if d == j else _i for d in range(3))
            acc = acc + (a[hi] - a[lo]) * inv2dx
        divs.append(acc)
    div = torch.sqrt(sum(d * d for d in divs))
    mag = torch.sqrt(
        sum((2.0 if i != j else 1.0) * comp(i, j)[_i, _i, _i] ** 2
            for (i, j) in by.SYM_COMPS)
    )
    return div, mag


def adm_mass_surface(
    geom, cfg: SolverConfig, psi, level: int = 0, margin: int = 2
):
    """ADM mass from the flux integral M = -(1/2pi) closed-surface-integral
    of grad(psi_0) . n over the coordinate box `margin` cells inside each
    face, by central differences of the full psi_0 = psi + psi_bh. In the
    conformally flat ADM expansion psi_0 -> 1 + M/(2 r) this picks up M up
    to O(1/R) finite-box and O(dx^2) stencil corrections."""
    x, y, z = _coords(geom, level, psi.dtype, psi.device)
    psi0 = psi + by.psi_bh(x, y, z, cfg)
    dx = geom.dx[level]
    n = psi0.shape
    total = 0.0
    # face-centred differences over the boundary FACES of the cell cube
    # [margin, n-margin)^3: a closed discrete surface whose flux sum is the
    # exact discrete-Gauss dual of summing the 7-point Laplacian over the
    # cube (so surface-vs-volume agreement tests the PDE, not the surface
    # quadrature), and an O(dx^2) quadrature of the continuum flux.
    for axis in range(3):
        tang = [slice(margin, n[d] - margin) for d in range(3)]
        lo_in, lo_out = list(tang), list(tang)
        lo_in[axis], lo_out[axis] = margin, margin - 1
        g_lo = (psi0[tuple(lo_in)] - psi0[tuple(lo_out)]) * (1.0 / dx)
        hi_in, hi_out = list(tang), list(tang)
        hi_in[axis], hi_out[axis] = n[axis] - margin - 1, n[axis] - margin
        g_hi = (psi0[tuple(hi_out)] - psi0[tuple(hi_in)]) * (1.0 / dx)
        total = total + torch.sum(g_hi) - torch.sum(g_lo)
    return -total * dx * dx / (2.0 * math.pi)


def adm_mass_volume(
    geom, cfg: SolverConfig, psi, level: int = 0, margin: int = 2,
    constant_K: float = 0.0,
):
    """ADM mass via Gauss's theorem applied to the constraint: over the box
    B (the same sub-box adm_mass_surface integrates around),

        -(1/2pi) surface_int grad psi_0 . n
          = -(1/2pi) vol_int Lap(psi_0)
          = 2*(m1+m2)                                   [Lap(m/r) delta term]
            + (1/2pi) vol_int [ 1/8 A^2 psi_0^-7
                                + 2 pi G rho_grad psi_0
                                - 1/8 m psi_0^5 ] dV    [the constraint]

    written here directly from the constraint equation (Alcubierre
    eq. 3.2.4 with the reference's m/r puncture convention) — NOT by
    calling the solver's set_rhs. Agreement with adm_mass_surface therefore
    certifies that the solved psi satisfies the PDE with the correct signs.
    Punctures must lie inside the margin sub-box."""
    x, y, z = _coords(geom, level, psi.dtype, psi.device)
    shape = geom.shape(level)
    sub = tuple(slice(margin, s - margin) for s in shape)
    psi_bh = by.psi_bh(x, y, z, cfg)
    psi0 = (psi + psi_bh)[sub]
    xc = torch.broadcast_to(x, shape)[sub]
    yc = torch.broadcast_to(y, shape)[sub]
    zc = torch.broadcast_to(z, shape)[sub]
    a2 = by.aij_squared(by.binary_bh_aij(xc, yc, zc, cfg))
    rho = rho_grad_exact(xc, yc, zc, cfg)
    m = m_value(cfg, constant_K)
    integrand = (
        0.125 * a2 * psi0**-7
        + 2.0 * math.pi * cfg.G_Newton * rho * psi0
        - 0.125 * m * psi0**5
    )
    dx = geom.dx[level]
    bulk = torch.sum(integrand) * dx**3 / (2.0 * math.pi)
    return 2.0 * (cfg.bh1_bare_mass + cfg.bh2_bare_mass) + bulk
