"""Core stencil operators as plain PyTorch tensor expressions.

Port of the reference's ChF Fortran kernels (VariableCoeffPoissonOperatorF.
ChF): GSRBHELMHOLTZVC3D, VCCOMPUTEOP3D, VCCOMPUTERES3D, RESTRICTRESVC3D,
plus AMRPoissonOp's piecewise-constant prolongIncrement and CoarseAverage's
arithmetic/harmonic coefficient coarsening.

Convention: `u_gh` denotes an array carrying ONE ghost ring (shape n+2 per
axis) whose ghosts have already been filled (physical BC / coarse-fine /
periodic wrap); all other fields are ghost-free interior arrays of shape n.
The spatial axes are the LAST three; leading batch axes pass through (the
dense bottom-operator build applies the operator to a whole identity basis
at once). All functions are dtype-generic. The hand-written CUDA fast path
for the smoother lives in ops/fused_sweeps.py.
"""

from __future__ import annotations

import torch

_I = slice(1, -1)  # interior of a ghosted axis
_E = Ellipsis


def laplacian(u_gh: torch.Tensor, dx) -> torch.Tensor:
    """7-point Laplacian (2nd order), ChF GETLAPLACIANPSIF / the `ldpsi`
    term of VCCOMPUTEOP3D."""
    c = u_gh[_E, _I, _I, _I]
    s = (
        u_gh[_E, 2:, _I, _I]
        + u_gh[_E, :-2, _I, _I]
        + u_gh[_E, _I, 2:, _I]
        + u_gh[_E, _I, :-2, _I]
        + u_gh[_E, _I, _I, 2:]
        + u_gh[_E, _I, _I, :-2]
    )
    return (s - 6.0 * c) * (1.0 / (dx * dx))


def apply_op(u_gh, a_coef, b_coef, alpha, beta, dx):
    """L(u) = alpha*aCoef*u - beta*bCoef*Laplacian(u)  (VCCOMPUTEOP3D).
    `b_coef=None` means the constant-1 bCoef of the reference physics and
    skips a full read of bCoef."""
    lap = laplacian(u_gh, dx)
    if b_coef is not None:
        lap = lap * b_coef
    return alpha * a_coef * u_gh[_E, _I, _I, _I] - beta * lap


def residual(u_gh, rhs, a_coef, b_coef, alpha, beta, dx):
    """res = rhs - L(u)  (VCCOMPUTERES3D)."""
    return rhs - apply_op(u_gh, a_coef, b_coef, alpha, beta, dx)


def gsrb_lambda(a_coef, alpha, beta, dx):
    """Relaxation coefficient lambda = 1/(alpha*aCoef + 2*D*beta/dx^2):
    inverse diagonal of L under the bCoef~1 assumption (resetLambda)."""
    return 1.0 / (alpha * a_coef + 6.0 * beta / (dx * dx))


def color_mask(shape, lo, red_black: int, device=None) -> torch.Tensor:
    """Checkerboard mask of cells with (i+j+k) = red_black (mod 2), where
    i,j,k are GLOBAL level indices (the reference's parity is global because
    Chombo box indices are global)."""
    nx, ny, nz = shape[-3:]
    i = torch.arange(nx, dtype=torch.int32, device=device)[:, None, None]
    j = torch.arange(ny, dtype=torch.int32, device=device)[None, :, None]
    k = torch.arange(nz, dtype=torch.int32, device=device)[None, None, :]
    par = (i + j + k + (sum(lo) + red_black)) % 2
    return par == 0


def gsrb_color(u_gh, rhs, a_coef, b_coef, lam, alpha, beta, dx, lo,
               red_black: int):
    """One colour of a red-black Gauss-Seidel sweep (GSRBHELMHOLTZVC3D): on
    cells of the given colour, u <- u - lambda * (L(u) - rhs). Returns the
    updated INTERIOR (ghost-free) array. Ghosts must be refreshed by the
    caller before the other colour runs."""
    lofu = apply_op(u_gh, a_coef, b_coef, alpha, beta, dx)
    u = u_gh[_E, _I, _I, _I]
    upd = u - lam * (lofu - rhs)
    mask = color_mask(u.shape, lo, red_black, device=u.device)
    return torch.where(mask, upd, u)


def restrict_full(f: torch.Tensor) -> torch.Tensor:
    """Full-weighting 2x coarsening: average of the 2^3 children (the
    `/denom` accumulation of RESTRICTRESVC3D). Eight strided slices summed
    — coalesced reads, no reshape copy."""
    s = None
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                t = f[_E, di::2, dj::2, dk::2]
                s = t if s is None else s + t
    return s * 0.125


def restrict_residual(u_gh, rhs, a_coef, b_coef, alpha, beta, dx):
    """Fused residual + full-weighting restriction: res[2h] = I(rhs - L(u))
    (RESTRICTRESVC3D)."""
    return restrict_full(residual(u_gh, rhs, a_coef, b_coef, alpha, beta, dx))


def upsample2(e_coarse: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant 2x refinement of the last three axes."""
    e = e_coarse
    for ax in (-3, -2, -1):
        e = torch.repeat_interleave(e, 2, dim=ax)
    return e


def prolong_inc(u_fine: torch.Tensor, e_coarse: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant prolongation increment: u_f[i] += e_c[i//2]
    (AMRPoissonOp::prolongIncrement)."""
    return u_fine + upsample2(e_coarse)


def coarsen_coef(c: torch.Tensor, average_type: str) -> torch.Tensor:
    """Coefficient coarsening, arithmetic or harmonic 2^3-cell average
    (CoarseAverage::averageToCoarse / averageToCoarseHarmonic)."""
    if average_type == "arithmetic":
        return restrict_full(c)
    if average_type == "harmonic":
        return 1.0 / restrict_full(1.0 / c)
    raise ValueError(f"bad coefficient_average_type: {average_type}")


def grad_energy(phi_gh: torch.Tensor, dx) -> torch.Tensor:
    """rho_grad = 1/2 * sum_d (d_d phi)^2 with 2nd-order central differences
    (GETRHOGRADPHIF)."""
    inv2dx = 0.5 / dx
    gx = (phi_gh[2:, _I, _I] - phi_gh[:-2, _I, _I]) * inv2dx
    gy = (phi_gh[_I, 2:, _I] - phi_gh[_I, :-2, _I]) * inv2dx
    gz = (phi_gh[_I, _I, 2:] - phi_gh[_I, _I, :-2]) * inv2dx
    return 0.5 * (gx * gx + gy * gy + gz * gz)
