"""Dimension-generic (1D/2D/3D) operator functions and their V-cycle.

Port of the JAX package's `ops/lowdim.py`. The reference's ChF kernels are
generated for CH_SPACEDIM in {1,2,3} from one macro source:
GSRBHELMHOLTZVC{1,2,3}D (VariableCoeffPoissonOperatorF.ChF:31-139),
VCCOMPUTEOP{1,2,3}D (:160-237), VCCOMPUTERES{1,2,3}D (:260-339) and
RESTRICTRESVC{1,2,3}D (:356-437); the 3D flavour is the only one the BBH
application links. Every function below is written over `u.ndim` axes, so
the same code is the 1D, 2D and 3D variant: `denom = 2^D` in the
restriction, `diag = alpha*a + 2*D*beta/dx^2` in the relaxation, a
(2*D+1)-point star in the Laplacian. The production 3D solver keeps its own
stack (ops/stencils.py and the CUDA kernels); this module carries the
lower-dimensional operator contract and agrees with that stack at D=3
(tests/test_torch_lowdim.py).

`mg_vcycle` / `mg_solve` are a self-contained geometric-MG solver for the
low-D operator, with AMRMultiGrid's level schedule (pre-smooth, residual,
restrict, recurse, piecewise-constant prolong, post-smooth) and
harmonic/arithmetic coefficient coarsening
(VariableCoeffPoissonOperatorFactory.cpp:205-223). Plain PyTorch, no
kernel: `mg_solve` runs on `device` (None = the CUDA device; raises where
there is none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mg_ic_code_tpu_torch.ops.ghosts import (
    PERIODIC, PHYS_DIRICHLET, PHYS_NEUMANN,
)
from mg_ic_code_tpu_torch.precision import resolve_device

# face kinds per axis: tuple of (lo_kind, hi_kind), length D
Kinds = tuple


def _I(D: int):
    return (slice(1, -1),) * D


def fill_ghosts_homogeneous(u: torch.Tensor, kinds: Kinds) -> torch.Tensor:
    """One-ring homogeneous ghost fill in any D: quadratic Dirichlet
    (ghost = -2*u0 + u1/3), zero-gradient Neumann, periodic wrap — the
    same face rules as the 3D path (ops/ghosts.py; SetBCs.cpp:49-131).
    Corner ghosts are never read by the star stencil."""
    D = u.ndim
    u_gh = F.pad(u, (1, 1) * D)
    for axis in range(D):
        n_ax = u_gh.shape[axis]

        def plane(pos):
            return u_gh.narrow(axis, pos, 1)

        def put(pos, val):
            sl = [slice(None)] * D
            sl[axis] = pos
            u_gh[tuple(sl)] = val.squeeze(axis)

        if kinds[axis][0] == PERIODIC:
            put(0, plane(n_ax - 2).clone())
            put(n_ax - 1, plane(1).clone())
            continue
        for g_pos, p0, p1, kind in (
            (0, 1, 2, kinds[axis][0]),
            (n_ax - 1, n_ax - 2, n_ax - 3, kinds[axis][1]),
        ):
            if kind == PHYS_DIRICHLET:
                ghost = -2.0 * plane(p0) + (1.0 / 3.0) * plane(p1)
            elif kind == PHYS_NEUMANN:
                ghost = plane(p0).clone()
            else:
                raise AssertionError(kind)
            put(g_pos, ghost)
    return u_gh


def laplacian(u_gh: torch.Tensor, dx) -> torch.Tensor:
    """(2*D+1)-point 2nd-order Laplacian: the `lphi` sum of
    VCCOMPUTEOP{1,2,3}D (VariableCoeffPoissonOperatorF.ChF:216-227)."""
    D = u_gh.ndim
    I = _I(D)
    s = -2.0 * D * u_gh[I]
    for ax in range(D):
        up = list(I)
        up[ax] = slice(2, None)
        dn = list(I)
        dn[ax] = slice(0, -2)
        s = s + u_gh[tuple(up)] + u_gh[tuple(dn)]
    return s * (1.0 / (dx * dx))


def apply_op(u_gh, a_coef, alpha, beta, dx):
    """L(u) = alpha*aCoef*u - beta*Laplacian(u) with the reference's
    constant-1 bCoef (VCCOMPUTEOP{1,2,3}D)."""
    D = u_gh.ndim
    return alpha * a_coef * u_gh[_I(D)] - beta * laplacian(u_gh, dx)


def residual(u_gh, rhs, a_coef, alpha, beta, dx):
    """res = rhs - L(u)  (VCCOMPUTERES{1,2,3}D)."""
    return rhs - apply_op(u_gh, a_coef, alpha, beta, dx)


def gsrb_lambda(a_coef, alpha, beta, dx):
    """lambda = 1/(alpha*aCoef + 2*D*beta/dx^2) — resetLambda
    (VariableCoeffPoissonOperator.cpp:220-249)."""
    D = a_coef.ndim
    return 1.0 / (alpha * a_coef + 2.0 * D * beta / (dx * dx))


def color_mask(shape, lo, red_black: int, device=None) -> torch.Tensor:
    """(sum of global indices + colour) parity mask, any D
    (GSRBHELMHOLTZVC{1,2,3}D's CHF_AUTOMULTIDO parity test)."""
    D = len(shape)
    par = sum(lo) + red_black
    for ax in range(D):
        view = [1] * D
        view[ax] = shape[ax]
        par = par + torch.arange(shape[ax], dtype=torch.int32,
                                 device=device).reshape(view)
    return (par % 2) == 0


def gsrb_color(u, rhs, a_coef, lam, alpha, beta, dx, lo, kinds,
               red_black: int):
    """One colour of the red-black sweep, ghosts refilled first (the
    levelGSRB per-colour BC/exchange refresh,
    VariableCoeffPoissonOperator.cpp:290-330)."""
    u_gh = fill_ghosts_homogeneous(u, kinds)
    upd = u - lam * (apply_op(u_gh, a_coef, alpha, beta, dx) - rhs)
    return torch.where(color_mask(u.shape, lo, red_black, u.device), upd, u)


def relax(u, rhs, a_coef, lam, alpha, beta, dx, lo, kinds, nsweeps: int):
    for p in range(2 * nsweeps):
        u = gsrb_color(u, rhs, a_coef, lam, alpha, beta, dx, lo, kinds,
                       p % 2)
    return u


def restrict_full(fine: torch.Tensor) -> torch.Tensor:
    """2^D-cell average onto the coarse grid (RESTRICTRESVC{1,2,3}D's
    denom = D_TERM(2,*2,*2), VariableCoeffPoissonOperatorF.ChF:401-432)."""
    out = fine
    for ax in range(fine.ndim):
        sh = list(out.shape)
        sh[ax] //= 2
        sh.insert(ax + 1, 2)
        out = out.reshape(sh).mean(dim=ax + 1)
    return out


def restrict_harmonic(coef: torch.Tensor) -> torch.Tensor:
    """Harmonic 2^D averaging (CoarseAverage::averageToCoarseHarmonic,
    VariableCoeffPoissonOperatorFactory.cpp:337-351)."""
    return 1.0 / restrict_full(1.0 / coef)


def prolong_inc(u_fine, e_coarse):
    """Piecewise-constant prolongation increment (AMRPoissonOp::
    prolongIncrement)."""
    e = e_coarse
    for ax in range(u_fine.ndim):
        e = torch.repeat_interleave(e, 2, dim=ax)
    return u_fine + e


def _coarsenable(shape) -> bool:
    return all(n % 2 == 0 and n // 2 >= 2 for n in shape)


def mg_vcycle(u, rhs, a_coef, *, alpha, beta, dx, lo, kinds,
              nsmooth: int = 4, average_type: str = "arithmetic"):
    """One geometric-MG V-cycle over the depth chain below a single level,
    any D: pre-smooth, residual, 2^D restrict, recurse while coarsenable
    (MGnewOp's coarsening ladder), bottom relax, prolong, post-smooth."""
    coefs = [a_coef]
    dxs = [dx]
    while _coarsenable(coefs[-1].shape):
        c = (restrict_harmonic if average_type == "harmonic"
             else restrict_full)(coefs[-1])
        coefs.append(c)
        dxs.append(dxs[-1] * 2.0)
    lams = [gsrb_lambda(c, alpha, beta, h) for c, h in zip(coefs, dxs)]

    def cycle(depth, u_d, rhs_d):
        u_d = relax(u_d, rhs_d, coefs[depth], lams[depth], alpha, beta,
                    dxs[depth], lo, kinds, nsmooth)
        if depth + 1 < len(coefs):
            r = residual(fill_ghosts_homogeneous(u_d, kinds), rhs_d,
                         coefs[depth], alpha, beta, dxs[depth])
            rc = restrict_full(r)
            ec = cycle(depth + 1, torch.zeros_like(rc), rc)
            u_d = prolong_inc(u_d, ec)
            u_d = relax(u_d, rhs_d, coefs[depth], lams[depth], alpha, beta,
                        dxs[depth], lo, kinds, nsmooth)
        return u_d

    return cycle(0, u, rhs)


def mg_solve(rhs, a_coef, *, alpha, beta, dx, lo=None, kinds=None,
             tol: float = 1e-10, max_vcycles: int = 50,
             nsmooth: int = 4, average_type: str = "arithmetic",
             device=None):
    """V-cycle iteration to tolerance on ||res||_inf / ||rhs||_inf, on
    `device` (None = the CUDA device). `rhs` and `a_coef` are tensors or
    arrays; they keep their dtype. Returns (u, rel_resnorm_history)."""
    device = resolve_device(device)
    rhs = torch.as_tensor(rhs, device=device)
    a_coef = torch.as_tensor(a_coef, device=device)
    D = rhs.ndim
    lo = lo or (0,) * D
    kinds = kinds or ((PHYS_DIRICHLET, PHYS_DIRICHLET),) * D
    u = torch.zeros_like(rhs)
    r0 = float(rhs.abs().max())
    hist = []
    for _ in range(max_vcycles):
        u = mg_vcycle(u, rhs, a_coef, alpha=alpha, beta=beta, dx=dx, lo=lo,
                      kinds=kinds, nsmooth=nsmooth,
                      average_type=average_type)
        r = residual(fill_ghosts_homogeneous(u, kinds), rhs, a_coef,
                     alpha, beta, dx)
        rn = float(r.abs().max()) / (r0 if r0 > 0 else 1.0)
        hist.append(rn)
        if rn < tol:
            break
    return u, hist
