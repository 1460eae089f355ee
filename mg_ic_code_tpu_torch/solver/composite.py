"""Composite (multi-level AMR) operator, V-cycle preconditioner and linear
solve.

Port of Chombo's MultilevelLinearOp + AMRMultiGrid as driven by the
reference (Main_PoissonSolver.cpp:103-184):

  * composite_apply/residual — the AMR hierarchy as ONE linear operator on
    the list of per-level arrays: each level applies L with quadratic
    coarse-fine ghosts interpolated from the same vector's coarser component
    (QuadCFInterp coupling) and physical BCs; no reflux, matching the
    reference's disabled reflux.
  * amr_vcycle — correction-scheme V-cycle across AMR levels (homogeneous CF
    ghosts during smoothing), with the full MG depth chain + bottom solve
    below the base level.
  * precond — m_num_mg_iterations AMR V-cycles (MultilevelLinearOp::preCond).
  * solve_linear — BiCGStab over the composite vector with volume-weighted
    dots and max-norm convergence (solver.m_normType = 0).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mg_ic_code_tpu_torch import precision
from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.ops.ghosts import fill_ghosts
from mg_ic_code_tpu_torch.solver import multigrid as mg
from mg_ic_code_tpu_torch.solver import reductions as red
from mg_ic_code_tpu_torch.solver.bicgstab import BiCGStabResult, bicgstab


@dataclasses.dataclass(frozen=True)
class AMRSolverSpec:
    """Static description of the composite solver (hashable)."""

    geom: HierarchyGeom
    alpha: float
    beta: float
    nsmooth: int
    num_mg_iterations: int
    avg_type: str
    level_specs: tuple[mg.LevelMGSpec, ...]
    tol: float = 1.0e-10
    max_iter: int = 100
    # stop when an iteration shrinks the residual by less than this factor
    # (Chombo BiCGStabSolver m_hang default 1e-8; params.txt `hang` key)
    hang: float = 1.0e-8
    # preCondSolverDepth (MultilevelLinearOp): when >= 0 the preconditioner
    # is itself an inner BiCGStab solve (loosely converged), preconditioned
    # by the AMR V-cycles — the reference's commented-out deep-precondition
    # mode. -1 = plain V-cycle preconditioning.
    pre_cond_solver_depth: int = -1
    # run the MG preconditioner in reduced precision ("float32") while the
    # outer Krylov stays f64 — the mixed-precision mode (the preconditioner
    # only needs smoother-grade accuracy, and the f32 kernels are the
    # production path). None = same precision as the operands.
    precond_dtype: str | None = None

    @property
    def num_levels(self) -> int:
        return self.geom.num_levels


def make_amr_spec(
    geom: HierarchyGeom, cfg: SolverConfig, device=None
) -> AMRSolverSpec:
    """`device` (None = cuda) is where the solve will run: it resolves
    `precond_precision = auto` (precision.precond_dtype)."""
    device = precision.resolve_device(device)
    if cfg.smoother_precision == "bfloat16":
        raise NotImplementedError(
            "smoother_precision = bfloat16: the CUDA kernels sweep at "
            "operand precision; reduced-precision colour passes are not "
            "ported (use auto or single)"
        )
    level_specs = tuple(
        mg.make_level_spec(
            geom, l, cfg.alpha, cfg.beta, cfg.num_mg_smooth,
            cfg.coefficient_average_type,
            # depth chains below the base level only (ref ratio 2 puts all
            # intermediate MG depths under AMR level 0)
            with_depths=(l == 0),
            smoother=cfg.smoother,
            num_mg=cfg.num_mg,
            bottom=cfg.bottom_solver,
        )
        for l in range(geom.num_levels)
    )
    return AMRSolverSpec(
        geom=geom,
        alpha=cfg.alpha,
        beta=cfg.beta,
        nsmooth=cfg.num_mg_smooth,
        num_mg_iterations=cfg.num_mg_iterations,
        avg_type=cfg.coefficient_average_type,
        level_specs=level_specs,
        tol=cfg.tolerance,
        max_iter=cfg.max_iterations,
        hang=cfg.hang,
        pre_cond_solver_depth=cfg.pre_cond_solver_depth,
        precond_dtype=precision.precond_dtype(cfg.precond_precision, device),
    )


def build_coefs(spec: AMRSolverSpec, a_list, b_list=None) -> tuple[dict, ...]:
    """Per-level coefficient structures (with depth chains under level 0).

    With mixed-precision preconditioning, each level also carries an "lp"
    sub-dict holding float32 casts of the whole depth chain."""
    out = []
    lp_dtype = (
        precision.PRECOND_DTYPE if spec.precond_dtype == "float32" else None
    )
    for l in range(spec.num_levels):
        b0 = None if b_list is None else b_list[l]
        c = mg.build_level_coefs(spec.level_specs[l], a_list[l], b0)
        if lp_dtype is not None:
            cast = lambda t: tuple(
                None if x is None else x.to(lp_dtype) for x in t
            )
            c = dict(c)
            c["lp"] = {k: cast(c[k]) for k in ("a", "b", "lam")}
            if c.get("binv") is not None:
                # the dense bottom inverse must ride along or the f32
                # preconditioner silently falls back to the launch-bound
                # BiCGStab bottom tower
                c["lp"]["binv"] = c["binv"].to(lp_dtype)
        out.append(c)
    return tuple(out)


def _lp(coefs_l: dict, use_lp: bool) -> dict:
    return coefs_l["lp"] if use_lp and "lp" in coefs_l else coefs_l


# --------------------------------------------------------------- operator


def composite_apply(
    spec: AMRSolverSpec, coefs, u_list, homogeneous_phys: bool = True,
    use_lp: bool = False,
):
    """A(u) on the composite vector. CF ghosts always couple to the coarser
    component of u itself (that coupling is part of the linear operator);
    the `homogeneous_phys` flag only zeroes physical BC values. `use_lp`
    selects the low-precision coefficient set (the preconditioner's inner
    residuals).

    The homogeneous form — every Krylov application — exploits that the
    operator is LINEAR in the CF ghost: A(u) = L_homog(u_l) minus the
    coarse-ghost face term (cf_interp.add_cf_coarse_term), so each level
    pays the cheap homogeneous one-ring fill instead of the full
    inhomogeneous QuadCFInterp assembly. The split is exact up to FLOP
    reassociation: the ghost value decomposes as
    (w0·u0 + w1·u1) + W_COARSE·plane and only face-adjacent ghosts reach
    the 7-point stencil."""
    from mg_ic_code_tpu_torch.ops import cf_interp as _cfi

    geom = spec.geom
    out = []
    for l in range(spec.num_levels):
        c = _lp(coefs[l], use_lp)
        if homogeneous_phys:
            au = mg.apply_homog(spec.level_specs[l], c, 0, u_list[l])
            if l > 0:
                au = _cfi.add_cf_coarse_term(
                    au, geom, l, u_list[geom.parent[l]],
                    -spec.beta / geom.dx[l] ** 2, c["b"][0],
                )
            out.append(au)
        else:
            # inhomogeneous physical BCs (the initial residual only): the
            # full QuadCFInterp + BC-value ghost assembly
            u_gh = fill_ghosts(
                u_list[l], geom, l,
                coarse_u=u_list[geom.parent[l]] if l > 0 else None,
                homogeneous_phys=False,
            )
            out.append(
                st.apply_op(
                    u_gh, c["a"][0], c["b"][0], spec.alpha, spec.beta,
                    geom.dx[l],
                )
            )
    return out


def composite_residual(
    spec: AMRSolverSpec, coefs, u_list, rhs_list, homogeneous_phys: bool = True
):
    au = composite_apply(spec, coefs, u_list, homogeneous_phys)
    return [r - a for r, a in zip(rhs_list, au)]


# ----------------------------------------------------------------- V-cycle


def amr_vcycle(spec: AMRSolverSpec, coefs, r_list, use_lp: bool = False):
    """One AMR V-cycle on the correction equation A e = r, from zero initial
    correction. Downsweep smooths each level with homogeneous CF ghosts and
    replaces the covered part of the next-coarser residual with the
    restricted fine residual; the base level runs the full MG depth chain;
    upsweep prolongs (piecewise-constant) and post-smooths. Entries run
    one after another (sibling patches write DISJOINT covered regions, so
    within-depth order is free)."""
    geom = spec.geom
    nl = spec.num_levels
    r = list(r_list)
    e: list = [None] * nl

    # downsweep: depths descending — every child restricts into its parent
    # before the parent's depth runs
    for depth in range(geom.max_depth, 0, -1):
        for l in geom.entries_at_depth(depth):
            ls = spec.level_specs[l]
            cl = _lp(coefs[l], use_lp)
            el = torch.zeros_like(r[l])
            el = mg.relax(ls, cl, 0, el, r[l], spec.nsmooth)
            res_l = mg.residual_homog(ls, cl, 0, el, r[l])
            rc = st.restrict_full(res_l)
            p = geom.parent[l]
            rp = r[p].clone()
            rp[geom.child_slices(p, l)] = rc
            r[p] = rp
            e[l] = el

    e[0] = mg.mg_vcycle(
        spec.level_specs[0], _lp(coefs[0], use_lp), torch.zeros_like(r[0]),
        r[0],
    )

    # upsweep: depths ascending — every parent's correction is complete
    # before its children prolong from it
    for depth in range(1, geom.max_depth + 1):
        for l in geom.entries_at_depth(depth):
            ls = spec.level_specs[l]
            p = geom.parent[l]
            ec = e[p][geom.child_slices(p, l)]
            e[l] = st.prolong_inc(e[l], ec)
            # post-smooth with CF ghosts interpolated from the coarse
            # correction (homogeneous ghosts here amplify the CF mismatch
            # by 1/dx^2 per level — see mg.relax_cf)
            e[l] = mg.relax_cf(
                ls, _lp(coefs[l], use_lp), e[l], r[l], spec.nsmooth,
                geom, l, e[p],
            )
    return e


def precond(spec: AMRSolverSpec, coefs, r_list):
    """MultilevelLinearOp::preCond — m_num_mg_iterations AMR-MG iterations,
    each a composite-residual evaluation plus a V-cycle.

    With precond_dtype set, the whole preconditioner runs in reduced
    precision (cast in, cast out); the outer Krylov arithmetic stays in the
    operand dtype. With pre_cond_solver_depth >= 0 the V-cycle chain wraps
    into an inner loosely-converged BiCGStab (deep-precondition mode)."""
    if spec.pre_cond_solver_depth >= 0:
        inner = bicgstab(
            functools.partial(composite_apply, spec, coefs),
            r_list,
            precond_fn=functools.partial(_vcycle_precond, spec, coefs),
            dot_fn=functools.partial(red.composite_dot, geom=spec.geom),
            norm_fn=functools.partial(
                red.composite_max_norm, geom=spec.geom
            ),
            tol=1.0e-4,
            max_iter=8 + 4 * spec.pre_cond_solver_depth,
        )
        return inner.x
    return _vcycle_precond(spec, coefs, r_list)


def _vcycle_precond(spec: AMRSolverSpec, coefs, r_list):
    """The plain m_num_mg_iterations-V-cycle preconditioner body."""
    out_dtype = r_list[0].dtype
    use_lp = (
        spec.precond_dtype == "float32" and out_dtype == torch.float64
    )
    if use_lp:
        r_list = [r.to(precision.PRECOND_DTYPE) for r in r_list]
    e = [torch.zeros_like(r) for r in r_list]
    for it in range(spec.num_mg_iterations):
        res = (
            r_list
            if it == 0
            else _composite_residual_coefs(
                spec, coefs, e, r_list, use_lp
            )
        )
        de = amr_vcycle(spec, coefs, res, use_lp)
        e = [a + b for a, b in zip(e, de)]
    if use_lp:
        e = [x.to(out_dtype) for x in e]
    return e


def _composite_residual_coefs(spec, coefs, u_list, rhs_list, use_lp):
    """Composite residual with the (possibly low-precision) coefficient
    set, for the inner precond iterations.

    Routed through the LEVEL residual (mg.residual_homog) rather than
    rhs - composite_apply: on the f32 mixed-precision path the level
    residual dispatches the residual kernel, while the staged form
    (st.residual) is literally rhs - apply_op so the f64 path is unchanged.
    The CF coarse-ghost face term — part of the composite operator
    (composite_apply adds it with scale -beta/dx^2) — is removed afterwards
    with the negated scale: res = (r - L_homog(u)) - T. The reassociation
    shifts CF-face cells at roundoff only, which the outer f64 Krylov
    absorbs."""
    from mg_ic_code_tpu_torch.ops import cf_interp as _cfi

    geom = spec.geom
    out = []
    for l in range(spec.num_levels):
        c = _lp(coefs[l], use_lp)
        res = mg.residual_homog(
            spec.level_specs[l], c, 0, u_list[l], rhs_list[l]
        )
        if l > 0:
            res = _cfi.add_cf_coarse_term(
                res, geom, l, u_list[geom.parent[l]],
                spec.beta / geom.dx[l] ** 2, c["b"][0],
            )
        out.append(res)
    return out


# ------------------------------------------------------------------ solve


def solve_linear(
    spec: AMRSolverSpec,
    coefs,
    rhs_list,
    x0_list=None,
    tol: float | None = None,
    max_iter: int | None = None,
) -> BiCGStabResult:
    """BiCGStab on the composite system, preconditioned by AMR multigrid.

    Inhomogeneous physical BCs are folded into the initial residual (the
    Krylov iteration itself runs with homogeneous BCs), as Chombo's
    solver.define(..., homogeneousBC=false) + solve() arrangement does.
    """
    geom = spec.geom
    if x0_list is None:
        x0_list = [torch.zeros_like(r) for r in rhs_list]

    r0 = composite_residual(spec, coefs, x0_list, rhs_list, False)

    result = bicgstab(
        functools.partial(composite_apply, spec, coefs),
        r0,
        precond_fn=functools.partial(precond, spec, coefs),
        dot_fn=functools.partial(red.composite_dot, geom=geom),
        norm_fn=functools.partial(red.composite_max_norm, geom=geom),
        tol=spec.tol if tol is None else tol,
        max_iter=spec.max_iter if max_iter is None else max_iter,
        hang=spec.hang,
    )
    x = [a + b for a, b in zip(x0_list, result.x)]
    return result._replace(x=x)
