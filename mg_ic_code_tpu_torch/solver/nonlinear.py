"""Outer nonlinear (Picard) loop: the reference's poissonSolve.

Port of the reference's main program (Main_PoissonSolver.cpp:45-256): per iteration,
optionally set the constant-K integrability condition (periodic BCs),
re-linearise the Hamiltonian constraint around the current psi (aCoef/rhs
from SetLevelData formulas), solve the linear system with MG-preconditioned
BiCGStab, then update psi += dpsi and check the composite norm of dpsi for
convergence/divergence. The whole solve runs under `torch.no_grad()`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mg_ic_code_tpu_torch import precision
from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.ops.ghosts import fill_ghosts
from mg_ic_code_tpu_torch.physics import level_data as ld
from mg_ic_code_tpu_torch.io.logging import pout
from mg_ic_code_tpu_torch.solver import composite as comp
from mg_ic_code_tpu_torch.solver import reductions as red

DIVERGENCE_NORM = 1.0e5  # early-exit threshold (Main_PoissonSolver.cpp:212)
FAILURE_NORM = 1.0e-1  # MayDay threshold (Main_PoissonSolver.cpp:222)


class NonConvergenceError(RuntimeError):
    """Raised when the NL loop ends with ||dpsi|| > 0.1, mirroring the
    reference's MayDay::Error('NL iterations did not converge...')."""


@dataclasses.dataclass
class NLResult:
    psi: list  # regular part of the conformal factor, per level
    dpsi: list
    constant_K: float
    dpsi_norm_history: list[float]
    linear_iters: list[int]
    linear_residuals: list[float]
    converged: bool
    geom: HierarchyGeom = None
    fields: list = None


def ghosted_psi(geom: HierarchyGeom, psi_list, level: int):
    """psi with ghosts: CF-quadratic from the coarser level, physical
    Dirichlet at value 1 + bc_value (psi -> 1 + dpsi_face asymptotically:
    the initial guess is psi=1 and every dpsi carries face value bc_value),
    Neumann/periodic as configured."""
    return fill_ghosts(
        psi_list[level], geom, level,
        coarse_u=psi_list[geom.parent[level]] if level > 0 else None,
        homogeneous_phys=False,
        dirichlet_shift=1.0,
    )


def compute_constant_k(geom: HierarchyGeom, cfg: SolverConfig, fields, psi_list):
    """Integrability condition for periodic BCs: K = -sqrt(|integral|/V)
    with the integrand of SetLevelData.cpp:131-187
    (Main_PoissonSolver.cpp:137-150)."""
    integrand = [
        ld.constant_k_integrand(
            ghosted_psi(geom, psi_list, l), fields[l], cfg, geom.dx[l]
        )
        for l in range(geom.num_levels)
    ]
    integral = red.composite_sum(integrand, geom)
    volume = math.prod(geom.domain_length)
    return -torch.sqrt(torch.abs(integral) / volume)


def prepare_iteration(
    geom: HierarchyGeom, cfg: SolverConfig, fields, psi_list
):
    """Coefficient/rhs setup for one Picard iteration (the set_a_coef /
    set_b_coef / set_rhs + constant-K block of the reference's loop)."""
    constant_K = (
        compute_constant_k(geom, cfg, fields, psi_list)
        if cfg.is_periodic
        else torch.zeros((), dtype=psi_list[0].dtype,
                         device=psi_list[0].device)
    )
    a_list, rhs_list = [], []
    for l in range(geom.num_levels):
        psi_gh = ghosted_psi(geom, psi_list, l)
        a_list.append(ld.set_a_coef(psi_list[l], fields[l], cfg, constant_K))
        rhs_list.append(
            ld.set_rhs(psi_gh, fields[l], cfg, geom.dx[l], constant_K)
        )
    return a_list, rhs_list, constant_K


def finish_iteration(
    geom: HierarchyGeom, psi_list, dpsi_list, average_down: bool = False
):
    """psi += dpsi (set_update_psi0) and the composite L2 norm of dpsi
    (computeNorm, Main_PoissonSolver.cpp:208). With `average_down`, covered
    coarse cells are then replaced by the restriction of the finer level
    (framework extension: keeps the coarse linearisation consistent with
    the fine solution and lowers the Picard plateau)."""
    from mg_ic_code_tpu_torch.ops import stencils as st

    psi = [p + d for p, d in zip(psi_list, dpsi_list)]
    if average_down:
        # children before parents (entries are parent-ordered); psi[p] is
        # a fresh tensor, so the in-place write touches no caller state
        for c in range(geom.num_levels - 1, 0, -1):
            p = geom.parent[c]
            psi[p][geom.child_slices(p, c)] = st.restrict_full(psi[c])
    return psi, red.composite_norm(dpsi_list, geom, p=2)


def nl_iteration(
    spec: comp.AMRSolverSpec, cfg: SolverConfig, fields, psi_list, dpsi_list,
):
    """One Picard iteration: prepare + build_coefs + solve + finish.
    Returns (psi, dpsi, dpsi_norm, K, stats)."""
    # dpsi carries over between NL iterations as the initial guess (the
    # reference allocates dpsi once and never re-zeroes it before solve())
    from mg_ic_code_tpu_torch.utils import profiling

    geom = spec.geom
    with profiling.scope("prepare_iteration"):
        a_list, rhs_list, constant_K = prepare_iteration(
            geom, cfg, fields, psi_list
        )
    with profiling.scope("build_coefs"):
        coefs = comp.build_coefs(spec, a_list)
    with profiling.scope("solve_linear"):
        out = comp.solve_linear(spec, coefs, rhs_list, dpsi_list)
    with profiling.scope("finish_iteration"):
        psi, dpsi_norm = finish_iteration(geom, psi_list, out.x,
                                          cfg.average_down)
    return psi, out.x, dpsi_norm, constant_K, {
        "iters": out.iters,
        "initial_rnorm": out.initial_rnorm,
        "final_rnorm": out.final_rnorm,
        "converged": out.converged,
    }


@torch.no_grad()
def poisson_solve(
    cfg: SolverConfig,
    geom: HierarchyGeom | None = None,
    dtype=precision.OUTER_DTYPE,
    device=None,
    verbose: bool | None = None,
    output_hook=None,
    initial_psi=None,
) -> NLResult:
    """Full nonlinear solve (the reference's poissonSolve,
    Main_PoissonSolver.cpp:45-256). `device` None means the CUDA device
    (raises without one); pass "cpu" to run on the CPU. `output_hook(iter,
    state)` is called before each linear solve — the slot where the
    reference writes its per-iteration HDF5 snapshot. `initial_psi`
    warm-starts from a previous solution."""
    device = precision.resolve_device(device)
    if geom is None:
        from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy

        geom = generate_hierarchy(cfg, device=device)
    if verbose is None:
        verbose = cfg.verbosity >= 2

    fields = [
        ld.problem_fields(geom, cfg, l, dtype, device)
        for l in range(geom.num_levels)
    ]
    state = ld.initial_state(geom, cfg, dtype, device)
    psi, dpsi = state["psi"], state["dpsi"]
    if initial_psi is not None:
        psi = [torch.as_tensor(p, dtype=dtype, device=device)
               for p in initial_psi]

    history: list[float] = []
    lin_iters: list[int] = []
    lin_resid: list[float] = []
    constant_K = 0.0
    spec = comp.make_amr_spec(geom, cfg, device)

    from mg_ic_code_tpu_torch.utils import profiling

    dpsi_norm = 0.0
    for nl_iter in range(cfg.max_nl_iterations):
        if verbose:
            pout(
                f"Main Loop Iteration {nl_iter + 1} out of "
                f"{cfg.max_nl_iterations}"
            )
        if output_hook is not None:
            with profiling.scope("output_solver_data"):
                output_hook(nl_iter, dict(psi=psi, dpsi=dpsi, geom=geom,
                                          fields=fields,
                                          constant_K=constant_K))

        with profiling.scope("nl_iteration", block=True):
            psi, dpsi, dpsi_norm_dev, k_dev, stats = nl_iteration(
                spec, cfg, fields, psi, dpsi
            )
        dpsi_norm = float(dpsi_norm_dev)
        constant_K = float(k_dev)
        history.append(dpsi_norm)
        lin_iters.append(int(stats["iters"]))
        lin_resid.append(float(stats["final_rnorm"]))
        if verbose:
            if cfg.is_periodic:
                pout(f"Constant average K value set to {constant_K}")
            pout(
                f"The norm of dpsi after step {nl_iter + 1} is {dpsi_norm}"
                f"  (linear: {int(stats['iters'])} iters, "
                f"residual {float(stats['final_rnorm']):.3e})"
            )
        if (
            dpsi_norm < cfg.tolerance
            or dpsi_norm > DIVERGENCE_NORM
            or math.isnan(dpsi_norm)
        ):
            break

    if verbose:
        pout(f"The norm of dpsi at the final step was {dpsi_norm}")
    if cfg.verbosity >= 3:  # hierarchical time report (CH_TIMER role)
        pout(profiling.report())
    if dpsi_norm > FAILURE_NORM or math.isnan(dpsi_norm):
        raise NonConvergenceError(
            "NL iterations did not converge - may need a better initial guess"
        )

    return NLResult(
        psi=psi,
        dpsi=dpsi,
        constant_K=constant_K,
        dpsi_norm_history=history,
        linear_iters=lin_iters,
        linear_residuals=lin_resid,
        converged=dpsi_norm < cfg.tolerance,
        geom=geom,
        fields=fields,
    )
