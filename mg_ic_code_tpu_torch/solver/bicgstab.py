"""Preconditioned BiCGStab over lists of level arrays.

Equivalent of Chombo's BiCGStabSolver<Vector<LevelData>> as used by the
reference's main program: max-norm (m_normType = 0) convergence relative to the
initial residual, iteration cap m_imax, small-residual hang guard.

A Python loop around tensor expressions. The recurrence scalars stay 0-d
tensors in the operands' dtype (so an f32 bottom solve rounds exactly where
its traced counterpart does); the host reads ONE flag per iteration — the
loop condition — and the order of the convergence tests is the reference
port's, so iteration counts agree with it.

The operator applies with homogeneous physical BCs (Krylov directions carry
no boundary inhomogeneity); the caller folds inhomogeneous BCs into the
initial residual, as Chombo's solve() does.

A vector is a tensor or a list of leaves, each a tensor or a level cut
over the mesh (parallel/shards.ShardSet, whose arithmetic runs shard by
shard): the recurrence is written in operators, so it runs on both.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mg_ic_code_tpu_torch.parallel.shards import ShardSet, zeros_like


class BiCGStabResult(NamedTuple):
    x: object  # solution: a tensor or a list of tensors
    iters: int
    final_rnorm: torch.Tensor
    initial_rnorm: torch.Tensor
    converged: bool
    breakdown: bool
    hung: bool = False


def _leaves(x):
    return [x] if isinstance(x, (torch.Tensor, ShardSet)) else list(x)


def _map(fn, *xs):
    if isinstance(xs[0], (torch.Tensor, ShardSet)):
        return fn(*xs)
    return [fn(*parts) for parts in zip(*xs)]


def _axpy(a, x, y):
    return _map(lambda xi, yi: a * xi + yi, x, y)


def _scale(a, x):
    return _map(lambda xi: a * xi, x)


def _add(x, y):
    return _map(lambda xi, yi: xi + yi, x, y)


def _sub(x, y):
    return _map(lambda xi, yi: xi - yi, x, y)


def _zeros_like(x):
    return _map(zeros_like, x)


MAX_RESTARTS = 4
STALL_ITERS = 4


def bicgstab(
    apply_fn: Callable,
    rhs,
    x0=None,
    precond_fn: Callable | None = None,
    dot_fn: Callable | None = None,
    norm_fn: Callable | None = None,
    tol: float = 1.0e-10,
    max_iter: int = 100,
    hang: float = 0.0,
) -> BiCGStabResult:
    """Solve A x = rhs with (optionally preconditioned) BiCGStab.

    apply_fn(x): the homogeneous linear operator. precond_fn(r) ~ A^-1 r
    (default identity). dot_fn: inner product (default unweighted sum).
    norm_fn: convergence norm (default max-norm, matching the reference's
    solver.m_normType = 0). Stops when ||r|| <= tol * ||r0|| (or on
    breakdown of the recurrence, reported via `breakdown`).
    """
    if precond_fn is None:
        precond_fn = lambda r: r
    if dot_fn is None:
        dot_fn = lambda u, v: sum(
            torch.sum(ul * vl) for ul, vl in zip(_leaves(u), _leaves(v))
        )
    if norm_fn is None:
        norm_fn = lambda u: torch.max(
            torch.stack([torch.max(torch.abs(l)) for l in _leaves(u)])
        )

    if x0 is None:
        x = _zeros_like(rhs)
        r = rhs
    else:
        x = x0
        r = _sub(rhs, apply_fn(x0))

    r0norm = norm_fn(r)
    sdt, dev = r0norm.dtype, r0norm.device
    eps_abs = torch.tensor(1e-300, dtype=sdt, device=dev)
    one = torch.ones((), dtype=sdt, device=dev)
    zero = torch.zeros((), dtype=sdt, device=dev)
    threshold = torch.maximum(tol * r0norm, eps_abs)

    rhat, p, v = r, _zeros_like(r), _zeros_like(r)
    rho, alpha, omega = one, one, one
    it = 0
    rnorm, best = r0norm, r0norm
    stall, restarts = 0, 0
    breakdown, hung = False, False

    # one host read per iteration: the loop condition
    not_done = bool(rnorm > threshold)
    while it < max_iter and not_done and not breakdown and not hung:
        rho_new = dot_fn(rhat, r)
        rho_om = rho * omega
        beta = torch.where(
            rho_om == 0.0, zero,
            (rho_new / torch.where(rho_om == 0.0, one, rho_om)) * alpha,
        )
        bd = (rho_new == 0.0) | (omega == 0.0)

        p = _axpy(beta, _axpy(-omega, v, p), r)
        phat = precond_fn(p)
        v = apply_fn(phat)
        rv = dot_fn(rhat, v)
        bd = bd | (rv == 0.0)
        # on breakdown the step factors become 0 so the final (exiting)
        # iteration is a NO-OP on x — a 1.0-denominator placeholder would
        # apply a garbage-scaled update that bottom_solve then consumes
        alpha = torch.where(
            rv == 0.0, zero, rho_new / torch.where(rv == 0.0, one, rv)
        )
        srch = _axpy(-alpha, v, r)  # s
        shat = precond_fn(srch)
        t = apply_fn(shat)
        tt = dot_fn(t, t)
        omega = dot_fn(t, srch) / torch.where(tt == 0.0, one, tt)

        x = _add(x, _add(_scale(alpha, phat), _scale(omega, shat)))
        r = _axpy(-omega, t, srch)
        rnorm = norm_fn(r)
        rho = rho_new
        it += 1
        prev_best = best
        best = torch.minimum(best, rnorm)

        flags = torch.stack([
            (rnorm > threshold).to(sdt), bd.to(sdt),
            (rnorm <= (1.0 - hang) * prev_best).to(sdt),
        ]).tolist()
        not_done, breakdown = bool(flags[0]), bool(flags[1])

        if hang > 0.0:
            # Chombo-style hang handling (m_hang, BiCGStabSolver): BiCGStab
            # residual norms are not monotone, so stalling is measured
            # against the BEST norm so far: an iteration that fails to push
            # the best norm down by the factor (1-hang) counts as a stall;
            # after STALL_ITERS consecutive stalls, RESTART the recurrence
            # from the true residual. After MAX_RESTARTS restarts, declare
            # the solve hung.
            improving = bool(flags[2])
            stall = 0 if improving else stall + 1
            if stall >= STALL_ITERS:
                if restarts < MAX_RESTARTS:
                    r = _sub(rhs, apply_fn(x))
                    rhat, p, v = r, _zeros_like(r), _zeros_like(r)
                    rho, alpha, omega = one, one, one
                    rnorm = norm_fn(r)
                    best = torch.minimum(best, rnorm)
                    stall = 0
                    restarts += 1
                    not_done = bool(rnorm > threshold)
                else:
                    hung = True

    return BiCGStabResult(
        x=x,
        iters=it,
        final_rnorm=rnorm,
        initial_rnorm=r0norm,
        converged=bool(rnorm <= threshold),
        breakdown=breakdown,
        hung=hung,
    )
