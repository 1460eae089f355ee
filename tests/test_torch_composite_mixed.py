"""The f32 preconditioner of the PyTorch port on the kernel path against
the JAX package's (its resident and tower Pallas kernels in interpret
mode), on a two-level hierarchy; and the mixed-precision linear solve.
Set-up and helpers are those of test_torch_composite.py."""

import numpy as np
import torch

from mg_ic_code_tpu.solver import composite as jcomp

from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import composite as tcomp

from test_torch_composite import J, T, close_lists, mixed  # noqa: F401

torch.set_num_threads(1)


def test_precond_kernel_path(mixed):
    """f32 preconditioner on the kernel path (two AMR V-cycles and the
    composite residual between them): JAX runs its resident and tower
    Pallas kernels in interpret mode, the port their plain counterparts.
    f64 in, f32 inside, f64 out. 2e-5 of max|e|: f32 rounding through ~100
    colour passes, two levels and two V-cycles."""
    jspec, tspec, jco, tco, a, rhs, u = mixed
    ref = jcomp.precond_jit(jspec, jco, J(rhs))
    kernel_counts.reset()
    out = tcomp.precond(tspec, tco, T(rhs))
    assert out[0].dtype == torch.float64
    close_lists(out, ref, 2e-5)
    c = kernel_counts.PLAIN_CALLS
    assert c["tower_down"] == c["tower_up"] == 2
    assert c["residual"] >= 4 and c["gsrb_relax"] >= 8
    assert kernel_counts.LAUNCHES == {k: 0 for k in kernel_counts.KERNELS}


def test_solve_linear_mixed_precision(mixed):
    jspec, tspec, jco, tco, a, rhs, u = mixed
    ref = jcomp.solve_linear_jit(jspec, jco, J(rhs), J([0 * x for x in u]))
    out = tcomp.solve_linear(tspec, tco, T(rhs))
    assert out.converged and bool(ref.converged)
    # an f32 preconditioner perturbs the Krylov path at 1e-6, so the count
    # may differ by one and the two runs stop at different points of the
    # same tolerance: |r| <= 1e-10 * |r0| with |r0| ~ 1e3 (the boundary
    # value over dx^2) pins x to ~1e-8 absolute, i.e. 1e-6 of max|x|
    assert abs(out.iters - int(ref.iters)) <= 1
    close_lists(out.x, ref.x, 1e-6)
