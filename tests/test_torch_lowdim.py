"""ops/lowdim.py of the port against the JAX package's, case for case with
tests/test_lowdim.py: the same numpy inputs, made from a seed, go through
both, f64, to 1e-12 (of max|reference| where the values are not O(1)).
Each case also keeps the JAX test's own check on the port's result (the
3D stack at D=3, the dense 1D solve, the 2D contraction and analytic
error, the restriction denominators, the prolongation shapes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.ops import lowdim as jld

from mg_ic_code_tpu_torch.ops import ghosts as tgh
from mg_ic_code_tpu_torch.ops import lowdim as tld
from mg_ic_code_tpu_torch.ops import stencils as tst

torch.set_num_threads(1)

TOL = 1e-12
D3_KINDS = (("dirichlet", "dirichlet"), ("neumann", "dirichlet"),
            ("periodic", "periodic"))


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=tol * scale)


def test_generic_matches_jax_and_3d_stack():
    """Every generic function at D=3 against the JAX generic function, and
    against the port's own 3D stack (ops/stencils.py + ops/ghosts.py)."""
    rng = _rng(11)
    n = 12
    u, rhs = rng.standard_normal((2, n, n, n))
    a = rng.uniform(0.5, 2.0, (n, n, n))
    dx, alpha, beta, lo = 0.1, 1.0, -1.0, (3, 1, 2)

    ghg = tld.fill_ghosts_homogeneous(_t(u), D3_KINDS)
    close(ghg, jld.fill_ghosts_homogeneous(jnp.asarray(u), D3_KINDS))
    gh3 = tgh.fill_ghosts_homogeneous(_t(u), D3_KINDS, 2.0)
    # corners excluded: star stencils never read them
    close(ghg[1:-1, 1:-1, :], gh3[1:-1, 1:-1, :], 1e-14)

    close(tld.laplacian(gh3, dx), jld.laplacian(jnp.asarray(gh3.numpy()), dx))
    close(tld.laplacian(gh3, dx), tst.laplacian(gh3, dx))
    close(tld.residual(gh3, _t(rhs), _t(a), alpha, beta, dx),
          jld.residual(jnp.asarray(gh3.numpy()), jnp.asarray(rhs),
                       jnp.asarray(a), alpha, beta, dx))
    close(tld.residual(gh3, _t(rhs), _t(a), alpha, beta, dx),
          tst.residual(gh3, _t(rhs), _t(a), None, alpha, beta, dx))
    lam = tld.gsrb_lambda(_t(a), alpha, beta, dx)
    close(lam, jld.gsrb_lambda(jnp.asarray(a), alpha, beta, dx), 1e-14)
    close(lam, tst.gsrb_lambda(_t(a), alpha, beta, dx), 1e-14)
    for color in (0, 1):
        np.testing.assert_array_equal(
            tld.color_mask((n, n + 1, n - 1), lo, color).numpy(),
            np.asarray(jld.color_mask((n, n + 1, n - 1), lo, color)))
        got = tld.gsrb_color(_t(u), _t(rhs), _t(a), lam, alpha, beta, dx,
                             lo, D3_KINDS, color)
        close(got, jld.gsrb_color(jnp.asarray(u), jnp.asarray(rhs),
                                  jnp.asarray(a), jnp.asarray(lam.numpy()),
                                  alpha, beta, dx, lo, D3_KINDS, color))
        close(got, tst.gsrb_color(gh3, _t(rhs), _t(a), None, lam, alpha,
                                  beta, dx, lo, color))
    got = tld.relax(_t(u), _t(rhs), _t(a), lam, alpha, beta, dx, lo,
                    D3_KINDS, 2)
    close(got, jld.relax(jnp.asarray(u), jnp.asarray(rhs), jnp.asarray(a),
                         jnp.asarray(lam.numpy()), alpha, beta, dx, lo,
                         D3_KINDS, 2))
    f = rng.standard_normal((8, 8, 8))
    close(tld.restrict_full(_t(f)), jld.restrict_full(jnp.asarray(f)))
    close(tld.restrict_full(_t(f)), tst.restrict_full(_t(f)), 1e-14)


def _dense_1d(a, alpha, beta, dx):
    """Dense L for D=1 with the quadratic-Dirichlet ghost eliminated
    (tests/test_lowdim.py's)."""
    n = a.shape[0]
    inv = 1.0 / (dx * dx)
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = alpha * a[i] + 2.0 * beta * inv
        if i > 0:
            A[i, i - 1] = -beta * inv
        if i < n - 1:
            A[i, i + 1] = -beta * inv
    A[0, 0] = alpha * a[0] + 4.0 * beta * inv
    A[0, 1] = -(4.0 / 3.0) * beta * inv
    A[-1, -1] = alpha * a[-1] + 4.0 * beta * inv
    A[-1, -2] = -(4.0 / 3.0) * beta * inv
    return A


def test_1d_solve_matches_jax_and_dense():
    """GSRBHELMHOLTZVC1D-parity: the 1D MG solve against the JAX one (the
    same V-cycles, history and solution) and the dense direct solve."""
    rng = _rng(12)
    n = 64
    dx, alpha, beta = 1.0 / n, 1.0, 1.0
    a = rng.uniform(0.5, 2.0, n)
    rhs = rng.standard_normal(n)
    u, hist = tld.mg_solve(_t(rhs), _t(a), alpha=alpha, beta=beta, dx=dx,
                           tol=1e-12, device="cpu")
    ju, jhist = jld.mg_solve(jnp.asarray(rhs), jnp.asarray(a), alpha=alpha,
                             beta=beta, dx=dx, tol=1e-12)
    assert len(hist) == len(jhist) and hist[-1] < 1e-12, (hist, jhist)
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=TOL)
    close(u, ju)
    want = np.linalg.solve(_dense_1d(a, alpha, beta, dx), rhs)
    np.testing.assert_allclose(u.numpy(), want, rtol=1e-9, atol=1e-10)


def test_1d_apply_op_matches_jax_and_dense():
    """apply_op of the ghost-filled 1D field against the JAX one and the
    dense matrix row by row."""
    rng = _rng(13)
    n = 32
    dx = 1.0 / n
    a = rng.uniform(0.5, 2.0, n)
    u = rng.standard_normal(n)
    kinds = (("dirichlet", "dirichlet"),)
    got = tld.apply_op(tld.fill_ghosts_homogeneous(_t(u), kinds), _t(a),
                       1.0, 1.0, dx)
    close(got, jld.apply_op(jld.fill_ghosts_homogeneous(jnp.asarray(u),
                                                        kinds),
                            jnp.asarray(a), 1.0, 1.0, dx))
    np.testing.assert_allclose(got.numpy(),
                               _dense_1d(a, 1.0, 1.0, dx) @ u,
                               rtol=1e-10, atol=1e-9)


def test_2d_vcycle_matches_jax_contraction_and_analytic():
    """GSRBHELMHOLTZVC2D-parity: one 2D V-cycle against the JAX one, then
    the solve of -lap(u) = f with homogeneous Dirichlet faces: the JAX
    history, textbook contraction and the 2nd-order discrete error."""
    n = 64
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    X, Y = np.meshgrid(x, x, indexing="ij")
    u_exact = np.sin(np.pi * X) * np.sin(np.pi * Y)
    f = 2.0 * np.pi**2 * u_exact
    a = np.zeros((n, n))
    kinds = (("dirichlet", "dirichlet"),) * 2
    kw = dict(alpha=0.0, beta=1.0, dx=dx, lo=(0, 0), kinds=kinds)
    one = tld.mg_vcycle(torch.zeros(n, n, dtype=torch.float64), _t(f),
                        _t(a), **kw)
    close(one, jld.mg_vcycle(jnp.zeros((n, n)), jnp.asarray(f),
                             jnp.asarray(a), **kw))
    u, hist = tld.mg_solve(_t(f), _t(a), alpha=0.0, beta=1.0, dx=dx,
                           tol=1e-11, device="cpu")
    ju, jhist = jld.mg_solve(jnp.asarray(f), jnp.asarray(a), alpha=0.0,
                             beta=1.0, dx=dx, tol=1e-11)
    assert len(hist) == len(jhist), (hist, jhist)
    close(u, ju)
    rates = [hist[i + 1] / hist[i] for i in range(min(4, len(hist) - 1))]
    assert max(rates) < 0.2, hist
    assert float(np.max(np.abs(u.numpy() - u_exact))) < 4.0 * dx**2


@pytest.mark.parametrize("average_type", ["arithmetic", "harmonic"])
def test_2d_periodic_and_neumann_faces(average_type):
    """Periodic in x, Neumann/Dirichlet in y with the Helmholtz term: the
    solve against the JAX one, converged below 1e-11."""
    rng = _rng(14)
    n = 32
    kinds = (("periodic", "periodic"), ("neumann", "dirichlet"))
    a = rng.uniform(0.5, 2.0, (n, n))
    rhs = rng.standard_normal((n, n))
    kw = dict(alpha=1.0, beta=1.0, dx=1.0 / n, kinds=kinds, tol=1e-11,
              average_type=average_type)
    u, hist = tld.mg_solve(_t(rhs), _t(a), device="cpu", **kw)
    ju, jhist = jld.mg_solve(jnp.asarray(rhs), jnp.asarray(a), **kw)
    assert len(hist) == len(jhist) and hist[-1] < 1e-11, (hist, jhist)
    close(u, ju)
    r = tld.residual(tld.fill_ghosts_homogeneous(u, kinds), _t(rhs), _t(a),
                     1.0, 1.0, 1.0 / n)
    assert float(r.abs().max()) < 1e-11 * float(np.abs(rhs).max())


def test_restriction_denominators():
    """denom = 2^D: averaging a constant is exact in every D, harmonic ==
    arithmetic on constants, harmonic < arithmetic otherwise (AM-HM); both
    against the JAX functions on random data."""
    rng = _rng(15)
    for D in (1, 2, 3):
        c = torch.full((8,) * D, 3.5, dtype=torch.float64)
        np.testing.assert_allclose(tld.restrict_full(c).numpy(), 3.5)
        np.testing.assert_allclose(tld.restrict_harmonic(c).numpy(), 3.5)
        v = rng.uniform(0.5, 2.0, (8,) * D)
        close(tld.restrict_full(_t(v)), jld.restrict_full(jnp.asarray(v)))
        close(tld.restrict_harmonic(_t(v)),
              jld.restrict_harmonic(jnp.asarray(v)))
    v = _t(rng.uniform(0.5, 2.0, (8, 8)))
    assert float((tld.restrict_harmonic(v) - tld.restrict_full(v)).max()) < 0


def test_prolong_shapes():
    """Piecewise-constant: each coarse value appears 2^D times, the JAX
    function's result in every D."""
    rng = _rng(16)
    for D in (1, 2, 3):
        e = rng.standard_normal((4,) * D)
        u = rng.standard_normal((8,) * D)
        out = tld.prolong_inc(_t(u), _t(e))
        assert out.shape == u.shape
        close(out, jld.prolong_inc(jnp.asarray(u), jnp.asarray(e)))
        close(tld.restrict_full(out - _t(u)), e, 1e-14)


def test_mg_solve_needs_a_device_or_names_one():
    """mg_solve runs on the card unless told otherwise: without one, the
    default raises; device='cpu' runs there."""
    rhs = torch.ones(8, dtype=torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tld.mg_solve(rhs, torch.ones(8, dtype=torch.float64), alpha=1.0,
                         beta=1.0, dx=0.125)
    u, _ = tld.mg_solve(rhs.numpy(), np.ones(8), alpha=1.0, beta=1.0,
                        dx=0.125, device="cpu", max_vcycles=2)
    assert u.device == torch.device("cpu") and u.dtype == torch.float64
