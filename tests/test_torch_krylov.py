"""solver/reductions and solver/bicgstab of the PyTorch port against the
JAX package: composite reductions to 1e-13 relative (summation order), and
BiCGStab iteration counts / flags equal on the same systems — the Python
loop must stop exactly where the traced while_loop does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC, HierarchyGeom as JGeom
from mg_ic_code_tpu.solver import bicgstab as jbi
from mg_ic_code_tpu.solver import reductions as jred

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.solver import bicgstab as tbi
from mg_ic_code_tpu_torch.solver import reductions as tred

torch.set_num_threads(1)


def forest():
    """Base + two sibling patches + a grandchild: multi-child masking."""
    dom0 = Box.from_shape((16, 16, 16))
    c1 = Box((1, 2, 2), (5, 7, 7)).refine(2)
    c2 = Box((9, 2, 2), (14, 7, 7)).refine(2)
    g1 = Box((4, 6, 6), (9, 11, 11)).refine(2)
    jg = JGeom(
        boxes=(dom0, c1, c2, g1),
        domain_boxes=(dom0, dom0.refine(2), dom0.refine(2), dom0.refine(4)),
        dx=(1.0, 0.5, 0.5, 0.25), domain_length=(16.0,) * 3, bc=JBC(),
        parent=(-1, 0, 0, 1),
    )
    plain = lambda bs: [(b.lo, b.hi) for b in bs]
    tg = cv.geom_from_plain(
        plain(jg.boxes), jg.parent, jg.dx,
        dict(bc_lo=(0, 0, 0), bc_hi=(0, 0, 0), bc_value=0.0, periodic=False),
        plain(jg.domain_boxes), jg.domain_length)
    return jg, tg


@pytest.fixture(scope="module")
def vecs():
    jg, tg = forest()
    rng = np.random.default_rng(2)
    u = [rng.standard_normal(b.shape) for b in jg.boxes]
    v = [rng.standard_normal(b.shape) for b in jg.boxes]
    return jg, tg, u, v


def rel(t, j):
    assert float(t) == pytest.approx(float(j), rel=1e-13)


def test_composite_reductions(vecs):
    jg, tg, u, v = vecs
    ju, jv = [jnp.asarray(x) for x in u], [jnp.asarray(x) for x in v]
    tu = cv.level_list_from_numpy(u, "cpu")
    tv = cv.level_list_from_numpy(v, "cpu")
    rel(tred.composite_max_norm(tu, tg), jred.composite_max_norm(ju, jg))
    rel(tred.composite_norm(tu, tg, 0), jred.composite_norm(ju, jg, 0))
    rel(tred.composite_norm(tu, tg, 1), jred.composite_norm(ju, jg, 1))
    rel(tred.composite_norm(tu, tg, 2), jred.composite_norm(ju, jg, 2))
    rel(tred.composite_sum(tu, tg), jred.composite_sum(ju, jg))
    rel(tred.composite_dot(tu, tv, tg), jred.composite_dot(ju, jv, jg))
    assert tred.composite_dot(tu, tv, tg).dtype == torch.float64


def test_mask_covered(vecs):
    jg, tg, u, _ = vecs
    jm = jred.mask_covered([jnp.asarray(x) for x in u], jg, fill=-7.0)
    tu = cv.level_list_from_numpy(u, "cpu")
    tm = tred.mask_covered(tu, tg, fill=-7.0)
    for t, j, orig in zip(tm, jm, u):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, orig in zip(tu, u):  # inputs untouched
        np.testing.assert_array_equal(t.numpy(), orig)
    for l in range(4):
        jm_ = jred.covered_mask(u[l].shape, jg, l)
        tm_ = tred.covered_mask(u[l].shape, tg, l)
        assert (jm_ is None) == (tm_ is None)
        if jm_ is not None:
            np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))


def _system(n, seed, cond):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eig = np.geomspace(1.0, cond, n)
    a = q @ np.diag(eig) @ q.T + 0.05 * rng.standard_normal((n, n))
    return a, rng.standard_normal(n)


SYSTEMS = {
    # id: (n, seed, cond, tol, max_iter, hang, precond)
    "easy": (40, 0, 10.0, 1e-10, 100, 0.0, False),
    "precond": (40, 1, 1e3, 1e-10, 100, 0.0, True),
    "cap": (60, 2, 1e4, 1e-12, 7, 0.0, False),
    "hang_restart": (60, 3, 1e6, 1e-14, 60, 1e-2, False),
    "hang_tight": (30, 4, 1e2, 1e-10, 100, 1e-11, False),
}


@pytest.mark.parametrize("name", list(SYSTEMS))
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_bicgstab_iteration_counts(name, dt):
    n, seed, cond, tol, max_iter, hang, use_pc = SYSTEMS[name]
    if dt == "f32":
        tol = max(tol, 1e-5)
    npdt = np.float64 if dt == "f64" else np.float32
    a, b = _system(n, seed, cond)
    a, b = a.astype(npdt), b.astype(npdt)
    dinv = (1.0 / np.diag(a)).astype(npdt)
    ja, jb, jd = jnp.asarray(a), jnp.asarray(b), jnp.asarray(dinv)
    ta, tb, td = (torch.from_numpy(x.copy()) for x in (a, b, dinv))
    ref = jbi.bicgstab(
        lambda x: ja @ x, jb, precond_fn=(lambda r: jd * r) if use_pc else None,
        tol=tol, max_iter=max_iter, hang=hang)
    out = tbi.bicgstab(
        lambda x: ta @ x, tb, precond_fn=(lambda r: td * r) if use_pc else None,
        tol=tol, max_iter=max_iter, hang=hang)
    if dt == "f64":
        # same recurrence, same stopping tests: identical counts and flags
        assert out.iters == int(ref.iters)
        assert out.converged == bool(ref.converged)
        assert out.hung == bool(ref.hung)
        assert out.breakdown == bool(ref.breakdown)
        assert float(out.initial_rnorm) == pytest.approx(
            float(ref.initial_rnorm), rel=1e-13)
        if out.converged and out.iters < 30:
            np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x),
                                       rtol=0, atol=1e-8)
    else:
        # f32 matvec rounding differs between the two BLAS paths, and
        # BiCGStab amplifies it: hold the count to +-2 and the flags
        assert abs(out.iters - int(ref.iters)) <= 2
        assert out.final_rnorm.dtype == torch.float32
    assert out.iters <= max_iter


def test_bicgstab_x0_lists_and_breakdown():
    """List-of-levels operands with an initial guess; and the exact
    breakdown rule: a zero rhs stops before the first iteration, a
    rho = 0 recurrence reports breakdown with x untouched."""
    rng = np.random.default_rng(8)
    d = [rng.uniform(1.0, 2.0, (4, 3)), rng.uniform(1.0, 2.0, (5,))]
    b = [rng.standard_normal((4, 3)), rng.standard_normal((5,))]
    x0 = [rng.standard_normal((4, 3)), rng.standard_normal((5,))]
    jd = [jnp.asarray(x) for x in d]
    td = [torch.from_numpy(x) for x in d]
    ref = jbi.bicgstab(lambda x: [a * v for a, v in zip(jd, x)],
                       [jnp.asarray(x) for x in b],
                       x0=[jnp.asarray(x) for x in x0], tol=1e-12)
    out = tbi.bicgstab(lambda x: [a * v for a, v in zip(td, x)],
                       [torch.from_numpy(x) for x in b],
                       x0=[torch.from_numpy(x) for x in x0], tol=1e-12)
    assert out.iters == int(ref.iters) and out.converged
    for t, j in zip(out.x, ref.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12)
    zero = tbi.bicgstab(lambda x: x, torch.zeros(5, dtype=torch.float64))
    assert zero.iters == 0 and zero.converged
    # A = antisymmetric rotation: rhat.v = 0 on the first step -> breakdown
    rot = np.array([[0.0, 1.0], [-1.0, 0.0]])
    rhs = np.array([1.0, 0.0])
    jr = jbi.bicgstab(lambda x: jnp.asarray(rot) @ x, jnp.asarray(rhs))
    tr = tbi.bicgstab(lambda x: torch.from_numpy(rot) @ x,
                      torch.from_numpy(rhs))
    assert tr.breakdown == bool(jr.breakdown) == True
    assert tr.iters == int(jr.iters) == 1
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), atol=1e-15)
