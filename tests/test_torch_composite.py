"""solver/composite of the PyTorch port against the JAX package on a
3-level hierarchy: the same numpy aCoef/rhs/u on both sides, the JAX
coefficient structures carried across with convert.coefs_from_numpy.
f64 staged path for the operator and the solve; the f32 kernel path
(smoother = pallas: JAX Pallas interpret mode vs the port's plain versions)
for the preconditioner."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC, HierarchyGeom as JGeom
from mg_ic_code_tpu.solver import composite as jcomp

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import composite as tcomp

torch.set_num_threads(1)


def hierarchy(levels=3):
    dom0 = Box.from_shape((16, 16, 16))
    l1 = Box((2, 4, 4), (11, 11, 11)).refine(2)          # 20x16x16
    l2 = Box((8, 10, 10), (19, 21, 21)).refine(2)        # 24x24x24
    jg = JGeom(
        boxes=(dom0, l1, l2)[:levels],
        domain_boxes=(dom0, dom0.refine(2), dom0.refine(4))[:levels],
        dx=(0.0625, 0.03125, 0.015625)[:levels], domain_length=(1.0,) * 3,
        bc=JBC(bc_value=0.1), parent=(-1, 0, 1)[:levels],
    )
    plain = lambda bs: [(b.lo, b.hi) for b in bs]
    tg = cv.geom_from_plain(
        plain(jg.boxes), jg.parent, jg.dx,
        dict(bc_lo=(0, 0, 0), bc_hi=(0, 0, 0), bc_value=0.1, periodic=False),
        plain(jg.domain_boxes), jg.domain_length)
    return jg, tg


def export_coefs(jcoefs):
    def chain(t):
        return [None if x is None else np.asarray(x) for x in t]

    out = []
    for c in jcoefs:
        d = {k: chain(c[k]) for k in ("a", "b", "lam")}
        if c.get("binv") is not None:
            d["binv"] = np.asarray(c["binv"])
        if "lp" in c:
            d["lp"] = {k: chain(c["lp"][k]) for k in ("a", "b", "lam")}
            if c["lp"].get("binv") is not None:
                d["lp"]["binv"] = np.asarray(c["lp"]["binv"])
        out.append(d)
    return tuple(out)


def make(levels=3, **kw):
    base = dict(alpha=1.0, beta=-1.0, L=1.0, n_cells=(16, 16, 16),
                max_level=2, num_mg_smooth=4, num_mg_iterations=2,
                max_iterations=30, tolerance=1e-10, hang=1e-11,
                coefficient_average_type="harmonic", smoother="xla",
                precond_precision="double")
    base.update(kw)
    jg, tg = hierarchy(levels)
    jspec = jcomp.make_amr_spec(jg, JCfg(**base))
    tspec = tcomp.make_amr_spec(tg, TCfg(**base), device="cpu")
    rng = np.random.default_rng(4)
    a = [rng.uniform(0.5, 2.0, b.shape) for b in jg.boxes]
    rhs = [rng.standard_normal(b.shape) for b in jg.boxes]
    u = [rng.standard_normal(b.shape) for b in jg.boxes]
    jco = jcomp.build_coefs_jit(jspec, [jnp.asarray(x) for x in a])
    tco = cv.coefs_from_numpy(export_coefs(jco), "cpu")
    return jspec, tspec, jco, tco, a, rhs, u


@pytest.fixture(scope="module")
def f64():
    return make()


@pytest.fixture(scope="module")
def mixed():
    # two levels: the JAX side compiles its kernels in interpret mode
    return make(levels=2, smoother="pallas", precond_precision="single")


def J(xs):
    return [jnp.asarray(x) for x in xs]


def T(xs, dtype=None):
    return cv.level_list_from_numpy(xs, "cpu", dtype)


def close_lists(ts, js, rtol):
    for t, j in zip(ts, js):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.numpy(), j, rtol=0, atol=rtol * float(np.max(np.abs(j))))


def test_spec_fields_match(f64, mixed):
    for jspec, tspec in ((f64[0], f64[1]), (mixed[0], mixed[1])):
        for name in ("alpha", "beta", "nsmooth", "num_mg_iterations",
                     "avg_type", "tol", "max_iter", "hang",
                     "pre_cond_solver_depth", "precond_dtype"):
            assert getattr(tspec, name) == getattr(jspec, name), name
        assert not hasattr(tspec, "batch_groups")
        hash(tspec)
    assert mixed[1].precond_dtype == "float32" and f64[1].precond_dtype is None


def test_bfloat16_smoother_is_refused(f64):
    """Reduced-precision colour passes are not ported: asking for them
    raises instead of running at operand precision without a word."""
    geom = f64[1].geom
    cfg = TCfg(n_cells=(16, 16, 16), max_level=2,
               smoother_precision="bfloat16")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tcomp.make_amr_spec(geom, cfg, device="cpu")
    for ok in ("auto", "single"):
        spec = tcomp.make_amr_spec(
            geom, dataclasses.replace(cfg, smoother_precision=ok),
            device="cpu")
        assert all(s.smoother_compute is None for s in spec.level_specs)


def test_build_coefs_matches(f64, mixed):
    for jspec, tspec, jco, _, a, *_ in (f64, mixed):
        tco = tcomp.build_coefs(tspec, T(a))
        assert len(tco) == tspec.num_levels
        for tc, jc in zip(tco, jco):
            assert set(tc) == set(jc)
            for key in ("a", "lam"):
                close_lists(tc[key], jc[key], 1e-13)
            if "lp" in jc:
                assert tc["lp"]["a"][0].dtype == torch.float32
                close_lists(tc["lp"]["lam"], jc["lp"]["lam"], 1e-6)
                close_lists([tc["lp"]["binv"]], [jc["lp"]["binv"]], 1e-6) \
                    if "binv" in jc["lp"] else None
        assert "binv" in tco[0] and "binv" not in tco[1]


@pytest.mark.parametrize("homog", [True, False])
def test_composite_apply_and_residual(f64, homog):
    jspec, tspec, jco, tco, a, rhs, u = f64
    ref = jcomp.composite_apply_jit(jspec, jco, J(u), homog, False)
    out = tcomp.composite_apply(tspec, tco, T(u), homog)
    close_lists(out, ref, 1e-13)  # |A u| ~ 1e4: relative to its max
    ref = jcomp.composite_residual_jit(jspec, jco, J(u), J(rhs), homog)
    out = tcomp.composite_residual(tspec, tco, T(u), T(rhs), homog)
    close_lists(out, ref, 1e-13)


def test_amr_vcycle_f64(f64):
    jspec, tspec, jco, tco, a, rhs, u = f64
    ref = jcomp.amr_vcycle_jit(jspec, jco, J(rhs))
    out = tcomp.amr_vcycle(tspec, tco, T(rhs))
    close_lists(out, ref, 1e-11)  # reassociation through ~100 passes


@pytest.mark.parametrize("depth", [-1, 0])
def test_solve_linear_f64(f64, depth):
    """Equal BiCGStab iteration counts and x to 1e-10 (relative to
    max|x|); with pre_cond_solver_depth = 0 the preconditioner is itself
    an inner BiCGStab."""
    jspec, tspec, jco, tco, a, rhs, u = f64
    jspec = dataclasses.replace(jspec, pre_cond_solver_depth=depth)
    tspec = dataclasses.replace(tspec, pre_cond_solver_depth=depth)
    x0 = [0.01 * x for x in u]
    ref = jcomp.solve_linear_jit(jspec, jco, J(rhs), J(x0))
    out = tcomp.solve_linear(tspec, tco, T(rhs), T(x0))
    assert out.iters == int(ref.iters)
    assert out.converged and bool(ref.converged)
    assert not out.hung and not out.breakdown
    assert float(out.initial_rnorm) == pytest.approx(
        float(ref.initial_rnorm), rel=1e-12)
    close_lists(out.x, ref.x, 1e-10)
