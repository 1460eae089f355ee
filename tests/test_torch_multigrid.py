"""solver/multigrid of the PyTorch port against the JAX package:
coefficient chains incl. the dense bottom inverse, bottom_solve (direct and
BiCGStab), the staged V-/W-cycle, level_precond, relax_cf. f64 on the
staged path; tolerances stated per check."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import (
    BCSpec as JBC, HierarchyGeom as JGeom, single_level_geom as jgeom1,
)
from mg_ic_code_tpu.solver import multigrid as jmg

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC, single_level_geom as tgeom1
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

BCS = {
    "dirichlet": dict(),
    "mixed": dict(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0)),
    "periodic": dict(periodic=True),
}


def specs(bc, n=16, **kw):
    js = jmg.make_level_spec(jgeom1(n, 1.0, JBC(**BCS[bc])), 0, 1.0, -1.0, 4,
                             smoother="xla", **kw)
    ts = tmg.make_level_spec(tgeom1(n, 1.0, TBC(**BCS[bc])), 0, 1.0, -1.0, 4,
                             smoother="xla", **kw)
    return js, ts


def arrays(n=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, (n, n, n)), rng.standard_normal((n, n, n)),
            rng.standard_normal((n, n, n)))


def close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_level_spec_fields_match():
    js, ts = specs("mixed")
    for name in ("kinds", "dx", "rho", "alpha", "beta", "nsmooth",
                 "avg_type", "bottom_iters", "bottom_tol", "num_mg",
                 "smoother", "bottom", "smoother_compute"):
        assert getattr(ts, name) == getattr(js, name), name
    assert [b.shape for b in ts.boxes] == [b.shape for b in js.boxes]
    assert not hasattr(ts, "mesh")  # the port's spec carries no mesh
    hash(ts)


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
def test_build_level_coefs(bc, avg, with_b):
    js, ts = specs(bc, avg_type=avg)
    a, b, _ = arrays()
    b = np.abs(b) + 0.5
    jco = jmg.build_level_coefs_jit(js, jnp.asarray(a),
                                    jnp.asarray(b) if with_b else None)
    tco = tmg.build_level_coefs(ts, torch.from_numpy(a),
                                torch.from_numpy(b) if with_b else None)
    for key in ("a", "b", "lam"):
        assert len(tco[key]) == len(jco[key]) == ts.ndepths
        for t, j in zip(tco[key], jco[key]):
            assert (t is None) == (j is None)
            if t is not None:
                close(t, j, 1e-13)
    # dense bottom inverse: both sides invert the same 64x64 operator with
    # LU; compare to 1e-11 of its largest entry (condition number ~1e2)
    assert ("binv" in tco) == ("binv" in jco) == True
    scale = float(np.max(np.abs(np.asarray(jco["binv"]))))
    close(tco["binv"], jco["binv"], 1e-11 * scale)
    # and it IS the inverse of the port's own operator
    d = ts.ndepths - 1
    m = tco["binv"].shape[0]
    eye = torch.eye(m, dtype=torch.float64)
    cols = tmg.apply_homog(
        ts, tco, d, eye.reshape((m,) + ts.boxes[d].shape)).reshape(m, m)
    close(cols.T @ tco["binv"], np.eye(m), 1e-11)


def test_singular_bottom_is_not_inverted():
    js = jmg.make_level_spec(jgeom1(8, 1.0, JBC(periodic=True)), 0, 0.0,
                             -1.0, 4)
    ts = tmg.make_level_spec(tgeom1(8, 1.0, TBC(periodic=True)), 0, 0.0,
                             -1.0, 4)
    assert tmg._use_direct_bottom(ts) == jmg._use_direct_bottom(js) == False
    a = torch.ones((8, 8, 8), dtype=torch.float64)
    assert "binv" not in tmg.build_level_coefs(ts, a)


@pytest.mark.parametrize("bottom", ["direct", "bicgstab"])
@pytest.mark.parametrize("bc", ["dirichlet", "mixed"])
def test_bottom_solve(bc, bottom):
    js, ts = specs(bc, n=8, bottom=bottom)
    a, rhs, u = arrays(8)
    jco = jmg.build_level_coefs(js, jnp.asarray(a))
    tco = tmg.build_level_coefs(ts, torch.from_numpy(a))
    d = ts.ndepths - 1
    sh = ts.boxes[d].shape
    rhs_d, u_d = rhs[:sh[0], :sh[1], :sh[2]], u[:sh[0], :sh[1], :sh[2]]
    ref = jmg.bottom_solve(js, jco, d, jnp.asarray(u_d), jnp.asarray(rhs_d))
    out = tmg.bottom_solve(ts, tco, d, torch.from_numpy(u_d.copy()),
                           torch.from_numpy(rhs_d.copy()))
    # direct: two LU-inverse products; bicgstab: converged to 1e-12
    close(out, ref, 1e-10)
    res = tmg.residual_homog(ts, tco, d, out, torch.from_numpy(rhs_d.copy()))
    assert float(res.abs().max()) < 1e-9


@pytest.mark.parametrize("bc", list(BCS))
@pytest.mark.parametrize("num_mg", [1, 2], ids=["V", "W"])
def test_mg_vcycle_staged_f64(bc, num_mg):
    js, ts = specs(bc, num_mg=num_mg)
    a, rhs, u = arrays()
    jco = jmg.build_level_coefs(js, jnp.asarray(a))
    tco = tmg.build_level_coefs(ts, torch.from_numpy(a))
    ref = jmg.mg_vcycle_jit(js, jco, jnp.asarray(u), jnp.asarray(rhs))
    out = tmg.mg_vcycle(ts, tco, torch.from_numpy(u), torch.from_numpy(rhs))
    # same staged algorithm in f64; reassociation through ~50 passes
    close(out, ref, 1e-11)


def test_relax_residual_precond_f64():
    js, ts = specs("mixed")
    a, rhs, u = arrays()
    jco = jmg.build_level_coefs(js, jnp.asarray(a))
    tco = tmg.build_level_coefs(ts, torch.from_numpy(a))
    tu, trhs = torch.from_numpy(u), torch.from_numpy(rhs)
    ju, jrhs = jnp.asarray(u), jnp.asarray(rhs)
    close(tmg.relax(ts, tco, 0, tu, trhs, 3),
          jmg.relax_jit(js, jco, 0, ju, jrhs, 3), 1e-12)
    close(tmg.residual_homog(ts, tco, 0, tu, trhs),
          jmg.residual_homog_jit(js, jco, 0, ju, jrhs), 1e-9)  # |res|~1e3
    close(tmg.apply_homog(ts, tco, 1, tu[:8, :8, :8]),
          jmg.apply_homog(js, jco, 1, ju[:8, :8, :8]), 1e-10)
    close(tmg.level_precond(ts, tco, 0, trhs),
          jmg.level_precond(js, jco, 0, jrhs), 1e-13)
    close(tmg.gsrb_sweep(ts, tco, 0, tu, trhs),
          jmg.gsrb_sweep(js, jco, 0, ju, jrhs), 1e-12)


@pytest.mark.parametrize("with_b", [False, True], ids=["const_b", "var_b"])
def test_relax_cf_and_folded_rhs(with_b):
    """The AMR post-smooth with CF ghosts from the coarse correction: the
    folded-rhs form (constant b) and the per-pass ghost-fill loop
    (variable b)."""
    dom0 = Box.from_shape((16, 16, 16))
    fine = Box((0, 4, 6), (7, 9, 9)).refine(2)
    jg = JGeom(boxes=(dom0, fine), domain_boxes=(dom0, dom0.refine(2)),
               dx=(1.0, 0.5), domain_length=(16.0,) * 3, bc=JBC(),
               parent=(-1, 0))
    plain = lambda bs: [(b.lo, b.hi) for b in bs]
    tg = cv.geom_from_plain(
        plain(jg.boxes), jg.parent, jg.dx,
        dict(bc_lo=(0, 0, 0), bc_hi=(0, 0, 0), bc_value=0.0, periodic=False),
        plain(jg.domain_boxes), jg.domain_length)
    js = jmg.make_level_spec(jg, 1, 1.0, -1.0, 4, with_depths=False,
                             smoother="xla")
    ts = tmg.make_level_spec(tg, 1, 1.0, -1.0, 4, with_depths=False,
                             smoother="xla")
    rng = np.random.default_rng(9)
    sh = fine.shape
    a, b = rng.uniform(0.5, 2.0, sh), rng.uniform(0.5, 2.0, sh)
    u, rhs = rng.standard_normal(sh), rng.standard_normal(sh)
    cu = rng.standard_normal((16, 16, 16))
    jco = jmg.build_level_coefs(js, jnp.asarray(a),
                                jnp.asarray(b) if with_b else None)
    tco = tmg.build_level_coefs(ts, torch.from_numpy(a),
                                torch.from_numpy(b) if with_b else None)
    ref = jmg.relax_cf(js, jco, jnp.asarray(u), jnp.asarray(rhs), 2, jg, 1,
                       jnp.asarray(cu))
    out = tmg.relax_cf(ts, tco, torch.from_numpy(u), torch.from_numpy(rhs),
                       2, tg, 1, torch.from_numpy(cu))
    close(out, ref, 1e-12)
    close(tmg.cf_folded_rhs(ts, tg, 1, torch.from_numpy(rhs),
                            torch.from_numpy(cu)),
          jmg.cf_folded_rhs(js, jg, 1, jnp.asarray(rhs), jnp.asarray(cu)),
          1e-12)
