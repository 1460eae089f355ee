"""physics/ of the PyTorch port against the JAX package, f64, on the same
hierarchy and the same numpy psi. Tolerance 1e-12 relative (to the field's
max): the formulas are identical, but XLA lowers x**-7 to multiply chains
and torch calls pow(), and exp/log/sqrt come from different math
libraries — each a last-ulp difference that the r^-6 growth of A^2 near a
puncture scales up."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec, HierarchyGeom
from mg_ic_code_tpu.physics import level_data as jld

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.physics import level_data as tld
from mg_ic_code_tpu_torch.physics import variables as tvars

torch.set_num_threads(1)

RTOL = 1e-12


def port_geom(g):
    plain = lambda bs: [(b.lo, b.hi) for b in bs]
    return cv.geom_from_plain(
        plain(g.boxes), g.parent, g.dx,
        dict(bc_lo=g.bc.bc_lo, bc_hi=g.bc.bc_hi, bc_value=g.bc.bc_value,
             periodic=g.bc.periodic),
        plain(g.domain_boxes), g.domain_length, g.ref_ratio,
    )


def close(t, j, rtol=RTOL):
    j = np.asarray(j)
    scale = max(float(np.max(np.abs(j))), 1e-300)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=rtol * scale)


def make(profile):
    cfg = JCfg(
        L=16.0, n_cells=(16, 16, 16), max_level=1, bh1_bare_mass=0.2,
        bh2_bare_mass=0.3, bh1_offset=2.0, bh2_offset=-2.0,
        bh1_momentum=0.02, bh2_momentum=-0.03, bh1_spin=0.02, bh2_spin=0.04,
        phi_amplitude=0.05, phi_wavelength=2.0, phi_profile=profile,
        is_periodic=profile == "sine",
    )
    dom0 = Box.from_shape((16, 16, 16))
    fine = Box((4, 4, 6), (11, 9, 9)).refine(2)
    geom = HierarchyGeom(
        boxes=(dom0, fine), domain_boxes=(dom0, dom0.refine(2)),
        dx=(1.0, 0.5), domain_length=(16.0, 16.0, 16.0),
        bc=BCSpec(periodic=cfg.is_periodic), parent=(-1, 0),
    )
    return cfg, geom


@pytest.fixture(scope="module", params=["gaussian", "sine"])
def setup(request):
    cfg, geom = make(request.param)
    tcfg, tgeom = TCfg(**dataclasses.asdict(cfg)), port_geom(geom)
    rng = np.random.default_rng(5)
    out = []
    for l in (0, 1):
        jf = jld.problem_fields(geom, cfg, l)
        tf = tld.problem_fields(tgeom, tcfg, l, torch.float64, "cpu")
        shape = geom.shape(l)
        psi = 1.0 + 0.1 * rng.standard_normal(shape)
        psi_gh = 1.0 + 0.1 * rng.standard_normal(tuple(s + 2 for s in shape))
        out.append((jf, tf, psi, psi_gh, geom.dx[l]))
    return cfg, tcfg, out


@pytest.mark.parametrize("level", [0, 1])
def test_problem_fields(setup, level):
    _, _, lv = setup
    jf, tf, *_ = lv[level]
    for key in ("phi", "rho_grad", "aij2", "psi_bh"):
        assert tf[key].dtype == torch.float64 and tf[key].is_contiguous()
        close(tf[key], jf[key])
    assert set(tf["aij"]) == set(jf["aij"])
    for comp in jf["aij"]:
        close(tf["aij"][comp], jf["aij"][comp])


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("K", [0.0, -0.3])
def test_rhs_and_a_coef(setup, level, K):
    cfg, tcfg, lv = setup
    jf, tf, psi, psi_gh, dx = lv[level]
    close(tld.set_a_coef(torch.from_numpy(psi), tf, tcfg, K),
          jld.set_a_coef(jnp.asarray(psi), jf, cfg, K))
    close(tld.set_rhs(torch.from_numpy(psi_gh), tf, tcfg, dx, K),
          jld.set_rhs(jnp.asarray(psi_gh), jf, cfg, dx, K))
    # a 0-d tensor K (what the Picard loop passes) gives the same values
    close(tld.set_a_coef(torch.from_numpy(psi), tf, tcfg,
                         torch.tensor(K, dtype=torch.float64)),
          jld.set_a_coef(jnp.asarray(psi), jf, cfg, K))


@pytest.mark.parametrize("level", [0, 1])
def test_integrand_and_regrid_condition(setup, level):
    cfg, tcfg, lv = setup
    jf, tf, psi, psi_gh, dx = lv[level]
    close(tld.constant_k_integrand(torch.from_numpy(psi_gh), tf, tcfg, dx),
          jld.constant_k_integrand(jnp.asarray(psi_gh), jf, cfg, dx))
    close(tld.regrid_condition(torch.from_numpy(psi), tf, tcfg),
          jld.regrid_condition(jnp.asarray(psi), jf, cfg))


def test_output_stack_and_initial_state(setup):
    cfg, tcfg, lv = setup
    jf, tf, psi, _, _ = lv[1]
    ref = jld.grchombo_output_stack(jnp.asarray(psi), jf, cfg, -0.25)
    out = tld.grchombo_output_stack(torch.from_numpy(psi), tf, tcfg, -0.25)
    assert out.shape[0] == tvars.NUM_GRCHOMBO_VARS
    assert tuple(out.shape) == tuple(ref.shape)
    close(out, ref)
    _, geom = make("gaussian")
    st = tld.initial_state(port_geom(geom), tcfg, torch.float64, "cpu")
    assert all(float(p.min()) == 1.0 == float(p.max()) for p in st["psi"])
    assert all(float(d.abs().max()) == 0.0 for d in st["dpsi"])
    assert [tuple(p.shape) for p in st["psi"]] == [geom.shape(0),
                                                   geom.shape(1)]


def test_m_value():
    cfg, _ = make("gaussian")
    tcfg = TCfg(**dataclasses.asdict(cfg))
    assert tld.m_value(tcfg, -0.3) == jld.m_value(cfg, -0.3)
