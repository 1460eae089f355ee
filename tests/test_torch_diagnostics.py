"""physics/diagnostics of the port against the JAX package's, function by
function, on the same numpy inputs, rtol 1e-12 (of the largest value of
each result)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC
from mg_ic_code_tpu.grid.geometry import single_level_geom as jgeom1
from mg_ic_code_tpu.grid.tagging import generate_hierarchy as jhier
from mg_ic_code_tpu.physics import diagnostics as jdg

from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC
from mg_ic_code_tpu_torch.grid.geometry import single_level_geom as tgeom1
from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy as thier
from mg_ic_code_tpu_torch.physics import diagnostics as tdg

torch.set_num_threads(1)

BASE = dict(
    alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16), max_level=0,
    G_Newton=1.0, phi_amplitude=0.05, phi_wavelength=1.0,
    bh1_bare_mass=0.2, bh2_bare_mass=0.3, bh1_offset=2.0, bh2_offset=-2.0,
    bh1_momentum=0.02, bh2_momentum=-0.03, bh1_spin=0.02, bh2_spin=0.01,
    verbosity=0,
)
CASES = {
    "gaussian": dict(),
    "sine_periodic": dict(is_periodic=True, phi_profile="sine",
                          phi_amplitude=0.02),
}
K = {"gaussian": 0.0, "sine_periodic": -0.0453}


def close(t, j):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=1e-12 * float(np.max(np.abs(j))))


def setup(case):
    kw = dict(BASE, **CASES[case])
    periodic = kw.get("is_periodic", False)
    jg = jgeom1(16, 16.0, JBC(periodic=periodic))
    tg = tgeom1(16, 16.0, TBC(periodic=periodic))
    rng = np.random.default_rng(5)
    psi = 1.0 + 0.05 * rng.standard_normal((16, 16, 16))
    return JCfg(**kw), TCfg(**kw), jg, tg, psi


def test_laplacian4():
    u = np.random.default_rng(1).standard_normal((12, 10, 9))
    close(tdg.laplacian4(torch.from_numpy(u), 0.3),
          jdg.laplacian4(jnp.asarray(u), 0.3))
    # fourth order: exact on a quartic
    x = np.arange(9.0)[:, None, None] * np.ones((9, 9, 9))
    lap = tdg.laplacian4(torch.from_numpy(x**4), 1.0)
    np.testing.assert_allclose(lap.numpy(), 12.0 * x[2:-2, 2:-2, 2:-2]**2,
                               rtol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_rho_grad_exact(case):
    jcfg, tcfg, jg, tg, _ = setup(case)
    jx, tx = jg.coords(0), tg.coords(0)
    close(tdg.rho_grad_exact(*[torch.as_tensor(c) for c in tx], tcfg),
          jdg.rho_grad_exact(*[jnp.asarray(c) for c in jx], jcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_hamiltonian_residual(case):
    jcfg, tcfg, jg, tg, psi = setup(case)
    out = tdg.hamiltonian_residual(tg, tcfg, torch.from_numpy(psi), 0,
                                   K[case])
    assert out.shape == (12, 12, 12) and out.device.type == "cpu"
    close(out, jdg.hamiltonian_residual(jg, jcfg, jnp.asarray(psi), 0,
                                        K[case]))


@pytest.mark.parametrize("case", list(CASES))
def test_momentum_constraint_divergence(case):
    jcfg, tcfg, jg, tg, _ = setup(case)
    tdiv, tmag = tdg.momentum_constraint_divergence(tg, tcfg, 0,
                                                    device="cpu")
    jdiv, jmag = jdg.momentum_constraint_divergence(jg, jcfg, 0)
    close(tdiv, jdiv)
    close(tmag, jmag)
    assert tdiv.shape == (16, 16, 16)


@pytest.mark.parametrize("case", list(CASES))
def test_adm_masses(case):
    jcfg, tcfg, jg, tg, psi = setup(case)
    tp, jp = torch.from_numpy(psi), jnp.asarray(psi)
    for margin in (2, 3):
        assert float(tdg.adm_mass_surface(tg, tcfg, tp, 0, margin)) == (
            pytest.approx(float(jdg.adm_mass_surface(jg, jcfg, jp, 0,
                                                     margin)), rel=1e-12))
        assert float(tdg.adm_mass_volume(
            tg, tcfg, tp, 0, margin, K[case])) == pytest.approx(
                float(jdg.adm_mass_volume(jg, jcfg, jp, 0, margin, K[case])),
                rel=1e-12)


def test_fine_level_of_a_hierarchy():
    """On a refined level the coordinates come from the level's own box."""
    kw = dict(BASE, max_level=1, refine_threshold=0.5, block_factor=4)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jg, tg = jhier(jcfg), thier(tcfg, device="cpu")
    assert tg.num_levels == 2
    psi = 1.0 + 0.05 * np.random.default_rng(6).standard_normal(
        tg.shape(1))
    close(tdg.hamiltonian_residual(tg, tcfg, torch.from_numpy(psi), 1),
          jdg.hamiltonian_residual(jg, jcfg, jnp.asarray(psi), 1))
    tdiv, _ = tdg.momentum_constraint_divergence(tg, tcfg, 1, device="cpu")
    jdiv, _ = jdg.momentum_constraint_divergence(jg, jcfg, 1)
    close(tdiv, jdiv)


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    _, tcfg, _, tg, _ = setup("gaussian")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdg.momentum_constraint_divergence(tg, tcfg, 0)
