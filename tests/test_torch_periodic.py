"""The periodic box as a whole, at a small size, against the JAX package:
`is_periodic = 1`, the constant-K integrability branch, the triple-sine
scalar field, from the port's params/periodic.txt with N overridden.

  * one level at 16^3 and 32^3 through poisson_solve, all f64;
  * the same box without the punctures (the sine field alone), where the
    Hamiltonian constraint of the result converges at second order;
  * the mixed-precision kernel path at 32^3 (JAX: Pallas interpret mode;
    port: the kernels' plain versions);
  * two levels whose fine box touches a periodic domain face without
    spanning the domain (a coarse-fine face whose coarse neighbour wraps):
    the hierarchy, K (a composite integral then) and the history;
  * the linear solve of tests/test_mg.py's periodic edge-face case;
  * the command-line run on the CPU, with `is_periodic` in both files.

Both sides read the same parameter file with the same overrides.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import load_params as jload
from mg_ic_code_tpu.grid.boxes import Box as JBox
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC
from mg_ic_code_tpu.grid.geometry import HierarchyGeom as JGeom
from mg_ic_code_tpu.grid.tagging import generate_hierarchy as jhier
from mg_ic_code_tpu.solver import composite as jcomp
from mg_ic_code_tpu.solver import nonlinear as jnl

import mg_ic_code_tpu_torch as mgt
from mg_ic_code_tpu_torch import main as tmain
from mg_ic_code_tpu_torch.grid.boxes import Box as TBox
from mg_ic_code_tpu_torch.grid.geometry import BCSpec as TBC
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom as TGeom
from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy as thier
from mg_ic_code_tpu_torch.io import chombo_hdf5 as chio
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import nonlinear as tnl

torch.set_num_threads(1)

PERIODIC = os.path.join(os.path.dirname(mgt.__file__), "params",
                        "periodic.txt")
# one puncture near the high x face: the refined box touches that face and
# no other
TWO_LEVEL = ["N = 32 32 32", "max_level = 1", "refine_threshold = 0.5",
             "bh1_offset = 6.0", "bh2_offset = 2.0", "max_NL_iterations = 3",
             "verbosity = 0"]


def both(overrides):
    return jload(PERIODIC, overrides), mgt.load_params(PERIODIC, overrides)


def test_params_file_is_the_periodic_box():
    jcfg, tcfg = both([])
    for cfg in (jcfg, tcfg):
        assert cfg.is_periodic and cfg.phi_profile == "sine"
        assert tuple(cfg.n_cells) == (256, 256, 256) and cfg.max_level == 0
        assert cfg.L == 16.0 and cfg.num_mg_smooth == 4
        assert cfg.num_mg_iterations == 2 and cfg.tolerance == 1e-10
        assert cfg.bh1_momentum == 0.05 and cfg.bh2_momentum == -0.05
        assert cfg.bh1_offset == 2.0 and cfg.bh2_offset == -2.0
        assert cfg.phi_amplitude == 0.02 and cfg.phi_wavelength == 1.0


@pytest.mark.parametrize("n", [16, 32])
def test_single_level_f64(n):
    """K to 1e-10 relative, the contracting entries of the history to 1e-8
    relative, equal Krylov counts. (Later entries are corrections below
    1e-6 of the first, to an O(1) field: they are held to 1e-11 of the
    first entry, as tests/test_torch_nonlinear.py holds them.)"""
    over = [f"N = {n} {n} {n}", "verbosity = 0"]
    jcfg, tcfg = both(over)
    jres = jnl.poisson_solve(jcfg, verbose=False)
    tres = tnl.poisson_solve(tcfg, device="cpu", verbose=False)
    assert tres.geom.num_levels == 1
    assert np.isfinite(tres.constant_K) and tres.constant_K < 0.0
    assert tres.constant_K == pytest.approx(jres.constant_K, rel=1e-10)
    jh, th = jres.dpsi_norm_history, tres.dpsi_norm_history
    assert len(th) == len(jh) >= 3
    assert th[0] > th[1] > th[2]
    for t, j in zip(th[:2], jh[:2]):
        assert t == pytest.approx(j, rel=1e-8)
    for t, j in zip(th[2:], jh[2:]):
        assert abs(t - j) <= 1e-11 * jh[0], (t, j)
    assert tres.linear_iters[:3] == jres.linear_iters[:3]
    np.testing.assert_allclose(tres.psi[0].numpy(), np.asarray(jres.psi[0]),
                               rtol=0, atol=1e-10)


def test_smooth_box_is_second_order():
    """Without the punctures every term is smooth: K and the first step
    match the JAX package's at 16^3, the first step does not move with the
    resolution, and the RMS of the Hamiltonian constraint over every cell
    falls by four per doubling (16^3 -> 32^3: 0.2576 read)."""
    from mg_ic_code_tpu_torch.physics import diagnostics as tdg

    smooth = ["bh1_bare_mass = 0", "bh2_bare_mass = 0", "bh1_momentum = 0",
              "bh2_momentum = 0", "bh1_spin = 0", "bh2_spin = 0",
              "verbosity = 0"]
    rms, first = [], []
    for n in (16, 32):
        jcfg, tcfg = both([f"N = {n} {n} {n}"] + smooth)
        tres = tnl.poisson_solve(tcfg, device="cpu", verbose=False)
        if n == 16:
            jres = jnl.poisson_solve(jcfg, verbose=False)
            assert tres.constant_K == pytest.approx(jres.constant_K,
                                                    rel=1e-10)
            assert tres.dpsi_norm_history[0] == pytest.approx(
                jres.dpsi_norm_history[0], rel=1e-8)
        assert tres.constant_K < 0.0
        h = tdg.hamiltonian_residual(tres.geom, tcfg, tres.psi[0], 0,
                                     tres.constant_K)
        rms.append(float(h.pow(2).mean().sqrt()))
        first.append(tres.dpsi_norm_history[0])
    assert first[1] == pytest.approx(first[0], rel=1e-8)
    assert 0.24 <= rms[1] / rms[0] <= 0.27


def test_single_level_mixed_precision_kernel_path():
    """precond_precision = single, smoother = pallas on both sides at 32^3:
    the first entry to 1e-7 relative (two f32 preconditioners), K to 1e-10
    (K is set before the first linear solve, from psi = 1), equal Krylov
    counts. On CPU tensors the 32^3 level goes to the tower's plain version:
    the multisweep rung is for CUDA levels above the L2 term."""
    over = ["N = 32 32 32", "max_NL_iterations = 2", "verbosity = 0",
            "precond_precision = single", "smoother = pallas"]
    jcfg, tcfg = both(over)
    jres = jnl.poisson_solve(jcfg, verbose=False)
    kernel_counts.reset()
    tres = tnl.poisson_solve(tcfg, device="cpu", verbose=False)
    assert tres.dpsi_norm_history[0] == pytest.approx(
        jres.dpsi_norm_history[0], rel=1e-7)
    assert tres.dpsi_norm_history[1] < 1e-2 * tres.dpsi_norm_history[0]
    assert tres.linear_iters == jres.linear_iters
    plain = kernel_counts.PLAIN_CALLS
    assert plain["tower_down"] > 0 and plain["tower_up"] > 0
    assert plain["multisweep_relax"] == plain["wavefront_relax"] == 0
    assert all(v == 0 for v in kernel_counts.LAUNCHES.values())


@pytest.fixture(scope="module")
def two_level():
    jcfg, tcfg = both(TWO_LEVEL)
    jg, tg = jhier(jcfg), thier(tcfg, device="cpu")
    return jcfg, tcfg, jg, tg


def test_two_level_hierarchy_touches_a_periodic_face(two_level):
    _, _, jg, tg = two_level
    assert tg.num_levels == jg.num_levels == 2
    assert [(b.lo, b.hi) for b in tg.boxes] == [
        (b.lo, b.hi) for b in jg.boxes]
    fine, dom = tg.boxes[1], tg.domain_boxes[1]
    assert tg.bc.periodic
    # at the high x face of the domain, short of every other face
    assert fine.hi[0] == dom.hi[0] and fine.lo[0] > dom.lo[0]
    assert all(fine.lo[d] > dom.lo[d] and fine.hi[d] < dom.hi[d]
               for d in (1, 2))


def test_two_level_solve_f64(two_level):
    """K is the composite integral over both levels here. History and K as
    in the single-level test; psi on both levels to 1e-10."""
    jcfg, tcfg, jg, tg = two_level
    jres = jnl.poisson_solve(jcfg, geom=jg, verbose=False)
    tres = tnl.poisson_solve(tcfg, geom=tg, device="cpu", verbose=False)
    assert tres.constant_K < 0.0
    assert tres.constant_K == pytest.approx(jres.constant_K, rel=1e-10)
    jh, th = jres.dpsi_norm_history, tres.dpsi_norm_history
    assert th[0] > th[1] > th[2]
    for t, j in zip(th[:2], jh[:2]):
        assert t == pytest.approx(j, rel=1e-8)
    assert abs(th[2] - jh[2]) <= 1e-11 * jh[0]
    assert tres.linear_iters == jres.linear_iters
    for t, j in zip(tres.psi, jres.psi):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-10)


def test_periodic_edge_face_linear_solve_matches_jax():
    """The configuration of tests/test_mg.py::
    test_periodic_edge_face_two_level_solve_converges: a fine box touching a
    periodic domain face must solve to tolerance, with the JAX package's
    iterate."""
    shapes = ((16, 16, 16), (16, 8, 8))
    geoms = []
    for Box, Geom, BC in ((JBox, JGeom, JBC), (TBox, TGeom, TBC)):
        dom0 = Box.from_shape(shapes[0])
        fine = Box.from_shape(shapes[1], lo=(0, 4, 4))
        geoms.append(Geom(
            boxes=(dom0, fine), domain_boxes=(dom0, dom0.refine(2)),
            dx=(1.0 / 16, 1.0 / 32), domain_length=(1.0, 1.0, 1.0),
            bc=BC(periodic=True)))
    kw = dict(alpha=1.0, beta=-1.0, n_cells=(16, 16, 16), L=1.0,
              max_level=0, num_mg_smooth=4, num_mg_iterations=1,
              max_iterations=40, tolerance=1e-10, is_periodic=True)
    from mg_ic_code_tpu.config import SolverConfig as JCfg

    jspec = jcomp.make_amr_spec(geoms[0], JCfg(**kw))
    tspec = tcomp.make_amr_spec(geoms[1], mgt.SolverConfig(**kw), "cpu")
    rng = np.random.default_rng(3)
    a = [rng.uniform(0.5, 2.0, s) for s in shapes]
    r = [rng.standard_normal(s) for s in shapes]
    jout = jcomp.solve_linear_jit(
        jspec, jcomp.build_coefs_jit(jspec, [jnp.asarray(x) for x in a]),
        [jnp.asarray(x) for x in r], [jnp.zeros(s) for s in shapes])
    ta = [torch.from_numpy(x) for x in a]
    tr = [torch.from_numpy(x) for x in r]
    tout = tcomp.solve_linear(tspec, tcomp.build_coefs(tspec, ta), tr)
    assert bool(tout.converged) and bool(jout.converged)
    assert int(tout.iters) == int(jout.iters) <= 6
    assert float(tout.final_rnorm / tout.initial_rnorm) < 1e-10
    for t, j in zip(tout.x, jout.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-9 * float(np.max(np.abs(j))))


@pytest.mark.skipif(not chio.HAVE_H5PY, reason="h5py not installed")
def test_cli_on_the_cpu_writes_periodic_headers(tmp_path, monkeypatch):
    """main.run on periodic.txt with a 16^3 grid: exit 0, K printed, and
    `is_periodic_<d>` = 1 in the plotfile and in the checkpoint."""
    import h5py

    monkeypatch.chdir(tmp_path)
    rc = tmain.run(["main", PERIODIC, "N = 16 16 16",
                    "max_NL_iterations = 2", "verbosity = 0"], device="cpu")
    assert rc == 0
    names = sorted(os.listdir(tmp_path))
    assert names == ["vcPoissonFinal.3d.hdf5", "vcPoissonOut.3d_0.hdf5",
                     "vcPoissonOut.3d_1.hdf5"]
    for name in (names[0], names[1]):
        with h5py.File(name, "r") as f:
            g = f["level_0"]
            assert [int(g.attrs[f"is_periodic_{d}"]) for d in range(3)] == [
                1, 1, 1], name
    box, _, _, named = chio.read_level_data(names[0], 0)
    assert box.shape == (16, 16, 16)
    k = named["K"]
    assert float(k.min()) == float(k.max()) < 0.0
