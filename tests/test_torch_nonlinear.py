"""The slice as a whole: the Picard solve of the PyTorch port against the
JAX package on the small two-level BBH of tests/test_nonlinear.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.tagging import generate_hierarchy as jhier
from mg_ic_code_tpu.physics import level_data as jld
from mg_ic_code_tpu.solver import nonlinear as jnl

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid.tagging import generate_hierarchy as thier
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.solver import nonlinear as tnl

torch.set_num_threads(1)


def small_bbh_kw(**kw):
    """tests/test_nonlinear.py::small_bbh_cfg — 16^3 base, L=16, weak
    punctures, one refined level."""
    base = dict(
        alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16), max_level=1,
        refine_threshold=0.5, block_factor=4, buffer_size=3,
        num_mg_smooth=4, num_mg_iterations=2, max_iterations=100,
        max_nl_iterations=6, tolerance=1e-10,
        coefficient_average_type="harmonic",
        is_periodic=False, bc_lo=(0, 0, 0), bc_hi=(0, 0, 0), bc_value=0.0,
        G_Newton=1.0, phi_amplitude=0.05, phi_wavelength=1.0,
        bh1_bare_mass=0.2, bh2_bare_mass=0.2,
        bh1_offset=2.0, bh2_offset=-2.0,
        bh1_momentum=0.02, bh2_momentum=-0.02,
        bh1_spin=0.02, bh2_spin=0.02, verbosity=0,
    )
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def f64_pair():
    kw = small_bbh_kw()
    jres = jnl.poisson_solve(JCfg(**kw), verbose=False)
    tres = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    return jres, tres


def test_two_level_f64_history(f64_pair):
    """All-f64 solve: history to 1e-8 relative wherever f64 can give it,
    equal linear_iters while the Picard loop contracts.

    Readings of this test (printed below; 1 thread, x86-64 CPU):

        entry  JAX value   |port-JAX|/JAX  |port-JAX|/first  iters J/port
        0      2.513e-02   8.3e-16         8.3e-16           3 / 3
        1      1.119e-05   3.7e-10         1.7e-13           3 / 3
        2      1.540e-08   1.1e-06         7.0e-13           2 / 2
        3      7.891e-09   4.8e-07         1.5e-13           2 / 2
        4      7.886e-09   3.6e-06         1.1e-12           2 / 3
        5      7.886e-09   4.1e-06         1.3e-12           3 / 3

    Entries 0-1 are held to 1e-8 relative (27x above the larger reading).
    Entries 2-5 are norms of corrections 1e-6 to 3e-7 times the first, to
    an O(1) field: 1e-8 relative of them is 1e-16 of psi, below one f64
    rounding of psi itself, so no two orders of summation can agree there.
    They are held to 1e-11 of the FIRST entry, 8x above the largest
    reading (1.3e-12) and 2.5e-13 absolute = a thousand roundings of psi.
    Krylov counts: equal over the four contracting steps; entries 4-5 sit
    on the plateau where the target 1e-10*|r0| ~ 1e-22 is at the roundoff
    of the f64 operator and the last iteration is decided by summation
    order (read 2 vs 3): held to +-1."""
    jres, tres = f64_pair
    assert tres.geom.num_levels == jres.geom.num_levels == 2
    assert [b.shape for b in tres.geom.boxes] == [
        b.shape for b in jres.geom.boxes]
    jh, th = jres.dpsi_norm_history, tres.dpsi_norm_history
    print("f64 readings (entry, jax, rel diff, diff/first, iters):")
    for i, (t, j) in enumerate(zip(th, jh)):
        print(i, j, abs(t - j) / j, abs(t - j) / jh[0],
              jres.linear_iters[i], tres.linear_iters[i])
    assert tres.linear_iters[:4] == jres.linear_iters[:4]
    assert all(abs(t - j) <= 1 for t, j in
               zip(tres.linear_iters[4:], jres.linear_iters[4:]))
    assert len(th) == len(jh)
    for t, j in zip(th[:2], jh[:2]):
        assert t == pytest.approx(j, rel=1e-8)
    for t, j in zip(th[2:], jh[2:]):
        assert abs(t - j) <= 1e-11 * jh[0], (t, j)
    assert tres.converged == jres.converged
    assert tres.constant_K == jres.constant_K == 0.0


def test_two_level_f64_fields(f64_pair):
    jres, tres = f64_pair
    for t, j in zip(tres.psi, jres.psi):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-11)
    for t, j in zip(tres.dpsi, jres.dpsi):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-11)
    assert all(not p.requires_grad for p in tres.psi)


def test_average_down_history(f64_pair):
    """average_down = 1 on the same two-level BBH, f64 on both sides, 8
    Picard steps at most (the JAX package holds itself to the lower floor
    in tests/test_nonlinear.py::test_average_down_lowers_plateau).

    Readings of this test (printed below; 1 thread, x86-64 CPU):

        entry  JAX value   |port-JAX|/JAX  |port-JAX|/first  iters J/port
        0      2.513e-02   8.3e-16         8.3e-16           3 / 3
        1      3.779e-04   1.1e-11         1.6e-13           3 / 3
        2      9.489e-07   4.3e-09         1.6e-13           3 / 3
        3      8.787e-09   2.0e-06         6.9e-13           3 / 3
        4      3.702e-11   4.6e-04         6.8e-13           3 / 3

    Both converged at entry 4; the port's floor 3.70e-11 against 7.89e-9
    without average_down.

    Entries 0-1 are held to 1e-8 relative, the later ones to 1e-11 of the
    first entry (the rule of test_two_level_f64_history), Krylov counts
    equal while the history contracts and +-1 on a step that does not,
    `converged` equal. The port's floor with average_down must lie below
    0.2 of its floor without (f64_pair's port run)."""
    kw = small_bbh_kw(average_down=True, max_nl_iterations=8)
    jres = jnl.poisson_solve(JCfg(**kw), verbose=False)
    tres = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    jh, th = jres.dpsi_norm_history, tres.dpsi_norm_history
    print("average_down readings (entry, jax, rel diff, diff/first, iters):")
    for i, (t, j) in enumerate(zip(th, jh)):
        print(i, j, abs(t - j) / j, abs(t - j) / jh[0],
              jres.linear_iters[i], tres.linear_iters[i])
    assert len(th) == len(jh)
    for t, j in zip(th[:2], jh[:2]):
        assert abs(t - j) <= 1e-8 * j, (t, j)
    for t, j in zip(th[2:], jh[2:]):
        assert abs(t - j) <= 1e-11 * jh[0], (t, j)
    for i, (a, b) in enumerate(zip(tres.linear_iters, jres.linear_iters)):
        contracting = i == 0 or jh[i] <= 0.5 * jh[i - 1]
        assert a == b or (not contracting and abs(a - b) <= 1), (
            tres.linear_iters, jres.linear_iters)
    assert tres.converged == jres.converged
    floor = min(f64_pair[1].dpsi_norm_history)
    assert min(th) < 0.2 * floor, (min(th), floor)


def test_f32_preconditioner_plateau(f64_pair):
    """The Picard plateau without average_down under the f32
    preconditioner (precond_precision = single, the staged smoother on both
    sides), 6 steps, against the f64 plateau of f64_pair.

    Readings (1 thread, x86-64 CPU): plateau (entries 3-5) JAX 7.9715e-9,
    port 8.4280e-9, f64 7.8862e-9 on both sides (to 4e-6); flat to 1e-3 on
    both sides. The two f32 plateaus differ by 6 %; step 1 agrees to
    4.1e-9 relative, step 2 to 3.2e-5, step 3 to 2.7 %: the plateau is
    what the covered coarse cells, which no norm sees, carry from the first
    steps, and each f32 arithmetic rounds them its own way. Each f32 plateau is
    held within 15 % of the f64 one and flat to 1 %; entry 0 to 1e-8
    relative between JAX and the port. (On an H100 the 7-level plateau
    reads 1.3146e-7 with the kernels, 2.0187e-7 with the staged smoother
    and 1.8218e-7 at f64: scripts/records_probe.py.)"""
    kw = small_bbh_kw(precond_precision="single", smoother="xla")
    jres = jnl.poisson_solve(JCfg(**kw), verbose=False)
    tres = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    floor = f64_pair[0].dpsi_norm_history[3:]
    jh, th = jres.dpsi_norm_history, tres.dpsi_norm_history
    print("f32 plateau (entry, jax, port, f64):")
    for i, (j, t, f) in enumerate(zip(jh, th, f64_pair[0].dpsi_norm_history)):
        print(i, j, t, f)
    assert abs(th[0] - jh[0]) <= 1e-8 * jh[0]
    for h in (jh, th):
        plateau = h[3:]
        assert len(plateau) == 3 and max(plateau) <= 1.01 * min(plateau)
        assert all(abs(p - f) <= 0.15 * f for p, f in zip(plateau, floor))


def test_mixed_precision_kernel_path():
    """precond_precision = single, smoother = pallas on both sides (JAX:
    Pallas interpret mode; port: the kernels' plain versions).

    Readings of this test (printed below; 1 thread, x86-64 CPU): first
    entry 2.513e-02 on both sides, 8.1e-10 relative apart; second entry
    1.1195e-05, 4.3e-05 relative apart = 1.9e-08 of the first; Krylov
    counts 3, 3 on both sides.

    The first entry is held to 1e-8 relative (12x above the reading) and
    the counts to equality. The second is a 4e-4 times smaller correction
    computed from the first one's result, including its coarse cells under
    the fine level — cells outside the composite norm, which the Krylov
    solve therefore leaves at the f32 preconditioner's accuracy. Two f32
    implementations differ there by f32 rounding of the first correction
    (6e-8 of it), so the second entry is held to 1e-7 of the FIRST, 5x
    above the reading."""
    kw = small_bbh_kw(precond_precision="single", smoother="pallas",
                      max_nl_iterations=2)
    jres = jnl.poisson_solve(JCfg(**kw), verbose=False)
    kernel_counts.reset()
    tres = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    th, jh = tres.dpsi_norm_history, jres.dpsi_norm_history
    print("mixed readings (entry, jax, rel diff, diff/first, iters):")
    for i, (t, j) in enumerate(zip(th, jh)):
        print(i, j, abs(t - j) / j, abs(t - j) / jh[0],
              jres.linear_iters[i], tres.linear_iters[i])
    assert th[0] == pytest.approx(jh[0], rel=1e-8)
    assert abs(th[1] - jh[1]) <= 1e-7 * jh[0]
    assert th[1] < 1e-3 * th[0]
    assert tres.linear_iters == jres.linear_iters
    # the path went through the plain versions of the four kernels that
    # small levels take (the wavefront rung is for big levels on the card)
    plain = kernel_counts.PLAIN_CALLS
    assert all(plain[k] > 0 for k in ("gsrb_relax", "residual",
                                      "tower_down", "tower_up"))
    assert plain["wavefront_relax"] == 0


def test_nl_iteration_stages_match():
    """One Picard iteration from a non-trivial psi carried across as numpy:
    prepare_iteration (aCoef, rhs) to 1e-12, then the update."""
    kw = small_bbh_kw()
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jg = jhier(jcfg)
    tg = thier(tcfg, device="cpu")
    rng = np.random.default_rng(6)
    psi = [1.0 + 0.01 * rng.standard_normal(b.shape) for b in jg.boxes]
    jf = [jld.problem_fields(jg, jcfg, l) for l in range(2)]
    # the JAX fields carried across: identical inputs on both sides
    tf = cv.fields_from_numpy(
        [{k: ({c: np.asarray(x) for c, x in v.items()}
              if isinstance(v, dict) else np.asarray(v))
          for k, v in f.items()} for f in jf], "cpu")
    ja, jrhs, jk = jnl.prepare_iteration_jit(
        jg, jcfg, jf, [jnp.asarray(p) for p in psi])
    ta, trhs, tk = tnl.prepare_iteration(
        tg, tcfg, tf, cv.level_list_from_numpy(psi, "cpu"))
    assert float(tk) == float(jk) == 0.0
    for t, j in zip(ta + trhs, list(ja) + list(jrhs)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-12 * np.max(np.abs(j)))
    dpsi = [0.01 * rng.standard_normal(b.shape) for b in jg.boxes]
    for avg in (False, True):
        jp, jn = jnl.finish_iteration(
            jg, [jnp.asarray(p) for p in psi],
            [jnp.asarray(d) for d in dpsi], avg)
        tpsi = cv.level_list_from_numpy(psi, "cpu")
        tp, tn = tnl.finish_iteration(
            tg, tpsi, cv.level_list_from_numpy(dpsi, "cpu"), avg)
        assert float(tn) == pytest.approx(float(jn), rel=1e-13)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-14)
        for t, p in zip(tpsi, psi):  # inputs untouched
            np.testing.assert_array_equal(t.numpy(), p)


def test_periodic_constant_k():
    kw = dict(
        alpha=1.0, beta=-1.0, L=16.0, n_cells=(16, 16, 16), max_level=0,
        num_mg_smooth=4, num_mg_iterations=2, max_iterations=50,
        max_nl_iterations=2, tolerance=1e-10, is_periodic=True,
        bh1_bare_mass=0.0, bh2_bare_mass=0.0,
        bh1_momentum=0.05, bh2_momentum=-0.05,
        bh1_spin=0.05, bh2_spin=0.05,
        bh1_offset=2.0, bh2_offset=-2.0,
        phi_amplitude=0.02, phi_wavelength=1.0, verbosity=0,
    )
    jres = jnl.poisson_solve(JCfg(**kw), verbose=False)
    tres = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    assert tres.constant_K < 0.0
    assert tres.constant_K == pytest.approx(jres.constant_K, rel=1e-10)
    assert tres.dpsi_norm_history[0] == pytest.approx(
        jres.dpsi_norm_history[0], rel=1e-8)


def test_divergence_raises_and_hooks():
    kw = small_bbh_kw(
        max_level=0, n_cells=(8, 8, 8), bh1_bare_mass=0.0,
        bh2_bare_mass=0.0, bh1_momentum=0.0, bh2_momentum=0.0,
        bh1_spin=0.0, bh2_spin=0.0, phi_amplitude=60.0, phi_wavelength=4.0,
        max_nl_iterations=1, max_iterations=8,
    )
    with pytest.raises(tnl.NonConvergenceError):
        tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    seen = []
    kw = small_bbh_kw(max_level=0, max_nl_iterations=2)
    res = tnl.poisson_solve(
        TCfg(**kw), device="cpu", verbose=False,
        output_hook=lambda i, st: seen.append((i, sorted(st))))
    assert [i for i, _ in seen] == [0, 1]
    warm = tnl.poisson_solve(
        TCfg(**kw), device="cpu", verbose=False,
        initial_psi=[p.numpy() for p in res.psi])
    assert warm.dpsi_norm_history[0] < 1e-2 * res.dpsi_norm_history[0]
