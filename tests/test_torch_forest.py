"""The patches forest through the PyTorch port against the JAX package:
finish_iteration's average-down over sibling patches (the counterpart of
tests/test_forest.py::test_forest_average_down) and the nonlinear solve
with level_decomposition = patches end to end, with and without
average_down (tests/test_forest.py::test_patches_mode_bbh_end_to_end),
f64 on both sides; then the port's f32-preconditioned forest on the
kernels' plain versions against its own f64 solve."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid import tagging as jtag
from mg_ic_code_tpu.solver import nonlinear as jnl

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.grid import tagging as ttag
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops import stencils as tst
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import nonlinear as tnl

import chip_smoke
from tests.test_forest import two_patch_geom

torch.set_num_threads(1)


def plain(boxes) -> list:
    """Boxes as (lo, hi) pairs: the JAX package and the port each have a
    Box class of their own."""
    return [(b.lo, b.hi) for b in boxes]


def port_geom(jg):
    """The JAX HierarchyGeom carried to the port as plain data."""
    bc = jg.bc
    return cv.geom_from_plain(
        plain(jg.boxes), jg.parent, jg.dx,
        dict(bc_lo=bc.bc_lo, bc_hi=bc.bc_hi, bc_value=bc.bc_value,
             periodic=bc.periodic),
        plain(jg.domain_boxes), jg.domain_length, jg.ref_ratio)


def test_forest_average_down():
    """finish_iteration(average_down=True) on a base, two sibling patches
    and a grandchild in the first patch: psi + dpsi, then each child
    restricted into its own parent's covered slice, children before
    parents. The port equals JAX to f64 rounding (rtol 1e-15; the reading
    is bit for bit), and the grandchild reached the base through its
    patch."""
    jg = two_patch_geom(depth2=True)
    tg = port_geom(jg)
    assert tg.children(0) == jg.children(0) == (1, 2)
    assert tg.children(1) == (3,)
    rng = np.random.default_rng(21)
    psi = [1.0 + 0.1 * rng.standard_normal(jg.shape(e))
           for e in range(jg.num_levels)]
    dpsi = [0.01 * rng.standard_normal(jg.shape(e))
            for e in range(jg.num_levels)]
    jp, jn = jnl.finish_iteration(
        jg, [jnp.asarray(p) for p in psi], [jnp.asarray(d) for d in dpsi],
        average_down=True)
    tpsi = cv.level_list_from_numpy(psi, "cpu")
    tp, tn = tnl.finish_iteration(
        tg, tpsi, cv.level_list_from_numpy(dpsi, "cpu"), average_down=True)
    assert float(tn) == pytest.approx(float(jn), rel=1e-15)
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-15,
                                   atol=0)
    for t, p in zip(tpsi, psi):  # the caller's psi untouched
        np.testing.assert_array_equal(t.numpy(), p)
    # children before parents: patch 1 holds its grandchild's restriction
    # and the base holds the restriction of THAT patch 1
    new = [torch.from_numpy(p + d) for p, d in zip(psi, dpsi)]
    p1 = new[1].clone()
    p1[tg.child_slices(1, 3)] = tst.restrict_full(new[3])
    torch.testing.assert_close(tp[1], p1, rtol=0, atol=0)
    torch.testing.assert_close(tp[0][tg.child_slices(0, 1)],
                               tst.restrict_full(p1), rtol=0, atol=0)
    torch.testing.assert_close(tp[0][tg.child_slices(0, 2)],
                               tst.restrict_full(new[2]), rtol=0, atol=0)
    assert not torch.equal(tst.restrict_full(p1),
                           tst.restrict_full(new[1]))


def patches_kw(**kw):
    """tests/test_forest.py::test_patches_mode_bbh_end_to_end's
    configuration: two punctures 48 apart in a 64x16x16 box of side 64,
    one refined level that comes out as two sibling patches."""
    base = dict(
        alpha=1.0, beta=-1.0, L=64.0, n_cells=(64, 16, 16), max_level=1,
        num_mg_smooth=4, num_mg_iterations=2, max_iterations=40,
        max_nl_iterations=8, tolerance=1e-10,
        refine_threshold=0.25, block_factor=4, max_grid_size=8,
        bh1_bare_mass=0.5, bh2_bare_mass=0.5,
        bh1_offset=24.0, bh2_offset=-24.0,
        bh1_spin=0.0, bh2_spin=0.0, bh1_momentum=0.02, bh2_momentum=-0.02,
        phi_amplitude=0.0, phi_wavelength=1.0,
        level_decomposition="patches", verbosity=0,
    )
    base.update(kw)
    return base


RELAX = ("gsrb_relax", "wavefront_relax", "multisweep_relax")
RESIDUAL = ("residual", "residual_restrict")
# the card's configuration: the f32 preconditioner on the kernels (here their
# plain versions)
SINGLE = patches_kw(average_down=True, precond_precision="single",
                    smoother="pallas")


@pytest.fixture(scope="module")
def patches():
    """Each solve once: JAX and the port with and without average_down,
    the port's bbox run (first step only) and its f32-preconditioned
    forest on the kernels' plain versions."""
    out = {}
    for avg in (False, True):
        kw = patches_kw(average_down=avg)
        out[avg] = (jnl.poisson_solve(JCfg(**kw), verbose=False),
                    tnl.poisson_solve(TCfg(**kw), device="cpu",
                                      verbose=False))
    out["bbox"] = tnl.poisson_solve(
        TCfg(**patches_kw(level_decomposition="bbox", max_nl_iterations=1)),
        device="cpu", verbose=False)
    kernel_counts.reset()
    with chip_smoke.calls_by_shape(RELAX + RESIDUAL) as by_shape:
        out["single"] = tnl.poisson_solve(
            TCfg(**SINGLE), device="cpu", verbose=False)
    out["single_plain_calls"] = dict(kernel_counts.PLAIN_CALLS)
    out["single_by_shape"] = by_shape
    return out


def test_patches_geometry(patches):
    """generate_hierarchy gives the JAX package's forest box for box: the
    base and one patch around each puncture, siblings under the base."""
    cfg = TCfg(**patches_kw())
    tg = ttag.generate_hierarchy(cfg, device="cpu")
    jg = jtag.generate_hierarchy(JCfg(**patches_kw()))
    assert tg.num_levels == jg.num_levels == 3
    assert plain(tg.boxes) == plain(jg.boxes) and tg.parent == jg.parent
    assert plain(tg.domain_boxes) == plain(jg.domain_boxes)
    assert tg.dx == jg.dx
    assert tg.children(0) == (1, 2)
    assert tg.entries_at_depth(1) == (1, 2)
    for avg in (False, True):
        assert plain(patches[avg][1].geom.boxes) == plain(jg.boxes)


# the limit of a later entry's gap to JAX, over JAX's first entry (the rule
# of tests/test_torch_nonlinear.py)
LATER_OF_FIRST = 2e-10


@pytest.mark.parametrize("avg", [False, True], ids=["plain", "average_down"])
def test_patches_end_to_end(patches, avg):
    """The patches solve, f64 on both sides, 8 Picard steps at most.

    Readings of this test (printed below; 1 thread, x86-64 CPU):

        average_down = 0
        entry  JAX value   |port-JAX|/JAX  |port-JAX|/first  iters J/port
        0      4.832e-04   4.5e-16         4.5e-16           3 / 3
        1      7.310e-09   1.6e-06         2.4e-11           3 / 3
        2      9.981e-14   9.7e-03         2.0e-12           3 / 3

        average_down = 1
        0      4.832e-04   4.5e-16         4.5e-16           3 / 3
        1      7.835e-06   1.7e-09         2.8e-11           3 / 3
        2      4.335e-08   9.7e-08         8.7e-12           3 / 3
        3      3.103e-10   6.4e-05         4.1e-11           3 / 3
        4      1.639e-12   7.0e-03         2.4e-11           3 / 3

    Entries 0-1 are held to 1e-8 relative where 1e-8 of the entry is at
    least 1e-15, five f64 roundings of psi (~1). The plain run's entry 1
    (7.3e-9) is not: 1e-8 of it is 7e-17, a third of one rounding, so it
    is held with the later entries. The later entries are held to 2e-10 of the
    first entry. The largest reading, 4.1e-11 of the first, is 2.0e-14
    absolute, about a hundred roundings of psi: the same absolute gap as
    the bbox case of tests/test_torch_nonlinear.py (6.9e-13 of a first
    entry of 0.0251, 1.7e-14). The ratio of ~60 between the two relative
    readings is the ratio of the first entries (0.0251 against 4.83e-4),
    not a fault of the forest. Krylov counts equal while the
    history contracts, +-1 on a step that does not."""
    jres, tres = patches[avg]
    jh, th = jres.dpsi_norm_history, tres.dpsi_norm_history
    print(f"patches average_down={avg} (entry, jax, rel diff, diff/first, "
          f"iters):")
    for i, (t, j) in enumerate(zip(th, jh)):
        print(i, j, abs(t - j) / j, abs(t - j) / jh[0],
              jres.linear_iters[i], tres.linear_iters[i])
    assert plain(tres.geom.boxes) == plain(jres.geom.boxes)
    assert len(th) == len(jh)
    for i, (t, j) in enumerate(zip(th, jh)):
        if i < 2 and 1e-8 * j >= 1e-15:
            assert abs(t - j) <= 1e-8 * j, (i, t, j)
        else:
            assert abs(t - j) <= LATER_OF_FIRST * jh[0], (i, t, j)
    for i, (a, b) in enumerate(zip(tres.linear_iters, jres.linear_iters)):
        contracting = i == 0 or jh[i] <= 0.5 * jh[i - 1]
        assert a == b or (not contracting and abs(a - b) <= 1), (
            tres.linear_iters, jres.linear_iters)
    assert tres.converged == jres.converged
    assert min(th) < 1e-10
    # patches refine less than the bounding box, but the first step is the
    # same to leading order (tests/test_forest.py holds JAX to this)
    assert th[0] == pytest.approx(
        patches["bbox"].dpsi_norm_history[0], rel=0.02)


def test_average_down_on_patches(patches):
    """average_down acts after a step's norm is taken: the first step is
    the plain run's bit for bit, the second is not. At the end every
    sibling's covered slice of the base holds the restriction of that
    sibling, bit for bit."""
    ref, run = patches[False][1], patches[True][1]
    assert run.dpsi_norm_history[0] == ref.dpsi_norm_history[0]
    assert run.dpsi_norm_history[1] != ref.dpsi_norm_history[1]
    geom = run.geom
    for c in geom.children(0):
        torch.testing.assert_close(
            run.psi[0][geom.child_slices(0, c)],
            tst.restrict_full(run.psi[c]), rtol=0, atol=0)


def test_single_precision_forest(patches):
    """The card's configuration on the CPU: precond_precision = single and
    smoother = pallas (the kernels' plain versions) on the forest with
    average_down, against the port's f64 solve of the same forest.

    Readings (1 thread, x86-64 CPU):

        entry  f32 precond  f64          rel diff  iters f32 / f64
        0      4.832e-04    4.832e-04    5.6e-10   3 / 3
        1      7.835e-06    7.835e-06    3.1e-07   3 / 3
        2      4.335e-08    4.335e-08    4.4e-06   3 / 3
        3      3.103e-10    3.103e-10    2.1e-05   3 / 3
        4      1.640e-12    1.651e-12    6.2e-03   3 / 3

    Step 1 is held to 1e-5 relative (the limit of the card's 7-level lock);
    both converge, the f32 run within one Picard step more than the f64
    one; every kernel a small level takes ran (its plain version)."""
    ref, run = patches[True][1], patches["single"]
    h, hr = run.dpsi_norm_history, ref.dpsi_norm_history
    print("single (entry, f32 precond, f64, rel diff, iters):")
    for i, (a, b) in enumerate(zip(h, hr)):
        print(i, a, b, abs(a - b) / b, run.linear_iters[i],
              ref.linear_iters[i])
    assert abs(h[0] - hr[0]) <= 1e-5 * hr[0]
    assert run.converged and ref.converged
    assert len(h) <= len(hr) + 1
    calls = patches["single_plain_calls"]
    assert all(calls[k] > 0 for k in ("gsrb_relax", "residual",
                                      "residual_restrict", "tower_down",
                                      "tower_up"))
    assert calls["wavefront_relax"] == calls["multisweep_relax"] == 0


def test_smoke_script_counts_of_the_forest(patches):
    """chip_smoke.py holds the card's records runs to the relax and
    residual calls their hierarchy implies (relax_calls_of per level
    shape, residual_calls_of, each per preconditioner application, two an
    iteration of BiCGStab). The same forest on the CPU, on the kernels'
    plain versions, makes exactly those calls."""
    run = patches["single"]
    spec = tcomp.make_amr_spec(run.geom, TCfg(**SINGLE), device="cpu")
    apps = 2 * sum(run.linear_iters)
    want = {name: {k: n * apps for k, n in calls.items()}
            for name, calls in chip_smoke.relax_calls_of(spec).items()}
    by_shape = patches["single_by_shape"]
    assert want["gsrb_relax"]
    assert {name: by_shape[name] for name in RELAX} == want
    per = chip_smoke.residual_calls_of(spec)
    assert per == {"residual": 3 + 2, "residual_restrict": 2 * 2}
    for name in RESIDUAL:
        assert sum(by_shape[name].values()) == apps * per[name], name
