"""Forest batching of the PyTorch port against the JAX package: the same
batch groups (composite._sibling_batch_groups) for every policy, mesh and
forest; the batched V-cycle (`forest_batching = force`) against the JAX
package's and bit for bit against the port's own sequential one; the
(4, 2)-mesh solve with the pair spread over the patch axis against the
JAX package's serial solve; a patches-mode poisson_solve under force; the
batched wrappers' plain versions and launch geometry. The two-process
case is in tests/test_torch_processes.py. Inputs from numpy seeds, f64
unless a case says otherwise; each case states its tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.grid.boxes import Box
from mg_ic_code_tpu.grid.geometry import BCSpec as JBC, HierarchyGeom as JGeom
from mg_ic_code_tpu.parallel import mesh as jmesh
from mg_ic_code_tpu.solver import composite as jcomp

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.parallel import mesh as tmesh
from mg_ic_code_tpu_torch.parallel.shards import ShardSet
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import multigrid as tmg

import chip_smoke
from tests.test_forest import forest_cfg, two_patch_geom
from tests.test_torch_composite import export_coefs, sibling_forest

torch.set_num_threads(1)

ALL_C = (("cf", "cf"),) * 3


def port_geom(jg):
    plain = lambda bs: [(b.lo, b.hi) for b in bs]  # noqa: E731
    return cv.geom_from_plain(
        plain(jg.boxes), jg.parent, jg.dx,
        dict(bc_lo=jg.bc.bc_lo, bc_hi=jg.bc.bc_hi, bc_value=jg.bc.bc_value,
             periodic=jg.bc.periodic),
        plain(jg.domain_boxes), jg.domain_length)


def dryrun_forest():
    """The dry run's forest (entry.dryrun_multichip, the JAX package's
    __graft_entry__): a 64^3 base and two 32^3 patches."""
    dom0 = Box.from_shape((64, 64, 64))
    return JGeom(
        boxes=(dom0, Box.from_shape((32, 32, 32), lo=(8, 48, 48)),
               Box.from_shape((32, 32, 32), lo=(88, 48, 48))),
        domain_boxes=(dom0, dom0.refine(2), dom0.refine(2)),
        dx=(0.25, 0.125, 0.125), domain_length=(16.0,) * 3, bc=JBC(),
        parent=(-1, 0, 0))


FORESTS = {
    "two_patch_32_depth2": lambda: two_patch_geom(n=32, depth2=True),
    "two_patch_16": lambda: two_patch_geom(n=16),
    "dryrun_forest": dryrun_forest,
    "sibling_forest": lambda: sibling_forest()[0],
}
MESHES = {"none": None, "x4": (4,), "x8": (8,), "pencil_4x2": (4, 2)}


def meshes(shape):
    """(JAX mesh, the port's mesh of CPU positions) of `shape`."""
    if shape is None:
        return None, None
    devs = jax.devices()[:int(np.prod(shape))]
    jm = jmesh.make_mesh(devs, shape if len(shape) > 1 else None)
    return jm, cv.mesh_from_jax(jm, "cpu")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("forest", list(FORESTS))
@pytest.mark.parametrize("mode", ["off", "force", "auto"])
def test_batch_groups_match_jax(mode, forest, mesh_name):
    """AMRSolverSpec.batch_groups is the JAX package's, exactly, for every
    policy, forest and mesh."""
    jg = FORESTS[forest]()
    jm, tm = meshes(MESHES[mesh_name])
    kw = dict(n_cells=jg.boxes[0].shape, max_level=len(jg.boxes) - 1,
              forest_batching=mode)
    jspec = jcomp.make_amr_spec(jg, JCfg(**kw), jm)
    tspec = tcomp.make_amr_spec(port_geom(jg), TCfg(**kw), device="cpu",
                                mesh=tm)
    assert tspec.batch_groups == jspec.batch_groups
    if mode == "off":
        assert tspec.batch_groups == ()
    if mode == "force":
        assert tspec.batch_groups  # every forest has a pair


def test_patch_positions():
    """The positions of a batch group's chunks (mesh.patch_positions): on
    the axis patch_axis names (the JAX package's choice), chunk k at its
    coordinate k, 0 along the others; None without a usable axis."""
    mk = lambda shape: tmesh.make_mesh(  # noqa: E731
        ["cpu"] * int(np.prod(shape)), shape)
    assert tmesh.patch_positions(mk((4, 2)), 2) == (0, 1)
    assert tmesh.patch_positions(mk((4, 2)), 4) == (0, 0, 1, 1)
    assert tmesh.patch_positions(mk((2,)), 2) == (0, 1)
    assert tmesh.patch_positions(mk((4,)), 4) == (0, 1, 2, 3)
    assert tmesh.patch_positions(mk((4,)), 2) is None
    assert tmesh.patch_positions(mk((2, 1, 2)), 2) == (0, 2)


def forest_inputs(jg, seed=3):
    rng = np.random.default_rng(seed)
    a = [rng.uniform(0.5, 2.0, b.shape) for b in jg.boxes]
    r = [rng.standard_normal(b.shape) for b in jg.boxes]
    return a, r


def test_force_vcycle_matches_jax():
    """amr_vcycle under force (the pair in one batch, its grandchild on its
    own) against the JAX package's amr_vcycle_jit under force, the same
    coefficients: relative to each level's max |e|, 1e-13 (f64
    roundoff)."""
    jg = two_patch_geom(n=16, depth2=True)
    cfg = forest_cfg(n_cells=(16, 16, 16), max_level=2,
                     forest_batching="force")
    jspec = jcomp.make_amr_spec(jg, cfg)
    tspec = tcomp.make_amr_spec(port_geom(jg), TCfg(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(TCfg)}),
        device="cpu")
    assert tspec.batch_groups == jspec.batch_groups == ((1, 2),)
    a, r = forest_inputs(jg)
    jco = jcomp.build_coefs_jit(jspec, [jnp.asarray(x) for x in a])
    ref = jcomp.amr_vcycle_jit(jspec, jco, [jnp.asarray(x) for x in r])
    tco = cv.coefs_from_numpy(export_coefs(jco), "cpu")
    out = tcomp.amr_vcycle(tspec, tco, [torch.tensor(x) for x in r])
    for t, j in zip(out, ref):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-13 * np.abs(j).max())


PRECONDS = {
    "f64": dict(precond_precision="double"),
    "f32_staged": dict(precond_precision="single", smoother="xla"),
    "f32_kernels": dict(precond_precision="single", smoother="pallas"),
}


@pytest.mark.parametrize("prec", list(PRECONDS))
def test_force_equals_off_bitwise(prec):
    """The preconditioner (two AMR V-cycles) under force is the one under
    off bit for bit: f64 (the staged body on the stacked pair), the f32
    set through the staged body and through the kernels' batched plain
    versions (one batched call where off makes two single ones)."""
    jg = two_patch_geom(n=16, depth2=True)
    tg = port_geom(jg)
    a, r = forest_inputs(jg, seed=5)
    out, calls = {}, {}
    for mode in ("off", "force"):
        cfg = TCfg(alpha=1.0, beta=-1.0, n_cells=(16, 16, 16), max_level=2,
                   num_mg_smooth=4, num_mg_iterations=2,
                   forest_batching=mode, **PRECONDS[prec])
        spec = tcomp.make_amr_spec(tg, cfg, device="cpu")
        coefs = tcomp.build_coefs(spec, [torch.tensor(x) for x in a])
        kernel_counts.reset()
        out[mode] = tcomp.precond(spec, coefs, [torch.tensor(x) for x in r])
        calls[mode] = dict(kernel_counts.PLAIN_CALLS)
    assert all(torch.equal(x, y) for x, y in zip(out["off"], out["force"]))
    if prec == "f32_kernels":
        # per V-cycle: the pair's two relaxes and one restriction batched
        assert calls["force"]["gsrb_relax_batch"] == 2 * 2
        assert calls["force"]["residual_restrict_batch"] == 2
        assert calls["off"]["gsrb_relax"] - calls["force"]["gsrb_relax"] \
            == 2 * 2 * 2
    else:
        assert calls["force"]["gsrb_relax_batch"] == 0


def mesh_forest_run(mesh, **over):
    """composite.solve_linear of the JAX test's forest on `mesh` (None:
    one position): spec, solution (joined), Krylov count, HALO counts of
    the build and of the solve, launches."""
    jg = two_patch_geom(n=16)
    cfg = forest_cfg(n_cells=(16, 16, 16))
    tcfg = TCfg(**{**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TCfg)}, **over})
    spec = tcomp.make_amr_spec(port_geom(jg), tcfg, device="cpu", mesh=mesh)
    a, r = forest_inputs(jg, seed=11)
    pa = tcomp.place(spec, [torch.tensor(x) for x in a])
    pr = tcomp.place(spec, [torch.tensor(x) for x in r])
    kernel_counts.reset()
    coefs = tcomp.build_coefs(spec, pa)
    build = dict(kernel_counts.HALO)
    kernel_counts.reset()
    out = tcomp.solve_linear(spec, coefs, pr)
    solve = kernel_counts.snapshot()
    x = [v.join() if isinstance(v, ShardSet) else v for v in out.x]
    return dict(spec=spec, coefs=coefs, x=x, iters=int(out.iters),
                build=build, solve=solve, a=a, r=r, jg=jg, cfg=cfg)


def test_mesh_solve_matches_jax_serial():
    """The (4, 2) CPU mesh under auto: the pair (which no axis cuts) is
    one batch group, its chunks computed at positions (0, 0) and (0, 1)
    with their coefficients placed there once per build; the solve
    against the JAX package's serial solve to rtol 1e-9 / atol 1e-11 (its
    test_forest.py tolerance), and the HALO counts of the build and the
    solve what chip_smoke.forest_halo_want derives from the placement."""
    mesh = tmesh.make_mesh(["cpu"] * 8, (4, 2))
    run = mesh_forest_run(mesh)
    spec, coefs = run["spec"], run["coefs"]
    assert spec.batch_groups == ((1, 2),)
    assert tcomp.batch_positions(spec, (1, 2)) == (
        mesh.position_at({"x": 0, "y": 0}), mesh.position_at({"y": 1}))
    assert all("at" in coefs[x] for x in (1, 2))
    jspec = jcomp.make_amr_spec(run["jg"], run["cfg"])
    jco = jcomp.build_coefs_jit(jspec, [jnp.asarray(x) for x in run["a"]])
    ref = jcomp.solve_linear_jit(
        jspec, jco, [jnp.asarray(x) for x in run["r"]],
        [jnp.zeros(b.shape) for b in run["jg"].boxes])
    assert bool(ref.converged)
    for t, j in zip(run["x"], ref.x):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9,
                                   atol=1e-11)
    build, solve = chip_smoke.forest_halo_want(spec, run["iters"], "cpu")
    assert {k: run["build"][k] for k in build} == build
    assert {k: run["solve"]["halo"][k] for k in solve} == solve
    assert build["patch_moves"] == 1 and solve["patch_moves"] > 0


def test_mesh_batch_is_bit_for_bit_sequential():
    """On the (4, 2) mesh with the f32 preconditioner on the kernels'
    plain versions: auto (the pair batched at its two positions) is off
    (the pair one after the other on the home) bit for bit; the batched
    calls are one per position per relax and restriction."""
    mesh = tmesh.make_mesh(["cpu"] * 8, (4, 2))
    kw = dict(precond_precision="single", smoother="pallas")
    auto = mesh_forest_run(mesh, **kw)
    off = mesh_forest_run(mesh, forest_batching="off", **kw)
    assert auto["iters"] == off["iters"]
    assert all(torch.equal(a, b) for a, b in zip(auto["x"], off["x"]))
    apps = 2 * auto["iters"]
    plain = auto["solve"]["plain_calls"]
    per = chip_smoke.relax_calls_of(auto["spec"])["gsrb_relax_batch"]
    assert plain["gsrb_relax_batch"] == apps * sum(per.values()) > 0
    assert plain["residual_restrict_batch"] == apps * \
        chip_smoke.residual_calls_of(auto["spec"])["residual_restrict_batch"]
    assert off["solve"]["plain_calls"]["gsrb_relax_batch"] == 0
    build, solve = chip_smoke.forest_halo_want(auto["spec"], auto["iters"],
                                               "cpu")
    assert build["patch_moves"] == 2  # the f64 set and the f32 one
    assert {k: auto["solve"]["halo"][k] for k in solve} == solve


def test_patches_poisson_solve_force_matches_jax():
    """A patches-mode poisson_solve (tests/test_forest.py's two-puncture
    box, max_level 1, 3 Picard steps) under force against the JAX
    package's under force: the same batch group and Krylov counts, the
    history held as tests/test_torch_forest.py holds the sequential one
    (its first entry to 1e-8 relative, the later ones, at the Krylov
    tolerance, to 2e-10 of the first)."""
    from mg_ic_code_tpu.solver import nonlinear as jnl
    from mg_ic_code_tpu_torch.solver import nonlinear as tnl
    from tests.test_torch_forest import patches_kw

    kw = patches_kw(forest_batching="force", max_nl_iterations=3)
    jres = jnl.poisson_solve(JCfg(**kw), verbose=False)
    kernel_counts.reset()
    tres = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    spec = tcomp.make_amr_spec(tres.geom, TCfg(**kw), device="cpu")
    assert spec.batch_groups == ((1, 2),)
    assert tres.linear_iters == jres.linear_iters
    th, jh = tres.dpsi_norm_history, jres.dpsi_norm_history
    assert len(th) == len(jh) == 3
    assert abs(th[0] - jh[0]) <= 1e-8 * jh[0]
    for t, j in zip(th[1:], jh[1:]):
        assert abs(t - j) <= 2e-10 * jh[0], (th, jh)


def test_batched_wrappers_on_the_cpu():
    """gsrb_relax_batch and residual_restrict_batch on CPU tensors: their
    plain versions, each patch bit for bit the single wrapper's (and the
    restricted residual into each patch's own parent slice); one plain
    call per batched call."""
    rng = np.random.default_rng(2)
    shape, los = (8, 10, 12), ((1, 2, 3), (5, 2, 3), (1, 4, 5))
    us, rhss, as_ = ([torch.tensor(rng.standard_normal(shape))
                      for _ in los] for _ in range(3))
    as_ = [1.0 + 0.5 * a.abs() for a in as_]
    kw = dict(kinds=ALL_C, rho=2.0, alpha=1.0, beta=-1.0, dx=0.3)
    kernel_counts.reset()
    out = tfs.gsrb_relax_batch(us, rhss, as_, nsweeps=3, los=los, **kw)
    assert kernel_counts.PLAIN_CALLS["gsrb_relax_batch"] == 1
    for o, u, r, a, lo in zip(out, us, rhss, as_, los):
        assert torch.equal(o, tfs.gsrb_relax(u, r, a, nsweeps=3, lo=lo,
                                             **kw))
    parents = [torch.zeros((6, 7, 8), dtype=torch.float64) for _ in los]
    views = [p[1:5, 2:7, 1:7] for p in parents]
    rc = tfs.residual_restrict_batch(us, rhss, as_, outs=views, **kw)
    assert kernel_counts.PLAIN_CALLS["residual_restrict_batch"] == 1
    for v, o, u, r, a in zip(views, rc, us, rhss, as_):
        assert o is v
        assert torch.equal(v, tfs.residual_restrict(u, r, a, **kw))


@pytest.mark.parametrize("kind", ["staged", "kernels"])
def test_relax_batch_is_relax_per_patch(kind):
    """multigrid.relax_batch / residual_restrict_batch give each patch bit
    for bit what relax / residual_restrict_homog give it alone: the
    staged body on the stacked patches (f64), the kernels' batched plain
    versions (f32, smoother = pallas)."""
    dtype = torch.float64 if kind == "staged" else torch.float32
    smoother = "xla" if kind == "staged" else "pallas"
    rng = np.random.default_rng(8)
    shape = (8, 12, 12)
    specs = [tmg.LevelMGSpec(
        kinds=ALL_C, boxes=(Box.from_shape(shape, lo),), dx=(0.1,),
        rho=(2.0,), alpha=1.0, beta=-1.0, nsmooth=4, smoother=smoother)
        for lo in ((4, 10, 10), (20, 10, 10))]
    cos = [tmg.build_level_coefs(s, torch.tensor(
        rng.uniform(0.5, 2.0, shape), dtype=dtype)) for s in specs]
    us = [torch.tensor(rng.standard_normal(shape), dtype=dtype)
          for _ in specs]
    rs = [torch.tensor(rng.standard_normal(shape), dtype=dtype)
          for _ in specs]
    out = tmg.relax_batch(specs, cos, 0, us, rs, 4)
    rc = tmg.residual_restrict_batch(specs, cos, 0, out, rs)
    for s, c, u, r, o, q in zip(specs, cos, us, rs, out, rc):
        one = tmg.relax(s, c, 0, u, r, 4)
        assert torch.equal(o, one)
        assert torch.equal(q, tmg.residual_restrict_homog(s, c, 0, one, r))


def test_batch_launch_geometry():
    """The batched launches' geometry: gsrb_geometry for P patches is one
    patch's at capacity // P (raising where P exceeds the capacity), or,
    where the P patches' arrays overflow the L2 that one patch's fit, the
    serial form: one patch's grid form at the whole capacity (never for
    one level); residual_geometry's segments fill one wave for all P
    patches' tiles."""
    cap = 132
    one = tfs.gsrb_geometry((144, 144, 144), 8, False, ALL_C, cap // 2)
    pair = tfs.gsrb_geometry((144, 144, 144), 8, False, ALL_C, cap,
                             patches=2)
    assert pair == one and pair.form == "grid" and pair.blocks <= cap // 2
    serial = tfs.gsrb_geometry((144, 144, 144), 4, False, ALL_C, cap,
                               patches=2)
    assert serial == tfs.gsrb_geometry((144, 144, 144), 4, False, ALL_C,
                                       cap)._replace(form="serial")
    small = tfs.gsrb_geometry((72, 80, 80), 4, False, ALL_C, cap, patches=2)
    assert small.form == "slab" and small.blocks <= cap // 2
    with pytest.raises(ValueError):
        tfs.gsrb_geometry((16, 16, 16), 4, False, ALL_C, 4, patches=5)
    with pytest.raises(ValueError):
        tfs.gsrb_geometry((16, 16, 16), 4, False, ALL_C, cap, "serial")
    per_sm = lambda threads, smem: 2  # noqa: E731
    g1 = tfs.residual_geometry((144, 144, 144), 4, 4, True, True, False,
                               132, per_sm)
    g2 = tfs.residual_geometry((144, 144, 144), 4, 4, True, True, False,
                               132, per_sm, patches=2)
    assert (g2.ty, g2.ntiles) == (g1.ty, g1.ntiles)
    assert 2 * g2.ntiles * g2.nseg <= 2 * 132 < 2 * g1.ntiles * g1.nseg


def test_batch_constants_agree_with_the_sources():
    """The most patches one batched launch takes (kMaxBatch of both
    kernels' sources) is fused_sweeps.BATCH_MAX; the serial form's code is
    GSRB_FORMS'."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(tfs.__file__), "..", "csrc")
    for name in ("gsrb_relax.cu", "residual.cu"):
        with open(os.path.join(csrc, name)) as f:
            src = f.read()
        got = re.search(r"constexpr int kMaxBatch = (\d+);", src).group(1)
        assert int(got) == tfs.BATCH_MAX, name
    with open(os.path.join(csrc, "gsrb_relax.cu")) as f:
        assert int(re.search(r"FORM_SERIAL = (\d+)", f.read()).group(1)) \
            == tfs.GSRB_FORMS["serial"]


def test_smoke_script_forest_on_a_cpu_mesh():
    """chip_smoke.py's check of the JAX test's forest on a mesh (sharded
    phase: forest_on_mesh) on a (4, 2) mesh of CPU positions: the batch
    group at (0, 0) / (0, 1), f64 within rtol 1e-9 / atol 1e-11 of the
    solve without a mesh, f32 (the kernels' plain versions) bit for bit
    forest_batching = off, HALO and batched calls what the placement
    implies; and its processes check on one process, against itself."""
    rec = chip_smoke.forest_on_mesh(
        tmesh.make_mesh(["cpu"] * 8, (4, 2)), None, "cpu forest")
    assert rec["batch_groups"] == [[1, 2]] and rec["positions"] == [0, 1]
    assert rec["f32"]["bit_for_bit_off"]
    mesh = chip_smoke.forest_process_mesh(tmesh.make_mesh(["cpu"] * 4))
    one = chip_smoke.forest_record(chip_smoke.forest_solve(
        mesh, precond_precision="single", smoother="pallas"))
    assert one["positions"] == (0, 2) and one["iters"] > 0
