"""The sharded solve resident on its shards from placement to the result:
every level the mesh cuts is a parallel/shards.ShardSet through the Picard
loop (the state, the physics fields, aCoef, rhs, every Krylov vector), the
f64 composite operator with its coarse-fine term, the reductions,
finish_iteration's average_down and the writers' tiles work shard by
shard, and one level reads or writes another's part by level windows.

The port runs with device="cpu" on meshes of `cpu` entries; JAX on the 8
virtual CPU devices of tests/conftest.py, in f64. Tolerances:
  * histories 1e-10 of their first entry, Krylov counts equal, psi 1e-10
    relative (+ 1e-12 absolute) against the JAX package's sharded solve and
    the port's unsharded one (the limits of
    tests/test_torch_parallel.py::test_sharded_bbh_two_picard_iterations);
  * the composite operator, the inhomogeneous ghost fill, average_down and
    the writers' tiles: bit for bit the whole level's;
  * the reductions: the maximum exactly, the sums reassociated by the
    per-shard partials within 1e-15 relative (read: at most 4.0e-16);
  * entry.dryrun_multichip's dpsi norm against the JAX package's
    full_step: 1e-10 relative (read: equal to the last bit).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from mg_ic_code_tpu.config import SolverConfig as JCfg
from mg_ic_code_tpu.parallel import mesh as jmesh
from mg_ic_code_tpu.solver import nonlinear as jnl

import chip_smoke
from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.io import chombo_hdf5 as chio
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops.ghosts import fill_ghosts
from mg_ic_code_tpu_torch.parallel import distributed as tdist
from mg_ic_code_tpu_torch.parallel import mesh as tmesh
from mg_ic_code_tpu_torch.parallel.shards import ShardSet
from mg_ic_code_tpu_torch.physics import level_data as tld
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import multigrid as tmg
from mg_ic_code_tpu_torch.solver import nonlinear as tnl
from mg_ic_code_tpu_torch.solver import reductions as tred
from mg_ic_code_tpu_torch.solver.bicgstab import bicgstab

from tests.test_forest import two_patch_geom
from tests.test_torch_forest import patches_kw, port_geom
from tests.test_torch_nonlinear import small_bbh_kw
from tests.test_torch_resident_shards import (
    cfg_kw, hierarchy, placed_as_cut,
)

torch.set_num_threads(1)

MESHES = {"x4": (4, None), "pencil_2x2": (4, (2, 2))}
BCS = {"dirichlet": dict(bc_value=0.3),
       "mixed": dict(bc_lo=(1, 0, 1), bc_hi=(0, 1, 0), bc_value=0.3),
       "periodic": dict(periodic=True)}


def _rng(seed):
    return np.random.default_rng(seed)


def mesh_of(name):
    n, shape = MESHES[name]
    return tmesh.make_mesh(["cpu"] * n, shape)


def whole(x):
    """A placed level (or a list of them) whole again."""
    if isinstance(x, list):
        return [whole(v) for v in x]
    return x.join() if isinstance(x, ShardSet) else x


def hier(bc: str):
    """The port's geometry of test_torch_resident_shards.hierarchy (a 32^3
    base, one 32x16x16 level whose covered part x 8..23 straddles the seam
    at 16 of the base's x-slabs) with the named boundary conditions."""
    jg, _ = hierarchy(BCS[bc].get("periodic", False))
    b = jg.bc
    kw = dict(bc_lo=b.bc_lo, bc_hi=b.bc_hi, bc_value=0.0,
              periodic=b.periodic)
    kw.update(BCS[bc])
    plain = lambda bs: [(x.lo, x.hi) for x in bs]  # noqa: E731
    return cv.geom_from_plain(plain(jg.boxes), jg.parent, jg.dx, kw,
                              plain(jg.domain_boxes), jg.domain_length)


def face_geom():
    """A periodic 32^3 base with a 24x32x32 level at the high x face of
    the domain: its CF face there takes its coarse plane from the far side
    of the parent (cf_interp's wrap), uncut under 4 cut x-slabs and cut on
    (2, 2) pencils."""
    from mg_ic_code_tpu_torch.grid.boxes import Box
    from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom

    dom0 = Box.from_shape((32, 32, 32))
    return HierarchyGeom(
        boxes=(dom0, Box((40, 16, 16), (63, 47, 47))),
        domain_boxes=(dom0, dom0.refine(2)), dx=(1 / 32, 1 / 64),
        domain_length=(1.0,) * 3, bc=BCSpec(periodic=True), parent=(-1, 0))


GEOMS = {**{bc: functools.partial(hier, bc) for bc in BCS},
         "periodic_face": face_geom}


def specs(geom, mesh, **kw):
    """(spec without a mesh, spec with it) of the composite solver."""
    cfg = TCfg(**cfg_kw(**kw))
    return (tcomp.make_amr_spec(geom, cfg, "cpu"),
            tcomp.make_amr_spec(geom, cfg, "cpu", mesh))


def levels(geom, seed, lo=-1.0, hi=1.0):
    return [torch.from_numpy(_rng(seed + l).uniform(lo, hi, b.shape))
            for l, b in enumerate(geom.boxes)]


# ------------------------------------------ the Picard loop against JAX


BBH = small_bbh_kw(max_level=1, max_nl_iterations=2, n_cells=(32, 16, 16))


@pytest.fixture(scope="module")
def bbh_runs():
    """The two-level BBH (a 32x16x16 base: 4 x-slabs and (2, 2) pencils
    cut both levels), two Picard iterations with the psi after the first
    kept by the output hook: the JAX package on each mesh, the port
    unsharded and on each mesh."""
    def keep(store, nl_iter, state):
        if nl_iter == 1:
            store["psi1"] = whole(list(state["psi"]))

    out = {}
    store: dict = {}
    out["port"] = (tnl.poisson_solve(
        TCfg(**BBH), device="cpu", verbose=False,
        output_hook=functools.partial(keep, store)), store)
    for name, (n, shape) in MESHES.items():
        jstore: dict = {}
        jm = jmesh.make_mesh(jax.devices()[:n], shape)
        jres = jnl.poisson_solve(
            JCfg(**BBH), mesh=jm, verbose=False,
            output_hook=lambda i, s: jstore.update(
                psi1=[np.asarray(p) for p in s["psi"]]) if i == 1 else None)
        tstore: dict = {}
        kernel_counts.reset()
        tres = tnl.poisson_solve(
            TCfg(**BBH), device="cpu", verbose=False, mesh=mesh_of(name),
            output_hook=functools.partial(keep, tstore))
        out[name] = (jres, jstore, tres, tstore)
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_picard_matches_jax_and_unsharded(bbh_runs, mesh_name,
                                                  iters):
    """One and two Picard iterations on the mesh against the JAX
    package's sharded solve and the port's unsharded run: the history to
    1e-10 of its first entry, Krylov counts equal, psi to 1e-10; every
    level of the 32x16x16 base is cut, so the whole loop ran on shards and
    the result came back whole."""
    jres, jstore, tres, tstore = bbh_runs[mesh_name]
    plain, pstore = bbh_runs["port"]
    spec = tcomp.make_amr_spec(tres.geom, TCfg(**BBH), "cpu",
                               mesh_of(mesh_name))
    assert all(tmg._shard_counts(ls, 0) != (1, 1, 1)
               for ls in spec.level_specs)
    assert all(isinstance(p, torch.Tensor) for p in tres.psi + tres.dpsi)
    for ref in (jres, plain):
        h, r = tres.dpsi_norm_history[:iters], ref.dpsi_norm_history[:iters]
        np.testing.assert_allclose(h, r, rtol=0, atol=1e-10 * r[0])
        assert tres.linear_iters[:iters] == list(ref.linear_iters[:iters])
    psi = {1: (tstore["psi1"], jstore["psi1"], pstore["psi1"]),
           2: (tres.psi, jres.psi, plain.psi)}[iters]
    for ours, theirs, unsharded in zip(*psi):
        _close(ours, theirs)
        _close(ours, unsharded)


# ------------------------------------------- the composite operator, bitwise


@pytest.mark.parametrize("homogeneous", [True, False],
                         ids=["homogeneous", "inhomogeneous"])
@pytest.mark.parametrize("bc", list(GEOMS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_composite_apply_on_shards_is_bitwise(mesh_name, bc, homogeneous):
    """composite_apply on the placed levels, joined, equals the whole
    levels' bit for bit: x-slabs and pencils, Dirichlet (with a face
    value), mixed Neumann / Dirichlet and periodic boxes, the refined level
    straddling a seam of its cut parent, and a periodic level at the
    domain face whose CF plane wraps (whole under a cut parent on x-slabs);
    homogeneous (the Krylov form: the one-ring exchange and the CF coarse
    term by a window) and not (the initial residual's QuadCFInterp fill on
    the shards); with the f32 set too."""
    geom = GEOMS[bc]()
    plain, sharded = specs(geom, mesh_of(mesh_name))
    a, u = levels(geom, 3, 0.5, 2.0), levels(geom, 5)
    for use_lp in (False, True):
        kw = dict(homogeneous_phys=homogeneous, use_lp=use_lp)
        ref = tcomp.composite_apply(plain, tcomp.build_coefs(plain, a), u,
                                    **kw)
        pa = tcomp.place(sharded, a)
        out = tcomp.composite_apply(sharded, tcomp.build_coefs(sharded, pa),
                                    tcomp.place(sharded, u), **kw)
        placed_as_cut(sharded, out)
        for x, y in zip(whole(out), ref):
            assert torch.equal(x, y)


@pytest.mark.parametrize("bc", list(BCS))
def test_inhomogeneous_ghosts_on_shards(bc):
    """fill_ghosts (QuadCFInterp from a cut parent, physical values with
    the Dirichlet shift of ghosted_psi) on the refined level's shards: every
    face ghost the whole level's bit for bit, on pencils, where each shard
    reads its faces' parent planes from the window."""
    geom = hier(bc)
    _, sharded = specs(geom, mesh_of("pencil_2x2"))
    u = levels(geom, 7)
    placed = tcomp.place(sharded, u)
    ref = fill_ghosts(u[1], geom, 1, coarse_u=u[0], dirichlet_shift=1.0)
    gh = fill_ghosts(placed[1], geom, 1, coarse_u=placed[0],
                     dirichlet_shift=1.0)
    I = slice(1, -1)
    for k, g in gh.shards.items():
        org = gh.origin(k)
        sl = tuple(slice(o, o + n + 2) for o, n in zip(org, gh.n_loc))
        for axis in range(3):
            for side in (0, -1):
                face = [I, I, I]
                face[axis] = side
                assert torch.equal(g[tuple(face)], ref[sl][tuple(face)])
        assert torch.equal(g[I, I, I], ref[sl][I, I, I])


def test_whole_only_paths_refuse_a_cut_level():
    """A cut level handed to a path that takes whole levels only raises:
    the whole-level ghost fill, the bottom solve, and a composite entry
    point handed whole levels where the mesh cuts them. gather_global is
    collective, as the JAX package's: it gathers a cut level whole (one
    level join) rather than refuse it."""
    geom = hier("dirichlet")
    _, sharded = specs(geom, mesh_of("x4"))
    u = tcomp.place(sharded, levels(geom, 9))
    ls = sharded.level_specs[0]
    with pytest.raises(TypeError):
        tmg._ghost(ls, 0, u[0])
    np.testing.assert_array_equal(tdist.gather_global(u[0]),
                                  u[0].join().numpy())
    with pytest.raises(ValueError):
        tcomp.build_coefs(sharded, levels(geom, 3, 0.5, 2.0))
    with pytest.raises(ValueError):
        tcomp.precond(sharded, None, whole(u))


# ------------------------------------------------- Krylov vectors on shards


def test_shard_sets_as_krylov_vectors():
    """add, sub, scale, axpy and zeros like, a 0-d scalar moved to each
    shard's device, and BiCGStab on a list of shard sets: the same
    recurrence on the whole levels (bit for bit but for the reductions'
    reassociated sums: 1e-13)."""
    geom = hier("dirichlet")
    plain, sharded = specs(geom, mesh_of("pencil_2x2"))
    x, y = levels(geom, 11), levels(geom, 13)
    px, py = tcomp.place(sharded, x), tcomp.place(sharded, y)
    a = torch.tensor(0.37, dtype=torch.float64)
    for f in (lambda p, q: p + q, lambda p, q: p - q,
              lambda p, q: a * p + q, lambda p, q: p * a - 2.0 * q,
              lambda p, q: 3.0 * p - a):
        for got, want in zip(whole([f(p, q) for p, q in zip(px, py)]),
                             [f(p, q) for p, q in zip(x, y)]):
            assert torch.equal(got, want)
    z = px[0].zeros_like()
    assert isinstance(z, ShardSet) and not whole(z).any()
    assert torch.equal(whole(px[0].axpy(2.0, py[0])), x[0] + 2.0 * y[0])

    cp = tcomp.build_coefs(plain, levels(geom, 3, 0.5, 2.0))
    cs = tcomp.build_coefs(sharded, tcomp.place(sharded, levels(
        geom, 3, 0.5, 2.0)))
    dot = functools.partial(tred.composite_dot, geom=geom)
    norm = functools.partial(tred.composite_max_norm, geom=geom)
    ref = bicgstab(functools.partial(tcomp.composite_apply, plain, cp), y,
                   dot_fn=dot, norm_fn=norm, max_iter=3)
    got = bicgstab(functools.partial(tcomp.composite_apply, sharded, cs),
                   py, dot_fn=dot, norm_fn=norm, max_iter=3)
    assert got.iters == ref.iters == 3
    for g, r in zip(whole(got.x), ref.x):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-13,
                                   atol=1e-13 * float(r.abs().max()))


@pytest.mark.parametrize("prec", ["double", "single"])
def test_cut_bottom_depth(prec):
    """A level whose only depth is the bottom and is cut (16x4x4 on two
    x-slabs, the dense inverse): its coefficients are joined for the
    inverse and cut again for the sharded ops, the bottom solve takes it
    whole, and the counts are shard_coef_builds_of's and
    shard_traffic_of's; the preconditioner the unsharded one's (f64 1e-12;
    the f32 kernels' plain versions 1e-6)."""
    from mg_ic_code_tpu_torch.grid.geometry import BCSpec, single_level_geom

    geom = single_level_geom((16, 4, 4), 1.0, BCSpec())
    plain, sharded = specs(
        geom, tmesh.make_mesh(["cpu"] * 2), n_cells=(16, 4, 4),
        max_level=0, precond_precision=prec,
        smoother="pallas" if prec == "single" else "xla")
    ls = sharded.level_specs[0]
    assert ls.ndepths == 1 and tmg._use_direct_bottom(ls)
    assert tmg._shard_counts(ls, 0) == (2, 1, 1)
    a, r = levels(geom, 3, 0.5, 2.0), levels(geom, 5)
    pa, pr = tcomp.place(sharded, a), tcomp.place(sharded, r)
    kernel_counts.reset()
    coefs = tcomp.build_coefs(sharded, pa)
    build = kernel_counts.snapshot()["halo"]
    kernel_counts.reset()
    out = tcomp.precond(sharded, coefs, pr)
    app = kernel_counts.snapshot()["halo"]
    for want, got in ((chip_smoke.shard_coef_builds_of(sharded, "cpu"),
                       build), (chip_smoke.shard_traffic_of(sharded), app)):
        assert {k: got[k] for k in want} == want
    ref = tcomp.precond(plain, tcomp.build_coefs(plain, a), r)[0]
    tol = 1e-12 if prec == "double" else 1e-6
    np.testing.assert_allclose(whole(out)[0].numpy(), ref.numpy(), rtol=0,
                               atol=tol * float(ref.abs().max()))


# ------------------------------------------------------------ reductions


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_reductions_on_shards(mesh_name):
    """composite_dot, composite_norm, composite_max_norm, composite_sum and
    mask_covered on the placed levels against the whole levels: masks and
    maxima exact, the sums within 1e-15 relative (the per-shard partials
    added at the home in key order; read: at most 4.0e-16), and the same
    bits in two runs."""
    geom = hier("dirichlet")
    _, sharded = specs(geom, mesh_of(mesh_name))
    u, v = levels(geom, 15), levels(geom, 17)
    pu, pv = tcomp.place(sharded, u), tcomp.place(sharded, v)
    for x, y in zip(whole(tred.mask_covered(pu, geom, fill=7.0)),
                    tred.mask_covered(u, geom, fill=7.0)):
        assert torch.equal(x, y)
    assert torch.equal(tred.composite_max_norm(pu, geom),
                       tred.composite_max_norm(u, geom))
    pairs = [(tred.composite_dot(pu, pv, geom),
              tred.composite_dot(u, v, geom)),
             (tred.composite_norm(pu, geom), tred.composite_norm(u, geom)),
             (tred.composite_sum(pu, geom), tred.composite_sum(u, geom))]
    for got, want in pairs:
        assert abs(float(got) - float(want)) <= 1e-15 * abs(float(want))
    assert torch.equal(tred.composite_dot(pu, pv, geom), pairs[0][0])


# ------------------------------------------------------- finish_iteration


FORESTS = {"straddle": lambda: hier("dirichlet"),
           "two_patches": lambda: port_geom(two_patch_geom(depth2=True))}


@pytest.mark.parametrize("forest", list(FORESTS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_finish_iteration_average_down_on_shards(mesh_name, forest):
    """finish_iteration(average_down=True): psi + dpsi and every child's
    restriction written into its parent's covered part by a window, bit for
    bit the whole levels' (the forest's patches are whole under the cut
    base on x-slabs, cut in a cut parent on pencils, with a grandchild);
    the norm within 1e-15."""
    geom = FORESTS[forest]()
    cfg = TCfg(**cfg_kw(n_cells=geom.shape(0), max_level=geom.max_depth))
    sharded = tcomp.make_amr_spec(geom, cfg, "cpu", mesh_of(mesh_name))
    psi, dpsi = levels(geom, 19), levels(geom, 23)
    ref, nref = tnl.finish_iteration(geom, psi, dpsi, True)
    kernel_counts.reset()
    got, norm = tnl.finish_iteration(geom, tcomp.place(sharded, psi),
                                     tcomp.place(sharded, dpsi), True)
    halo = kernel_counts.snapshot()["halo"]
    placed_as_cut(sharded, got)
    for x, y in zip(whole(got), ref):
        assert torch.equal(x, y)
    assert abs(float(norm) - float(nref)) <= 1e-15 * float(nref)
    pairs = [l for l, _ in chip_smoke._cut_pairs(sharded)]
    assert halo["level_windows"] == len(pairs) > 0


# ----------------------------------------------------------------- writers


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_writer_tiles_from_shards(mesh_name, tmp_path, monkeypatch):
    """stream_global_slabs and the writers' pieces of a cut level's
    component stack (made shard by shard) against the whole stack's: the
    same tiles, offsets, values and bytes, bit for bit, with the tile bound
    shrunk so that a level streams in several tiles; both writers' files
    the same bytes where h5py is."""
    geom = hier("dirichlet")
    cfg = TCfg(**cfg_kw())
    mesh = mesh_of(mesh_name)
    fields = [tld.problem_fields(geom, cfg, l, torch.float64, "cpu")
              for l in range(geom.num_levels)]
    psi, dpsi, rhs = levels(geom, 29), levels(geom, 31), levels(geom, 37)
    place = lambda xs: tmesh.shard_level_list(xs, mesh, geom)  # noqa: E731
    pfields = tmesh.shard_fields(fields, mesh, geom)
    monkeypatch.setattr(chio, "_STREAM_MAX_BYTES", 10 * 32 * 32 * 3 * 8)
    for l in range(geom.num_levels):
        stack = chio.solver_data_stack(dpsi[l], rhs[l], psi[l], fields[l])
        pstack = chio.solver_data_stack(place(dpsi)[l], place(rhs)[l],
                                        place(psi)[l], pfields[l])
        assert isinstance(pstack, ShardSet)
        for axis, perm in ((3, (0, 3, 2, 1)), (1, None)):
            want = list(tdist.stream_global_slabs(stack, axis, 1 << 14,
                                                  perm))
            got = list(tdist.stream_global_slabs(pstack, axis, 1 << 14,
                                                 perm))
            assert len(want) > 1 and [a for a, _ in got] == [
                a for a, _ in want]
            for (_, g), (_, w) in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
        cells = int(np.prod(geom.shape(l)))
        pieces = list(chio._fab_pieces(0, cells, stack))
        ppieces = list(chio._fab_pieces(0, cells, pstack))
        assert len(pieces) > 10 and [o for o, _ in ppieces] == [
            o for o, _ in pieces]
        assert all(np.array_equal(a, b) for (_, a), (_, b) in
                   zip(ppieces, pieces))
    if not chio.HAVE_H5PY:
        return
    import h5py

    for what, args, pargs in (
            ("plot", (dpsi, rhs, psi, fields, 3),
             (place(dpsi), place(rhs), place(psi), pfields, 3)),
            ("final", (psi, fields, -0.25), (place(psi), pfields, -0.25))):
        write = (chio.write_solver_data if what == "plot"
                 else chio.write_final_data)
        for tag, a in (("whole", args), ("shards", pargs)):
            write(str(tmp_path / f"{what}_{tag}.h5"), geom, cfg, *a)
        with h5py.File(tmp_path / f"{what}_whole.h5") as fw, h5py.File(
                tmp_path / f"{what}_shards.h5") as fs:
            for d in range(geom.max_depth + 1):
                key = f"level_{d}/data:datatype=0"
                assert np.array_equal(fw[key][()], fs[key][()])


# ------------------------------------------------------------ the forest


def test_patches_forest_on_a_mesh_matches_unsharded():
    """The patches forest (tests/test_torch_forest.py's configuration: two
    sibling patches under a 64x16x16 base, average_down) on 4 x-slabs
    against the port's unsharded forest, two Picard iterations: the
    history to 1e-10 of its first entry, Krylov equal, psi to 1e-10; and
    the preconditioner on test_forest.two_patch_geom's forest with a
    grandchild, on x-slabs (whole patches under a cut base) and pencils
    (cut patches), against the unsharded one to 1e-11."""
    kw = patches_kw(average_down=True, max_nl_iterations=2)
    ref = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False)
    got = tnl.poisson_solve(TCfg(**kw), device="cpu", verbose=False,
                            mesh=mesh_of("x4"))
    assert got.geom.num_levels == 3
    h, r = got.dpsi_norm_history, ref.dpsi_norm_history
    np.testing.assert_allclose(h, r, rtol=0, atol=1e-10 * r[0])
    assert got.linear_iters == ref.linear_iters
    for x, y in zip(got.psi, ref.psi):
        _close(x, y)

    geom = port_geom(two_patch_geom(depth2=True))
    a, rr = levels(geom, 41, 0.5, 2.0), levels(geom, 43)
    for mesh_name in MESHES:
        plain, sharded = specs(geom, mesh_of(mesh_name),
                               n_cells=geom.shape(0), max_level=2)
        want = tcomp.precond(plain, tcomp.build_coefs(plain, a), rr)
        out = tcomp.precond(sharded, tcomp.build_coefs(
            sharded, tcomp.place(sharded, a)), tcomp.place(sharded, rr))
        placed_as_cut(sharded, out)
        for x, y in zip(whole(out), want):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=1e-11 * float(y.abs().max()))


# -------------------------------------------------------------- the counts


def test_counts_inside_the_picard_iterations():
    """Each Picard iteration of the sharded BBH on 4 x-slabs splits and
    joins no AMR level (only the base's depth chain reshards, as
    shard_traffic_of derives), cuts no coefficient at depth 0 and reads or
    writes exactly the level windows chip_smoke.check_halo_counts derives;
    one homogeneous composite_apply moves the bytes worked out by hand."""
    mesh = mesh_of("x4")
    halos, iters = [], []

    def hook(nl_iter, state):
        halos.append(dict(kernel_counts.HALO))

    kernel_counts.reset()
    res = tnl.poisson_solve(TCfg(**BBH), device="cpu", verbose=False,
                            mesh=mesh, output_hook=hook)
    halos.append(dict(kernel_counts.HALO))
    per_iter = [{k: b[k] - a[k] for k in a} for a, b in zip(halos,
                                                            halos[1:])]
    spec = tcomp.make_amr_spec(res.geom, TCfg(**BBH), "cpu", mesh)
    app = chip_smoke.shard_traffic_of(spec)
    run = {"halo_per_iteration": per_iter,
           "linear_iters": res.linear_iters}
    chip_smoke.check_halo_counts(run, spec, "cpu x4")
    # the result: psi, dpsi and ten field arrays of both levels, joined
    # once after the last iteration
    assert chip_smoke.result_joins_of(spec) == 2 * 12
    for i, (got, krylov) in enumerate(zip(per_iter, res.linear_iters)):
        # the depth chain: 32 -> 16 -> 8 x; 16 is cut into x-slabs of 4
        # no more: the restricted residual joined, the correction split
        assert app["level_splits"] == app["level_joins"] == 2
        final = 24 if i == len(per_iter) - 1 else 0
        assert got["level_splits"] == 2 * krylov * 2
        assert got["level_joins"] == 2 * krylov * 2 + final
        assert got["coef_splits"] == 0 and got["coef_joins"] == 1

    # one homogeneous apply on the 32^3 + 32x16x16 hierarchy on x-slabs:
    # the base exchanges 6 x planes of 32 x 32 f64 (3 seams, both ways; no
    # wrap on a Dirichlet box), the refined level 6 of 16 x 16, and the
    # refined level's CF planes come from the base in one window: on each
    # of its four y and z faces, child shard k reads the coarse x range
    # [7 + 4k, 12 + 4k] by 10 coarse cells, of which 5 / 1 / 1 / 5 x
    # columns live on another position than the child's (k = 0..3); the
    # x faces read from the parent shard at the child shard's position
    geom = hier("dirichlet")
    _, sharded = specs(geom, mesh)
    coefs = tcomp.build_coefs(sharded, tcomp.place(sharded, levels(
        geom, 3, 0.5, 2.0)))
    u = tcomp.place(sharded, levels(geom, 5))
    kernel_counts.reset()
    tcomp.composite_apply(sharded, coefs, u)
    halo = kernel_counts.snapshot()["halo"]
    planes = 6 * 32 * 32 * 8 + 6 * 16 * 16 * 8
    windows = 4 * (5 + 1 + 1 + 5) * 10 * 8
    assert halo["bytes_moved"] == planes + windows == 65280
    assert (halo["level_windows"], halo["pad_exchanges"]) == (1, 2)
    assert halo["level_splits"] == halo["level_joins"] == 0


# -------------------------------------------- entry points and dry run


def test_dryrun_multichip_matches_jax_full_step():
    """entry.dryrun_multichip(4) on the CPU: the x-slab step's dpsi norm
    against the JAX package's full_step on __graft_entry__._tiny_setup(n=64,
    max_level=1), 1e-10; every case's sharded norm against its unsharded
    one and every cut level placed (the function's own checks); entry()'s
    step against the JAX package's entry() step, 1e-10."""
    import __graft_entry__ as ge
    from mg_ic_code_tpu.solver import composite as jcomp
    from mg_ic_code_tpu.solver.nonlinear import (
        finish_iteration, prepare_iteration,
    )
    from mg_ic_code_tpu_torch import entry

    cfg, geom, spec, fields, state = ge._tiny_setup(n=64, max_level=1)

    def full_step(psi_list, dpsi_list, flds):
        a_list, rhs_list, _ = prepare_iteration(geom, cfg, flds, psi_list)
        coefs = jcomp.build_coefs(spec, a_list)
        out = jcomp.solve_linear(spec, coefs, rhs_list, dpsi_list)
        return finish_iteration(geom, psi_list, out.x)[1]

    ref = float(jax.jit(full_step)(state["psi"], state["dpsi"], fields))
    got = entry.dryrun_multichip(4, "cpu")
    assert set(got) == {"x_slabs", "forest", "pencils"}
    assert got["x_slabs"]["cuts"] == [(4, 1, 1), (4, 1, 1)]
    # the forest's 32^3 patches are cut on four x-slabs: no batch group
    assert got["forest"]["batch_groups"] == ()
    assert abs(got["x_slabs"]["norm"] - ref) <= 1e-10 * ref

    jfn, jargs = ge.entry()
    jout = jax.jit(jfn)(*jargs)
    fn, args = entry.entry("cpu")
    for x, y in zip(fn(*args), jout):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-10 * np.abs(y).max())
