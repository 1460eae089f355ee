"""The preconditioner with a mesh holds the levels and depths the mesh cuts
on their shards (parallel/shards.ShardSet): it takes and returns the level
list as composite.place holds it (every cut level as its shards), held
against the JAX package's sharded preconditioner on the conftest's 8
virtual CPU devices (the same numpy inputs, f64, 1e-10 of max|reference|),
against the per-call form (whole levels and whole coefficients, every
relax and residual of a cut depth splitting and joining them, the
restriction of a cut depth taken whole: bitwise on the CPU), against a
fresh coefficient build (no pad of an older build is read), and in its
split / join / window counts (kernel_counts.HALO) against the counts its
hierarchy and mesh imply (chip_smoke.shard_traffic_of,
shard_coef_builds_of) and against counts worked out by hand.

The hierarchy: a 32^3 base (depth chain 32, 16, 8, 4) with one refined
32x16x16 level over it. 4 x-slabs cut the base's depth 0 and the refined
level (a cut level over a cut parent), and the chain passes from a cut
depth to uncut ones; (2, 2) pencils cut depths 0 and 1 alike (the chain
stays on its shards); (4, 2) pencils cut depth 1 otherwise than depth 0
(the restricted residual is joined and cut again)."""

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

import chip_smoke
from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.config import SolverConfig as TCfg
from mg_ic_code_tpu_torch.ops import kernel_counts
from mg_ic_code_tpu_torch.ops import stencils as tst
from mg_ic_code_tpu_torch.parallel.shards import ShardSet
from mg_ic_code_tpu_torch.solver import composite as tcomp
from mg_ic_code_tpu_torch.solver import multigrid as tmg

torch.set_num_threads(1)

MESHES = {"x4": None, "pencil_2x2": (2, 2), "pencil_4x2": (4, 2)}
NDEV = {"x4": 4, "pencil_2x2": 4, "pencil_4x2": 8}
# the cut of every depth of the base chain and of the refined level
CUTS = {"x4": ([(4, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)], (4, 1, 1)),
        "pencil_2x2": ([(2, 2, 1), (2, 2, 1), (1, 1, 1), (1, 1, 1)],
                       (2, 2, 1)),
        "pencil_4x2": ([(4, 2, 1), (1, 2, 1), (1, 1, 1), (1, 1, 1)],
                       (4, 2, 1))}
# splits, joins and level windows of one application (two V-cycles),
# worked out by hand from CUTS and the rules of composite.amr_vcycle /
# multigrid.mg_vcycle. The levels come in and go out as their shards, so
# only the base's depth chain splits and joins:
#   x4: per V-cycle the base joins its restricted residual at the uncut
#   depth 1 (1) and splits the correction under its shards (1): 2 / 2.
#   pencil_2x2: depth 1 cut alike, depth 2 not: the same counts at depth
#   1's restriction.
#   pencil_4x2: depth 1 cut otherwise: 1 join and 1 split at depth 0's
#   restriction, 2 splits and 1 join taking depth 1 up whole, 1 join and 1
#   split at its own restriction to the uncut depth 2: 4 / 3 per V-cycle.
#   Windows: the refined level (cut, six coarse-fine faces) writes its
#   restriction into the base (1), reads the coarse correction under it
#   (1) and its faces' coarse planes for the post-smooth (1) per V-cycle,
#   and the composite residual between the two reads the planes once
#   more: 2 * 3 + 1.
BY_HAND = {"x4": (2, 2, 7), "pencil_2x2": (2, 2, 7), "pencil_4x2": (8, 6, 7)}


def _rng(seed):
    return np.random.default_rng(seed)


def hierarchy(periodic: bool):
    dom0 = Box.from_shape((32, 32, 32))
    l1 = Box((8, 4, 4), (23, 11, 11)).refine(2)  # 32x16x16 at (16, 8, 8)
    bc = dict(bc_lo=(0, 0, 0), bc_hi=(0, 0, 0), bc_value=0.0,
              periodic=periodic)
    jg = JGeom(boxes=(dom0, l1), domain_boxes=(dom0, dom0.refine(2)),
               dx=(1.0 / 32, 1.0 / 64), domain_length=(1.0,) * 3,
               bc=JBC(**bc), parent=(-1, 0))
    plain = lambda bs: [(b.lo, b.hi) for b in bs]  # noqa: E731
    tg = cv.geom_from_plain(plain(jg.boxes), jg.parent, jg.dx, bc,
                            plain(jg.domain_boxes), jg.domain_length)
    return jg, tg


def cfg_kw(**kw):
    base = dict(alpha=1.0, beta=-1.0, L=1.0, n_cells=(32, 32, 32),
                max_level=1, num_mg_smooth=4, num_mg_iterations=2,
                max_iterations=20, tolerance=1e-10, smoother="xla",
                precond_precision="double")
    base.update(kw)
    return base


def fields(tg, seed):
    rng = _rng(seed)
    a = [rng.uniform(0.5, 2.0, b.shape) for b in tg.boxes]
    r = [rng.standard_normal(b.shape) for b in tg.boxes]
    return a, r


def T(xs):
    return cv.level_list_from_numpy(xs, "cpu")


def P(spec, xs):
    """The numpy levels placed as the solve holds them on spec's mesh."""
    return tcomp.place(spec, T(xs))


def W(xs):
    """Placed levels whole again (the cut ones joined)."""
    return [x.join() if isinstance(x, ShardSet) else x for x in xs]


def whole_coefs(coefs):
    """A coefficient build with every shard set joined and no cached
    shards: the per-call form's coefficients, cut per call."""
    def whole(t):
        return t.join(what="coef_joins") if isinstance(t, ShardSet) else t

    out = []
    for c in coefs:
        c = {k: (tuple(whole(t) for t in v) if k in ("a", "b", "lam")
                 else v) for k, v in c.items() if k != "shards"}
        if "lp" in c:
            c["lp"] = whole_coefs([c["lp"]])[0]
        out.append(c)
    return out


def placed_as_cut(spec, xs):
    """Every level the mesh cuts a shard set of its cut, the others whole
    tensors on the home."""
    for ls, x in zip(spec.level_specs, xs):
        counts = tmg._shard_counts(ls, 0)
        if counts == (1, 1, 1):
            assert isinstance(x, torch.Tensor)
        else:
            assert isinstance(x, ShardSet) and x.counts == counts
            assert all(s.device == x.devs[k] for k, s in x.shards.items())


def port(mesh_name, periodic=False, **kw):
    """(spec, geom) of the port with the mesh (None: no mesh)."""
    _, tg = hierarchy(periodic)
    tm = None
    if mesh_name is not None:
        from mg_ic_code_tpu_torch.parallel import mesh as tmesh

        tm = tmesh.make_mesh(["cpu"] * NDEV[mesh_name], MESHES[mesh_name])
    return tcomp.make_amr_spec(tg, TCfg(**cfg_kw(**kw)), "cpu", tm), tg


def close_lists(ts, refs, tol):
    for t, ref in zip(ts, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(t), ref, rtol=0,
                                   atol=tol * float(np.abs(ref).max()))


def test_cuts_are_as_stated():
    for name, (chain, level1) in CUTS.items():
        spec, _ = port(name)
        ls0, ls1 = spec.level_specs
        assert [tmg._shard_counts(ls0, d) for d in range(ls0.ndepths)] == (
            chain), name
        assert tmg._shard_counts(ls1, 0) == level1, name


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["dirichlet", "periodic"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_precond_with_mesh_matches_jax(mesh_name, periodic):
    """composite.precond (two AMR V-cycles) with the mesh against the JAX
    package's precond on its sharded arrays, f64, 1e-10; the port's
    correction comes back placed as its input: every cut level as its
    shards."""
    jg, tg = hierarchy(periodic)
    jm = jmesh.make_mesh(jax.devices()[:NDEV[mesh_name]], MESHES[mesh_name])
    jspec = jcomp.make_amr_spec(jg, JCfg(**cfg_kw()), jm)
    tspec, _ = port(mesh_name, periodic)
    a, r = fields(tg, 7)
    put = lambda xs: jmesh.shard_level_list(  # noqa: E731
        [jnp.asarray(x) for x in xs], jg, jm)
    jco = jcomp.build_coefs_jit(jspec, put(a))
    ref = jcomp.precond_jit(jspec, jco, put(r))
    tco = tcomp.build_coefs(tspec, P(tspec, a))
    out = tcomp.precond(tspec, tco, P(tspec, r))
    placed_as_cut(tspec, out)
    close_lists(W(out), ref, 1e-10)


# ---------------------------------------- against the per-call form (bitwise)


def per_call_mg_vcycle(spec, coefs, u, rhs, d=0):
    """mg_vcycle in its per-call form: whole tensors at every depth, each
    relax of a cut depth split and joined per call, the residual of a cut
    depth restricted whole (the staged st.restrict_residual)."""
    if all(tmg._shard_counts(spec, dd) == (1, 1, 1)
           for dd in range(d, spec.ndepths)):
        return tmg.mg_vcycle(spec, coefs, u, rhs, d)
    u = tmg.relax(spec, coefs, d, u, rhs, spec.nsmooth)
    if d + 1 == spec.ndepths:
        return tmg.bottom_solve(spec, coefs, d, u, rhs)
    rc = tst.restrict_residual(tmg._ghost(spec, d, u), rhs, coefs["a"][d],
                               coefs["b"][d], spec.alpha, spec.beta,
                               spec.dx[d])
    ec = torch.zeros_like(rc)
    for _ in range(max(spec.num_mg, 1)):
        ec = per_call_mg_vcycle(spec, coefs, ec, rc, d + 1)
    u = tst.prolong_inc(u, ec)
    return tmg.relax(spec, coefs, d, u, rhs, spec.nsmooth)


def per_call_precond(spec, coefs, r_list):
    """composite._vcycle_precond with amr_vcycle in its per-call form."""
    geom = spec.geom
    use_lp = spec.precond_dtype == "float32"
    if use_lp:
        r_list = [x.to(torch.float32) for x in r_list]
    e = [torch.zeros_like(x) for x in r_list]
    for it in range(spec.num_mg_iterations):
        r = list(r_list) if it == 0 else tcomp._composite_residual_coefs(
            spec, coefs, e, r_list, use_lp)
        r = [x.clone() for x in r]
        de = [None] * spec.num_levels
        for depth in range(geom.max_depth, 0, -1):
            for l in geom.entries_at_depth(depth):
                ls, cl = spec.level_specs[l], tcomp._lp(coefs[l], use_lp)
                el = tmg.relax(ls, cl, 0, torch.zeros_like(r[l]), r[l],
                               spec.nsmooth)
                p = geom.parent[l]
                r[p][geom.child_slices(p, l)] = tst.restrict_full(
                    tmg.residual_homog(ls, cl, 0, el, r[l]))
                de[l] = el
        de[0] = per_call_mg_vcycle(spec.level_specs[0],
                                   tcomp._lp(coefs[0], use_lp),
                                   torch.zeros_like(r[0]), r[0])
        for depth in range(1, geom.max_depth + 1):
            for l in geom.entries_at_depth(depth):
                ls, p = spec.level_specs[l], geom.parent[l]
                el = tst.prolong_inc(de[l], de[p][geom.child_slices(p, l)])
                de[l] = tmg.relax_cf(ls, tcomp._lp(coefs[l], use_lp), el,
                                     r[l], spec.nsmooth, geom, l, de[p])
        e = [x + y for x, y in zip(e, de)]
    return [x.to(torch.float64) for x in e] if use_lp else e


PRECISIONS = {"f64_plain": dict(),
              "f32_kernels": dict(smoother="pallas",
                                  precond_precision="single")}


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("periodic", [False, True],
                         ids=["dirichlet", "periodic"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resident_precond_is_the_per_call_form_bitwise(mesh_name, periodic,
                                                       prec):
    """The resident preconditioner against its per-call form on whole
    levels and whole coefficients, bit for bit: f64 through the plain
    sharded ops, f32 through the halo kernels' plain versions (smoother =
    pallas). A per-shard residual restricted on its shard evaluates every
    coarse cell as the whole level's staged restriction does; the windows
    read and write the same values as the whole levels' slices; the
    coefficient chain coarsened on the shards is the whole chain."""
    spec, tg = port(mesh_name, periodic, **PRECISIONS[prec])
    a, r = fields(tg, 8)
    coefs = tcomp.build_coefs(spec, P(spec, a))
    pc_coefs = whole_coefs(coefs)
    kernel_counts.reset()
    out = tcomp.precond(spec, coefs, P(spec, r))
    resident = kernel_counts.snapshot()
    ref = per_call_precond(spec, pc_coefs, T(r))
    per_call = kernel_counts.snapshot()
    for x, y in zip(W(out), ref):
        assert torch.equal(x, y)
    if prec == "f32_kernels":
        assert sum(resident["plain_calls"].values()) > 0
        assert resident["plain_calls"] == {
            k: per_call["plain_calls"][k] - v
            for k, v in resident["plain_calls"].items()}
    # the per-call form splits and joins at every call
    for k in ("level_splits", "level_joins"):
        assert per_call["halo"][k] - resident["halo"][k] > resident["halo"][k]


def test_resident_precond_matches_unsharded():
    """With the mesh and without, f64: the plain sharded ops' order of
    additions is the JAX package's overlapped form, so 1e-11 and not
    bitwise."""
    sharded, tg = port("x4")
    plain, _ = port(None)
    a, r = fields(tg, 9)
    out = tcomp.precond(sharded, tcomp.build_coefs(sharded, P(sharded, a)),
                        P(sharded, r))
    ref = tcomp.precond(plain, tcomp.build_coefs(plain, T(a)), T(r))
    close_lists(W(out), [x.numpy() for x in ref], 1e-11)


@pytest.mark.parametrize("mesh_name", ["x4", "pencil_4x2"])
def test_variable_bcoef_precond_matches_jax_and_counts(mesh_name):
    """A variable bCoef: the cut depths relax through the block ops on
    their shards, and relax_cf runs its per-pass ghost loop on the shards
    of a cut level (the coarse face planes read once, one window). Against
    the JAX package's sharded precond, f64, 1e-10; its counts against
    shard_traffic_of / shard_coef_builds_of with const_b=False."""
    jg, tg = hierarchy(False)
    jm = jmesh.make_mesh(jax.devices()[:NDEV[mesh_name]], MESHES[mesh_name])
    jspec = jcomp.make_amr_spec(jg, JCfg(**cfg_kw()), jm)
    tspec, _ = port(mesh_name)
    a, r = fields(tg, 16)
    b = [_rng(17).uniform(0.8, 1.2, x.shape) for x in a]
    put = lambda xs: jmesh.shard_level_list(  # noqa: E731
        [jnp.asarray(x) for x in xs], jg, jm)
    ref = jcomp.precond_jit(jspec, jcomp.build_coefs_jit(jspec, put(a),
                                                         put(b)), put(r))
    pa, pb, pr = P(tspec, a), P(tspec, b), P(tspec, r)
    kernel_counts.reset()
    tco = tcomp.build_coefs(tspec, pa, pb)
    build = kernel_counts.snapshot()["halo"]
    kernel_counts.reset()
    out = tcomp.precond(tspec, tco, pr)
    app = kernel_counts.snapshot()["halo"]
    close_lists(W(out), ref, 1e-10)
    want = chip_smoke.shard_coef_builds_of(tspec, "cpu", const_b=False)
    assert {k: build[k] for k in want} == want
    want = chip_smoke.shard_traffic_of(tspec, const_b=False)
    assert {k: app[k] for k in want} == want


# ------------------------------------------------------- no stale pad


@pytest.mark.parametrize("mesh_name", ["x4", "pencil_2x2"])
def test_a_new_build_never_reads_an_old_ones_pads(mesh_name):
    """Two build_coefs with different aCoef, each preconditioner run after
    the other build: each equals the preconditioner of a fresh build of its
    own aCoef, bit for bit (the shards and pads live in the build's own
    coefficients). The test can see a stale pad: the second build's
    coefficients with the first build's shards and pads give another
    answer."""
    spec, tg = port(mesh_name, **PRECISIONS["f32_kernels"])
    a1, r = fields(tg, 10)
    a2, _ = fields(tg, 11)
    pr = P(spec, r)
    c1 = tcomp.build_coefs(spec, P(spec, a1))
    out1 = W(tcomp.precond(spec, c1, pr))
    c2 = tcomp.build_coefs(spec, P(spec, a2))
    out2 = W(tcomp.precond(spec, c2, pr))
    again1 = W(tcomp.precond(spec, c1, pr))
    fresh2 = W(tcomp.precond(spec, tcomp.build_coefs(spec, P(spec, a2)),
                             pr))
    for x, y, z, w in zip(out1, again1, out2, fresh2):
        assert torch.equal(x, y) and torch.equal(z, w)
    assert "apad" in c2[0]["lp"]["shards"][0] or (
        "apre" in c2[0]["lp"]["shards"][0])
    stale = [dict(c, lp=dict(c["lp"], shards=o["lp"]["shards"]))
             for c, o in zip(c2, c1)]
    out_stale = W(tcomp.precond(spec, stale, pr))
    assert not all(torch.equal(x, y) for x, y in zip(out_stale, fresh2))


# ------------------------------------------------------------ the counts


@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_split_join_counts_are_the_derived_counts(mesh_name, prec):
    """kernel_counts.HALO of one build_coefs and of one preconditioner
    application against chip_smoke's derivation from the hierarchy and the
    mesh, and against the counts worked out by hand (BY_HAND): nothing cut
    at depth 0 of a build, no coefficient split and no pad built inside an
    application, no split or join of an AMR level and none between two cut
    depths with equal counts."""
    spec, tg = port(mesh_name, **PRECISIONS[prec])
    pa, pr = (P(spec, x) for x in fields(tg, 12))
    kernel_counts.reset()
    coefs = tcomp.build_coefs(spec, pa)
    build = kernel_counts.snapshot()["halo"]
    want = chip_smoke.shard_coef_builds_of(spec, "cpu")
    assert {k: build[k] for k in want} == want
    assert build["level_splits"] == build["level_joins"] == 0
    assert build["level_windows"] == 0
    # the chain is resharded only where the cut ends or changes: 8^3 is
    # never cut, and pencil_4x2 cuts 16^3 otherwise than 32^3
    assert build["coef_joins"] == 1 + (mesh_name == "pencil_4x2")
    assert build["coef_splits"] == (mesh_name == "pencil_4x2")
    kernel_counts.reset()
    tcomp.precond(spec, coefs, pr)
    app = kernel_counts.snapshot()["halo"]
    want = chip_smoke.shard_traffic_of(spec)
    assert {k: app[k] for k in want} == want
    assert (app["level_splits"], app["level_joins"],
            app["level_windows"]) == BY_HAND[mesh_name]
    assert app["coef_splits"] == app["coef_pad_builds"] == 0
    assert app["pad_exchanges"] > 0 and app["bytes_moved"] > 0


def test_counts_of_a_run_are_builds_and_applications():
    """Over a linear solve: one coefficient build and two preconditioner
    applications per Krylov iteration split and join what they imply, and
    nothing else does (the composite operator and the Krylov vectors work
    on the shards); the operator's coarse-fine term reads one window in
    the initial residual and in each of its two applications a Krylov
    iteration."""
    spec, tg = port("pencil_4x2", **PRECISIONS["f32_kernels"])
    pa, pr = (P(spec, x) for x in fields(tg, 13))
    kernel_counts.reset()
    coefs = tcomp.build_coefs(spec, pa)
    out = tcomp.solve_linear(spec, coefs, pr)
    got = kernel_counts.snapshot()["halo"]
    app = chip_smoke.shard_traffic_of(spec)
    build = chip_smoke.shard_coef_builds_of(spec, "cpu")
    apps = 2 * int(out.iters)
    assert apps > 0
    placed_as_cut(spec, out.x)
    assert got["level_splits"] == apps * app["level_splits"]
    assert got["level_joins"] == apps * app["level_joins"]
    assert got["level_windows"] == apps * app["level_windows"] + (1 + apps)
    assert got["coef_splits"] == build["coef_splits"]
    assert got["coef_joins"] == build["coef_joins"]
    assert got["coef_pad_builds"] == build["coef_pad_builds"]


def test_shard_set_operations():
    """split / join round trip (into a view too), zeros_like, axpy, region
    reads of a strided coarse view, and the counters each one moves."""
    from mg_ic_code_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(["cpu"] * 4, (2, 2))
    x = torch.from_numpy(_rng(14).standard_normal((16, 16, 8)))
    kernel_counts.reset()
    s = ShardSet.split(x, mesh, (2, 2, 1), lo=(2, 0, 4))
    assert s.n_loc == (8, 8, 8) and s.lo == (2, 0, 4)
    assert s.shape == (16, 16, 8)
    assert torch.equal(s.shards[(1, 0, 0)], x[8:, :8])
    assert torch.equal(s.join(), x)
    big = torch.zeros(20, 16, 8, dtype=x.dtype)
    s.join(out=big[2:18])
    assert torch.equal(big[2:18], x) and not big[:2].any()
    assert torch.equal(s.axpy(2.0, s.zeros_like()).join(), x)
    assert torch.equal(s.axpy(-1.0, s).join(), torch.zeros_like(x))
    coarse = torch.from_numpy(_rng(15).standard_normal((16, 16, 8)))
    view = coarse[::2, ::2]
    part = s.region(view)
    assert torch.equal(part[(1, 1, 0)], view[4:, 4:])
    c = kernel_counts.snapshot()["halo"]
    assert (c["level_splits"], c["level_joins"]) == (2, 4)
    # three of the four shards sit off the home position: one split and
    # four joins move three 8^3 shards each, the region read three 4x4x8
    # pieces (f64)
    assert c["bytes_moved"] == 5 * 3 * 8**3 * 8 + 3 * 4 * 4 * 8 * 8
