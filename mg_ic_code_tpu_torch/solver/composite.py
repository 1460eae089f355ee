"""Composite (multi-level AMR) operator, V-cycle preconditioner and linear
solve.

Port of Chombo's MultilevelLinearOp + AMRMultiGrid as driven by the
reference (Main_PoissonSolver.cpp:103-184):

  * composite_apply/residual — the AMR hierarchy as ONE linear operator on
    the list of per-level arrays: each level applies L with quadratic
    coarse-fine ghosts interpolated from the same vector's coarser component
    (QuadCFInterp coupling) and physical BCs; no reflux, matching the
    reference's disabled reflux.
  * amr_vcycle — correction-scheme V-cycle across AMR levels (homogeneous CF
    ghosts during smoothing), with the full MG depth chain + bottom solve
    below the base level.
  * precond — m_num_mg_iterations AMR V-cycles (MultilevelLinearOp::preCond).
  * solve_linear — BiCGStab over the composite vector with volume-weighted
    dots and max-norm convergence (solver.m_normType = 0).

With a mesh, the composite vector holds every level the mesh cuts as a
parallel/shards.ShardSet and the rest whole on the mesh's home (`place`):
the operator, the residuals, the V-cycle and the Krylov vectors work on
them shard by shard, and one level reads another's part under its shards
by level windows. Nothing here joins a cut level.

FOREST BATCHING (`forest_batching`, the JAX package's batch groups): the
same-shape sibling patches of a depth (`AMRSolverSpec.batch_groups`) are
smoothed and restricted as ONE batch in amr_vcycle, through the batched
forms of the kernels (multigrid.relax_batch / residual_restrict_batch).
Where the mesh has an axis for the group (parallel/mesh.patch_positions),
each chunk of it is computed at its own position: its coefficients are
placed there once per build_coefs, and within a V-cycle its residual goes
there and its correction comes back (parallel/shards.to_positions /
from_positions), the restricted residual goes to the parent and the
coarse values come from it by level windows.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mg_ic_code_tpu_torch import precision
from mg_ic_code_tpu_torch.config import SolverConfig
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.ops.ghosts import fill_ghosts
from mg_ic_code_tpu_torch.parallel import halo
from mg_ic_code_tpu_torch.parallel import mesh as pmesh
from mg_ic_code_tpu_torch.parallel import shards
from mg_ic_code_tpu_torch.parallel.shards import (
    ShardSet, per_shard, read_window, write_window, zeros_like,
)
from mg_ic_code_tpu_torch.solver import multigrid as mg
from mg_ic_code_tpu_torch.solver import reductions as red
from mg_ic_code_tpu_torch.solver.bicgstab import BiCGStabResult, bicgstab


@dataclasses.dataclass(frozen=True)
class AMRSolverSpec:
    """Static description of the composite solver (hashable)."""

    geom: HierarchyGeom
    alpha: float
    beta: float
    nsmooth: int
    num_mg_iterations: int
    avg_type: str
    level_specs: tuple[mg.LevelMGSpec, ...]
    tol: float = 1.0e-10
    max_iter: int = 100
    # stop when an iteration shrinks the residual by less than this factor
    # (Chombo BiCGStabSolver m_hang default 1e-8; params.txt `hang` key)
    hang: float = 1.0e-8
    # preCondSolverDepth (MultilevelLinearOp): when >= 0 the preconditioner
    # is itself an inner BiCGStab solve (loosely converged), preconditioned
    # by the AMR V-cycles — the reference's commented-out deep-precondition
    # mode. -1 = plain V-cycle preconditioning.
    pre_cond_solver_depth: int = -1
    # run the MG preconditioner in reduced precision ("float32") while the
    # outer Krylov stays f64 — the mixed-precision mode (the preconditioner
    # only needs smoother-grade accuracy, and the f32 kernels are the
    # production path). None = same precision as the operands.
    precond_dtype: str | None = None
    # groups of same-shape sibling entries that amr_vcycle sweeps as ONE
    # batch (_sibling_batch_groups, per cfg.forest_batching); () = every
    # entry on its own
    batch_groups: tuple[tuple[int, ...], ...] = ()

    @property
    def num_levels(self) -> int:
        return self.geom.num_levels


def make_amr_spec(
    geom: HierarchyGeom, cfg: SolverConfig, device=None, mesh=None
) -> AMRSolverSpec:
    """`device` (None = cuda) is where the solve will run: it resolves
    `precond_precision = auto` (precision.precond_dtype). `mesh`
    (parallel/mesh.Mesh, optional) puts the smoother and the residual on
    the explicit-halo path wherever a depth's axes shard usefully
    (multigrid._shard_counts); `device` is then the mesh's first (its
    home, where the levels live). `cfg.forest_batching` gives the batch
    groups (_sibling_batch_groups). `cfg.smoother_precision = bfloat16`
    sets every level's smoother_compute (the bf16 tier of gsrb_relax, the
    marches, the shard marches and the towers; every other relaxation takes
    none, as in the JAX package)."""
    device = precision.resolve_device(device)
    smoother_compute = ("bfloat16" if cfg.smoother_precision == "bfloat16"
                        else None)
    level_specs = tuple(
        mg.make_level_spec(
            geom, l, cfg.alpha, cfg.beta, cfg.num_mg_smooth,
            cfg.coefficient_average_type,
            # depth chains below the base level only (ref ratio 2 puts all
            # intermediate MG depths under AMR level 0)
            with_depths=(l == 0),
            smoother=cfg.smoother,
            num_mg=cfg.num_mg,
            mesh=mesh,
            bottom=cfg.bottom_solver,
            smoother_compute=smoother_compute,
        )
        for l in range(geom.num_levels)
    )
    precond = precision.precond_dtype(cfg.precond_precision, device)
    return AMRSolverSpec(
        geom=geom,
        alpha=cfg.alpha,
        beta=cfg.beta,
        nsmooth=cfg.num_mg_smooth,
        num_mg_iterations=cfg.num_mg_iterations,
        avg_type=cfg.coefficient_average_type,
        level_specs=level_specs,
        tol=cfg.tolerance,
        max_iter=cfg.max_iterations,
        hang=cfg.hang,
        pre_cond_solver_depth=cfg.pre_cond_solver_depth,
        precond_dtype=precond,
        batch_groups=_sibling_batch_groups(
            geom, level_specs, getattr(cfg, "forest_batching", "auto"), mesh
        ),
    )


def _sibling_batch_groups(
    geom: HierarchyGeom, level_specs, mode: str, mesh
) -> tuple[tuple[int, ...], ...]:
    """Same-depth sibling entries that can run as one batched sweep (the
    JAX package's rule).

    Batchable = identical box shape, face kinds, dx, and global checker
    parity (sum(lo) mod 2 — the GSRB colour mask depends on lo only through
    this). Policy: "off" = never; "force" = every group of >= 2 (the test
    mode, and the one-card launch-reduction mode); "auto" = only groups a
    device mesh does not cut (multigrid._shard_counts == (1, 1, 1)):
    exactly the case where the sequential sweep would leave every other
    mesh position idle while the home computes every patch."""
    if mode == "off":
        return ()
    by_key: dict = {}
    for e in range(1, geom.num_levels):
        ls = level_specs[e]
        key = (
            geom.depth_of(e), geom.boxes[e].shape, ls.kinds,
            sum(geom.boxes[e].lo) % 2, geom.dx[e],
        )
        by_key.setdefault(key, []).append(e)
    out = []
    for ents in by_key.values():
        if len(ents) < 2:
            continue
        if mode == "auto":
            if mesh is None:
                continue
            if mg._shard_counts(level_specs[ents[0]], 0) != (1, 1, 1):
                continue  # cut patches already use the whole mesh
        out.append(tuple(ents))
    return tuple(sorted(out))


def batch_positions(spec: AMRSolverSpec, group) -> tuple | None:
    """The mesh position that computes each patch of a batch group
    (parallel/mesh.patch_positions), or None: no mesh, or no mesh axis
    for the group (it then runs as one batch on the home)."""
    mesh = spec.level_specs[0].mesh
    return None if mesh is None else pmesh.patch_positions(mesh, len(group))


def _group_batchable(spec: AMRSolverSpec, coefs, group) -> bool:
    """Whether a batch group runs as a batch: b constant (the batched
    kernels and the JAX package's batched body take none), and no patch
    cut by the mesh (a cut patch stays on its shards, which a batch would
    have to join). Otherwise its entries run one after the other."""
    return all(coefs[x]["b"][0] is None and mg._shard_counts(
        spec.level_specs[x], 0) == (1, 1, 1) for x in group)


def _batchable(spec: AMRSolverSpec, coefs, depth_entries) -> list:
    """Split a depth's entries into [(group tuple) | single entry, ...] in
    entry order, honouring spec.batch_groups (_group_batchable)."""
    in_group = {ent: g for g in spec.batch_groups for ent in g}
    plan, seen = [], set()
    for l in depth_entries:
        if l in seen:
            continue
        g = in_group.get(l)
        if g is not None and _group_batchable(spec, coefs, g):
            plan.append(g)
            seen.update(g)
        else:
            plan.append(l)
            seen.add(l)
    return plan


def place(spec: AMRSolverSpec, u_list):
    """The level list as the solve holds it with spec's mesh
    (parallel/mesh.shard_level_list): every level the mesh cuts as its
    shards (a whole tensor split once), the rest whole on the mesh's home;
    without a mesh the list as it is."""
    mesh = spec.level_specs[0].mesh
    if mesh is None:
        return list(u_list)
    from mg_ic_code_tpu_torch.parallel import mesh as pmesh

    return pmesh.shard_level_list(u_list, mesh, spec.geom)


def check_placed(spec: AMRSolverSpec, u_list, what: str) -> None:
    """Raise unless every level is held as spec's mesh places it: a shard
    set of its cut where the mesh cuts it (multigrid._shard_counts at
    depth 0), a whole tensor elsewhere."""
    for l, u in enumerate(u_list):
        counts = mg._shard_counts(spec.level_specs[l], 0)
        cut = counts != (1, 1, 1)
        if cut != isinstance(u, ShardSet) or (
                cut and u.counts != counts):
            raise ValueError(
                f"{what}: level {l} is not placed as the mesh cuts it "
                f"(cut {counts}); composite.place places a level list")


def build_coefs(spec: AMRSolverSpec, a_list, b_list=None) -> tuple[dict, ...]:
    """Per-level coefficient structures (with depth chains under level 0).

    With mixed-precision preconditioning, each level also carries an "lp"
    sub-dict holding float32 casts of the whole depth chain. With a mesh,
    aCoef arrives placed (a level the mesh cuts as its shards): the chain
    is made on the shards (multigrid.build_level_coefs), and each set
    carries the shards and halo-kernel pads of every depth the mesh cuts
    (parallel/halo.shard_coefs, "shards"): made here, once per coefficient
    build, and never inside a preconditioner application. A batch group
    computed at its mesh positions (batch_positions) gets aCoef and lambda
    of each patch at its position, in every coefficient set ("at": the
    chunk's coefficients, placed once per build)."""
    check_placed(spec, a_list, "build_coefs")
    out = []
    lp_dtype = (
        precision.PRECOND_DTYPE if spec.precond_dtype == "float32" else None
    )
    for l in range(spec.num_levels):
        b0 = None if b_list is None else b_list[l]
        c = mg.build_level_coefs(spec.level_specs[l], a_list[l], b0)
        if lp_dtype is not None:
            cast = lambda t: tuple(
                None if x is None else x.to(lp_dtype) for x in t
            )
            c = dict(c)
            c["lp"] = {k: cast(c[k]) for k in ("a", "b", "lam")}
            if c.get("binv") is not None:
                # the dense bottom inverse must ride along or the f32
                # preconditioner silently falls back to the launch-bound
                # BiCGStab bottom tower
                c["lp"]["binv"] = c["binv"].to(lp_dtype)
            if "shards" in c:
                c["lp"]["shards"] = halo.shard_coefs(spec.level_specs[l],
                                                     c["lp"])
        out.append(c)
    mesh = spec.level_specs[0].mesh
    for g in spec.batch_groups:
        pos = batch_positions(spec, g)
        if pos is None or not _group_batchable(spec, out, g):
            continue
        sets = [[out[x] for x in g]]
        if "lp" in out[g[0]]:
            sets.append([out[x]["lp"] for x in g])
        for cs in sets:
            placed = shards.to_positions(
                mesh, [c["a"][0] for c in cs] + [c["lam"][0] for c in cs],
                pos + pos)
            for i, c in enumerate(cs):
                c["at"] = {"a": (placed[i],), "b": (None,),
                           "lam": (placed[len(g) + i],)}
    return tuple(out)


def _lp(coefs_l: dict, use_lp: bool) -> dict:
    return coefs_l["lp"] if use_lp and "lp" in coefs_l else coefs_l


# --------------------------------------------------------------- operator


def composite_apply(
    spec: AMRSolverSpec, coefs, u_list, homogeneous_phys: bool = True,
    use_lp: bool = False,
):
    """A(u) on the composite vector. CF ghosts always couple to the coarser
    component of u itself (that coupling is part of the linear operator);
    the `homogeneous_phys` flag only zeroes physical BC values. `use_lp`
    selects the low-precision coefficient set (the preconditioner's inner
    residuals).

    The homogeneous form — every Krylov application — exploits that the
    operator is LINEAR in the CF ghost: A(u) = L_homog(u_l) minus the
    coarse-ghost face term (cf_interp.add_cf_coarse_term), so each level
    pays the cheap homogeneous one-ring fill instead of the full
    inhomogeneous QuadCFInterp assembly. The split is exact up to FLOP
    reassociation: the ghost value decomposes as
    (w0·u0 + w1·u1) + W_COARSE·plane and only face-adjacent ghosts reach
    the 7-point stencil."""
    from mg_ic_code_tpu_torch.ops import cf_interp as _cfi

    geom = spec.geom
    out = []
    for l in range(spec.num_levels):
        c = _lp(coefs[l], use_lp)
        if homogeneous_phys:
            au = mg.apply_homog(spec.level_specs[l], c, 0, u_list[l])
            if l > 0:
                au = _cfi.add_cf_coarse_term(
                    au, geom, l, u_list[geom.parent[l]],
                    -spec.beta / geom.dx[l] ** 2, c["b"][0],
                )
            out.append(au)
        else:
            # inhomogeneous physical BCs (the initial residual only): the
            # full QuadCFInterp + BC-value ghost assembly (shard by shard
            # on a cut level)
            u_gh = fill_ghosts(
                u_list[l], geom, l,
                coarse_u=u_list[geom.parent[l]] if l > 0 else None,
                homogeneous_phys=False,
            )
            out.append(
                per_shard(
                    st.apply_op, u_gh, c["a"][0], c["b"][0], spec.alpha,
                    spec.beta, geom.dx[l],
                )
            )
    return out


def composite_residual(
    spec: AMRSolverSpec, coefs, u_list, rhs_list, homogeneous_phys: bool = True
):
    au = composite_apply(spec, coefs, u_list, homogeneous_phys)
    return [r - a for r, a in zip(rhs_list, au)]


# ----------------------------------------------------------------- V-cycle


def _covered_offset(geom: HierarchyGeom, p: int, l: int) -> tuple:
    """Where child l's covered part starts in its parent p's array."""
    return tuple(sl.start for sl in geom.child_slices(p, l))


def _under(geom: HierarchyGeom, p: int, l: int, ep, el):
    """The part of parent p's `ep` that child l covers, laid out as `el`:
    a view where both are whole, else one level window (shard k of a cut
    child holds the coarse cells under its own shard)."""
    sl = geom.child_slices(p, l)
    if not isinstance(ep, ShardSet) and not isinstance(el, ShardSet):
        return ep[sl]
    shape = tuple(s.stop - s.start for s in sl)
    return read_window(ep, _covered_offset(geom, p, l), shape,
                       el if isinstance(el, ShardSet) else None)


def amr_vcycle(spec: AMRSolverSpec, coefs, r_list, use_lp: bool = False):
    """One AMR V-cycle on the correction equation A e = r, from zero initial
    correction. Downsweep smooths each level with homogeneous CF ghosts and
    replaces the covered part of the next-coarser residual with the
    restricted fine residual; the base level runs the full MG depth chain;
    upsweep prolongs (piecewise-constant) and post-smooths. Entries run
    one after another (sibling patches write DISJOINT covered regions, so
    within-depth order is free).

    A level the mesh cuts comes in and goes out as its shards: the
    smoother, the residual's restriction, the prolongation and the
    post-smooth run on them. Where a child or its parent is cut, the
    restricted residual goes into the parent's covered part by a level
    window write (each shard's restriction into whichever parent shards
    hold it), and the coarse correction under the child, and the CF faces'
    coarse planes of the post-smooth, come by level windows. The base
    level's depth chain stays sharded as mg_vcycle says; nothing here
    splits or joins a level.

    The sibling patches of a batch group (spec.batch_groups, _batchable)
    run as one batch instead (_batch_down / _batch_up: the JAX package's
    vmapped branches), bit for bit what they get one after the other."""
    geom = spec.geom
    nl = spec.num_levels
    r = list(r_list)
    e: list = [None] * nl
    copied: set = set()  # parents whose r is this V-cycle's own copy
    held: dict = {}  # batch group -> its patches' r at their positions

    def own_copy(p):
        if p not in copied:  # r[p] may be the caller's tensor
            r[p] = r[p].clone()
            copied.add(p)

    # downsweep: depths descending — every child restricts into its parent
    # before the parent's depth runs
    for depth in range(geom.max_depth, 0, -1):
        for l in _batchable(spec, coefs, geom.entries_at_depth(depth)):
            if isinstance(l, tuple):
                _batch_down(spec, coefs, l, r, e, own_copy, held, use_lp)
                continue
            ls = spec.level_specs[l]
            cl = _lp(coefs[l], use_lp)
            rl = r[l]
            el = mg.relax(ls, cl, 0, zeros_like(rl), rl, spec.nsmooth)
            p = geom.parent[l]
            own_copy(p)
            # the restricted residual written over the covered part
            if isinstance(el, ShardSet) or isinstance(r[p], ShardSet):
                rc = mg.residual_restrict_homog(
                    ls, cl, 0, el, rl, keep=isinstance(el, ShardSet))
                write_window(r[p], _covered_offset(geom, p, l), rc)
            else:
                mg.residual_restrict_homog(ls, cl, 0, el, rl,
                                           out=r[p][geom.child_slices(p, l)])
            e[l] = el

    e[0] = mg.mg_vcycle(spec.level_specs[0], _lp(coefs[0], use_lp),
                        zeros_like(r[0]), r[0])

    # upsweep: depths ascending — every parent's correction is complete
    # before its children prolong from it
    for depth in range(1, geom.max_depth + 1):
        for l in _batchable(spec, coefs, geom.entries_at_depth(depth)):
            if isinstance(l, tuple):
                _batch_up(spec, coefs, l, r, e, held, use_lp)
                continue
            ls = spec.level_specs[l]
            p = geom.parent[l]
            e[l] = mg.prolong_inc(e[l], _under(geom, p, l, e[p], e[l]))
            # post-smooth with CF ghosts interpolated from the coarse
            # correction (homogeneous ghosts here amplify the CF mismatch
            # by 1/dx^2 per level — see mg.relax_cf)
            e[l] = mg.relax_cf(
                ls, _lp(coefs[l], use_lp), e[l], r[l], spec.nsmooth,
                geom, l, e[p],
            )
    return e


def _local_chunks(mesh, pos) -> list:
    """The indices of a batch group's patches by position, in order, for
    this process's positions only."""
    by_pos: dict = {}
    for i, p in enumerate(pos):
        by_pos.setdefault(p, []).append(i)
    return [idx for p, idx in by_pos.items() if mesh.is_local(p)]


def _batch_down(spec: AMRSolverSpec, coefs, g, r, e, own_copy, held,
                use_lp: bool) -> None:
    """The downsweep of batch group g: its patches smoothed from zero in
    one batch (multigrid.relax_batch) and their residuals restricted in one
    batch (multigrid.residual_restrict_batch), each into its own parent's
    covered part (a view of a whole parent, a level window into a cut
    one). With positions (batch_positions) each chunk of the group is
    computed at its own: the patches' residuals go there (one patch move),
    the restricted ones come to the parents by level windows, and the
    corrections and residuals stay there for _batch_up."""
    geom = spec.geom
    lss = [spec.level_specs[x] for x in g]
    cls = [_lp(coefs[x], use_lp) for x in g]
    par = [geom.parent[x] for x in g]
    for p in par:
        own_copy(p)
    pos = batch_positions(spec, g)
    if pos is None:
        rs = [r[x] for x in g]
        els = mg.relax_batch(lss, cls, 0, [torch.zeros_like(t) for t in rs],
                             rs, spec.nsmooth)
        outs = [None if isinstance(r[p], ShardSet)
                else r[p][geom.child_slices(p, x)] for x, p in zip(g, par)]
        rcs = mg.residual_restrict_batch(lss, cls, 0, els, rs, outs)
        for x, p, el, rc, o in zip(g, par, els, rcs, outs):
            if o is None:
                write_window(r[p], _covered_offset(geom, p, x), rc)
            e[x] = el
        return
    mesh = spec.level_specs[0].mesh
    rs = shards.to_positions(mesh, [r[x] for x in g], pos)
    held[g] = rs
    els: list = [None] * len(g)
    rcs: list = [None] * len(g)
    for idx in _local_chunks(mesh, pos):
        sub = lambda xs: [xs[i] for i in idx]  # noqa: E731
        c_at = [cls[i]["at"] for i in idx]
        out = mg.relax_batch(sub(lss), c_at, 0,
                             [torch.zeros_like(rs[i]) for i in idx], sub(rs),
                             spec.nsmooth)
        rc = mg.residual_restrict_batch(sub(lss), c_at, 0, out, sub(rs))
        for i, el_i, rc_i in zip(idx, out, rc):
            els[i], rcs[i] = el_i, rc_i
    for i, (x, p) in enumerate(zip(g, par)):
        shape = geom.shape(x)
        half = tuple(n // 2 for n in shape)
        write_window(r[p], _covered_offset(geom, p, x), shards.at_position(
            mesh, pos[i], rcs[i], half, dtype=r[x].dtype))
        e[x] = shards.at_position(mesh, pos[i], els[i], shape,
                                  geom.boxes[x].lo, r[x].dtype)


def _batch_up(spec: AMRSolverSpec, coefs, g, r, e, held,
              use_lp: bool) -> None:
    """The upsweep of batch group g, as the JAX package's: each patch's
    coarse correction prolonged and its CF coarse term folded into its
    rhs (entry by entry, each from its parent's correction), then the
    post-smooth in one batch (multigrid.relax_batch). With positions, the
    coarse values come to each patch's position by level windows and the
    corrections go back to the home (one patch move)."""
    geom = spec.geom
    lss = [spec.level_specs[x] for x in g]
    cls = [_lp(coefs[x], use_lp) for x in g]
    par = [geom.parent[x] for x in g]
    pos = batch_positions(spec, g)
    smooth = spec.nsmooth > 0
    us = [mg.prolong_inc(e[x], _under(geom, p, x, e[p], e[x]))
          for x, p in zip(g, par)]
    if pos is None:
        if smooth:
            rhss = [mg.cf_folded_rhs(ls, geom, x, r[x], e[p])
                    for ls, x, p in zip(lss, g, par)]
            us = mg.relax_batch(lss, cls, 0, us, rhss, spec.nsmooth)
        for x, u in zip(g, us):
            e[x] = u
        return
    mesh = spec.level_specs[0].mesh
    rs = held.pop(g)
    k = (0, 0, 0)
    local = [u.shards.get(k) for u in us]
    if smooth:
        rhss = [mg.cf_folded_rhs(ls, geom, x, shards.at_position(
            mesh, q, rx, geom.shape(x), geom.boxes[x].lo, r[x].dtype),
            e[p]).shards.get(k)
            for ls, x, p, q, rx in zip(lss, g, par, pos, rs)]
        for idx in _local_chunks(mesh, pos):
            out = mg.relax_batch([lss[i] for i in idx],
                                 [cls[i]["at"] for i in idx], 0,
                                 [local[i] for i in idx],
                                 [rhss[i] for i in idx], spec.nsmooth)
            for i, u in zip(idx, out):
                local[i] = u
    back = shards.from_positions(mesh, local, pos,
                                 [geom.shape(x) for x in g], r[g[0]].dtype)
    for x, u in zip(g, back):
        e[x] = u


def precond(spec: AMRSolverSpec, coefs, r_list):
    """MultilevelLinearOp::preCond — m_num_mg_iterations AMR-MG iterations,
    each a composite-residual evaluation plus a V-cycle.

    With precond_dtype set, the whole preconditioner runs in reduced
    precision (cast in, cast out); the outer Krylov arithmetic stays in the
    operand dtype. With pre_cond_solver_depth >= 0 the V-cycle chain wraps
    into an inner loosely-converged BiCGStab (deep-precondition mode).
    With a mesh, `r_list` is placed (`place`) and so is the result."""
    check_placed(spec, r_list, "precond")
    if spec.pre_cond_solver_depth >= 0:
        inner = bicgstab(
            functools.partial(composite_apply, spec, coefs),
            r_list,
            precond_fn=functools.partial(_vcycle_precond, spec, coefs),
            dot_fn=functools.partial(red.composite_dot, geom=spec.geom),
            norm_fn=functools.partial(
                red.composite_max_norm, geom=spec.geom
            ),
            tol=1.0e-4,
            max_iter=8 + 4 * spec.pre_cond_solver_depth,
        )
        return inner.x
    return _vcycle_precond(spec, coefs, r_list)


def _vcycle_precond(spec: AMRSolverSpec, coefs, r_list):
    """The plain m_num_mg_iterations-V-cycle preconditioner body."""
    out_dtype = r_list[0].dtype
    use_lp = (
        spec.precond_dtype == "float32" and out_dtype == torch.float64
    )
    if use_lp:
        r_list = [r.to(precision.PRECOND_DTYPE) for r in r_list]
    e = [zeros_like(r) for r in r_list]
    for it in range(spec.num_mg_iterations):
        res = (
            r_list
            if it == 0
            else _composite_residual_coefs(
                spec, coefs, e, r_list, use_lp
            )
        )
        de = amr_vcycle(spec, coefs, res, use_lp)
        e = [a + b for a, b in zip(e, de)]
    if use_lp:
        e = [x.to(out_dtype) for x in e]
    return e


def _composite_residual_coefs(spec, coefs, u_list, rhs_list, use_lp):
    """Composite residual with the (possibly low-precision) coefficient
    set, for the inner precond iterations.

    Routed through the LEVEL residual (mg.residual_homog) rather than
    rhs - composite_apply: on the f32 mixed-precision path the level
    residual dispatches the residual kernel, while the staged form
    (st.residual) is literally rhs - apply_op so the f64 path is unchanged.
    The CF coarse-ghost face term — part of the composite operator
    (composite_apply adds it with scale -beta/dx^2) — is removed afterwards
    with the negated scale: res = (r - L_homog(u)) - T. The reassociation
    shifts CF-face cells at roundoff only, which the outer f64 Krylov
    absorbs."""
    from mg_ic_code_tpu_torch.ops import cf_interp as _cfi

    geom = spec.geom
    out = []
    for l in range(spec.num_levels):
        c = _lp(coefs[l], use_lp)
        res = mg.residual_homog(
            spec.level_specs[l], c, 0, u_list[l], rhs_list[l]
        )
        if l > 0:
            res = _cfi.add_cf_coarse_term(
                res, geom, l, u_list[geom.parent[l]],
                spec.beta / geom.dx[l] ** 2, c["b"][0],
            )
        out.append(res)
    return out


# ------------------------------------------------------------------ solve


def solve_linear(
    spec: AMRSolverSpec,
    coefs,
    rhs_list,
    x0_list=None,
    tol: float | None = None,
    max_iter: int | None = None,
) -> BiCGStabResult:
    """BiCGStab on the composite system, preconditioned by AMR multigrid.

    Inhomogeneous physical BCs are folded into the initial residual (the
    Krylov iteration itself runs with homogeneous BCs), as Chombo's
    solver.define(..., homogeneousBC=false) + solve() arrangement does.
    With a mesh, rhs_list and x0_list are placed (`place`), and so is the
    solution.
    """
    geom = spec.geom
    check_placed(spec, rhs_list, "solve_linear")
    if x0_list is None:
        x0_list = [zeros_like(r) for r in rhs_list]

    r0 = composite_residual(spec, coefs, x0_list, rhs_list, False)

    result = bicgstab(
        functools.partial(composite_apply, spec, coefs),
        r0,
        precond_fn=functools.partial(precond, spec, coefs),
        dot_fn=functools.partial(red.composite_dot, geom=geom),
        norm_fn=functools.partial(red.composite_max_norm, geom=geom),
        tol=spec.tol if tol is None else tol,
        max_iter=spec.max_iter if max_iter is None else max_iter,
        hang=spec.hang,
    )
    x = [a + b for a, b in zip(x0_list, result.x)]
    return result._replace(x=x)
