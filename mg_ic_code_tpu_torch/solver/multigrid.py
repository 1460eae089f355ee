"""Single-level geometric multigrid: smoothing, depth chain, bottom solve.

Port of the per-level half of Chombo's AMRMultiGrid + the reference
operator's level contract (VariableCoeffPoissonOperator.cpp):
  * relax            — numMGsmooth red-black GSRB sweeps, each colour
                       preceded by a homogeneous ghost refresh (levelGSRB)
  * residual/restrict— fused residual + full-weighting restriction
                       (restrictResidual; residual_restrict_homog)
  * mg_vcycle        — V-cycle down the depth chain built by MGnewOp, with
                       coefficients pre-coarsened arithmetically or
                       harmonically
  * bottom_solve     — dense direct solve, or BiCGStab at the coarsest depth
                       with the reference's preCond (dpsi = lambda*rhs then
                       2 GSRB relaxes) as its preconditioner

The f32 (mixed-precision preconditioner) path runs relax / residual /
mg_vcycle through the hand-written kernels of ops/fused_sweeps,
ops/wavefront and ops/coarse_tower; everything else is the staged
ghost-fill body in plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.ops.ghosts import (
    CF, PERIODIC, PHYS_DIRICHLET, FaceKinds, face_kinds,
    fill_ghosts_homogeneous,
)
from mg_ic_code_tpu_torch.parallel.shards import ShardSet
from mg_ic_code_tpu_torch.solver.bicgstab import bicgstab


@dataclasses.dataclass(frozen=True)
class LevelMGSpec:
    """Static description of one AMR level's MG structure (hashable)."""

    kinds: FaceKinds
    boxes: tuple[Box, ...]  # depth chain; depth 0 = the AMR level box
    dx: tuple[float, ...]
    rho: tuple[float, ...]  # CF homogeneous-ghost ratio per depth
    alpha: float
    beta: float
    nsmooth: int
    avg_type: str = "arithmetic"
    bottom_iters: int = 60
    bottom_tol: float = 1.0e-12
    # MG cycle shape below this level: 1 = V-cycle, 2 = W-cycle (Chombo's
    # numMG / the params.txt `num_mg` key)
    num_mg: int = 1
    # smoother backend: "auto" uses the hand-written kernels for f32 arrays
    # on a CUDA device; "pallas" (the config value keeps its name) forces
    # the kernel path — on the CPU that is the kernels' plain versions, for
    # tests; "xla" is the staged ghost-fill body and never uses kernels.
    smoother: str = "auto"
    # coarsest-depth solve: "auto" = dense direct solve when the bottom box
    # is small enough, else preconditioned BiCGStab (Chombo's default
    # AMRMultiGrid bottom solver); "direct" / "bicgstab" force one
    bottom: str = "auto"
    # reduced-precision colour passes ("bfloat16", resolved from
    # cfg.smoother_precision by composite.make_amr_spec): the bf16 tier of
    # the GSRB kernel on the "resident" rung (constant b only), of the
    # marches on the "wave" and "multisweep" rungs, of the shard marches at
    # a depth the mesh cuts (parallel/halo) and of the towers; the
    # residual, the restriction, the batch groups, the plain sharded ops
    # and the staged body stay at operand precision, as in the JAX package.
    smoother_compute: str | None = None
    # device mesh (parallel/mesh.Mesh) of the explicit-halo path: where a
    # depth's axes shard usefully (_shard_counts), relax / residual run per
    # shard with halo exchange (parallel/halo.py) — the counterpart of the
    # reference's per-smooth MPI exchange. None = one device.
    mesh: object = None

    @property
    def ndepths(self) -> int:
        return len(self.boxes)


def make_level_spec(
    geom: HierarchyGeom,
    level: int,
    alpha: float,
    beta: float,
    nsmooth: int,
    avg_type: str = "arithmetic",
    with_depths: bool = True,
    min_size: int = 4,
    smoother: str = "auto",
    num_mg: int = 1,
    mesh=None,
    bottom: str = "auto",
    smoother_compute: str | None = None,
) -> LevelMGSpec:
    boxes = geom.mg_depth_boxes(level, min_size) if with_depths else (
        geom.boxes[level],
    )
    dx0 = geom.dx[level]
    # dxCrse stays the AMR-coarse spacing (2*dx0) while depth dx doubles:
    # rho_d = dxCrse / dx_d = 2^(1-d)  (Chombo keeps m_dxCrse fixed per op)
    return LevelMGSpec(
        kinds=face_kinds(geom, level),
        boxes=boxes,
        dx=tuple(dx0 * 2**d for d in range(len(boxes))),
        rho=tuple(2.0 ** (1 - d) for d in range(len(boxes))),
        alpha=alpha,
        beta=beta,
        nsmooth=nsmooth,
        avg_type=avg_type,
        smoother=smoother,
        num_mg=num_mg,
        mesh=mesh,
        bottom=bottom,
        smoother_compute=smoother_compute,
    )


# bottom boxes up to this many cells get the dense direct solve (the
# factorised operator is tiny next to the level arrays: 512^2 f64 = 2 MB)
DIRECT_BOTTOM_MAX_CELLS = 1024


def _use_direct_bottom(spec: LevelMGSpec) -> bool:
    if spec.bottom == "bicgstab":
        return False
    # a (near-)singular bottom operator (alpha ~ 0 with no Dirichlet/CF
    # face, e.g. pure-Poisson periodic) has a (near-)constant null vector:
    # the dense inverse would be Inf/NaN garbage where BiCGStab stays in
    # the range space and degrades gracefully — never densely invert it.
    dx_bot = spec.dx[-1]
    if abs(spec.alpha) <= 1e-10 * abs(spec.beta) / dx_bot**2 and not any(
        k in (PHYS_DIRICHLET, CF) for ax in spec.kinds for k in ax
    ):
        return False
    cells = 1
    for s in spec.boxes[-1].shape:
        cells *= s
    return spec.bottom == "direct" or cells <= DIRECT_BOTTOM_MAX_CELLS


def build_level_coefs(spec: LevelMGSpec, a0, b0=None) -> dict:
    """Coarsen aCoef/bCoef down the depth chain (MGnewOp's CoarseAverage,
    arithmetic or harmonic) and precompute lambda at each depth.

    When the coarsest depth is small, additionally materialise the dense
    bottom operator's inverse: the coarse solve then costs ONE matrix
    product instead of a BiCGStab iteration tower (dozens of tiny
    launch-bound ops). The operator is linear and fixed per coefficient
    build, so this is exact, not approximate.

    aCoef (and bCoef) of a level the mesh cuts arrive as shard sets: the
    chain is coarsened and lambda made shard by shard while the depths are
    cut alike, and resharded (one coefficient join, and a split where the
    next depth is cut otherwise) where the cut changes or ends; nothing is
    cut at depth 0. A cut bottom depth with the dense inverse is joined
    (halo.shard_coefs then cuts it for the sharded ops, as coefficients
    that arrive whole)."""
    a_chain, b_chain, lam_chain = [a0], [b0], []
    for d in range(1, spec.ndepths):
        a_chain.append(_coarsen_coef_at(spec, d, a_chain[-1]))
        b_chain.append(
            None if b0 is None else _coarsen_coef_at(spec, d, b_chain[-1])
        )
    from mg_ic_code_tpu_torch.parallel.shards import per_shard

    for d in range(spec.ndepths):
        lam_chain.append(per_shard(
            st.gsrb_lambda, a_chain[d], spec.alpha, spec.beta, spec.dx[d]))
    coefs = {"a": tuple(a_chain), "b": tuple(b_chain), "lam": tuple(lam_chain)}
    if _use_direct_bottom(spec):
        d = spec.ndepths - 1
        # the dense inverse and the bottom solve take the bottom depth
        # whole: a cut one is joined (one coefficient join each array)
        for k in ("a", "b", "lam"):
            if isinstance(coefs[k][d], ShardSet):
                coefs[k] = coefs[k][:d] + (
                    coefs[k][d].join(what="coef_joins"),)
        coefs["binv"] = _bottom_inverse(spec, coefs)
    if spec.mesh is not None:
        # the cut depths' coefficients on their shards, padded for the halo
        # kernels: made with the coefficients they are cut from, so a new
        # build never reads an old one's
        from mg_ic_code_tpu_torch.parallel import halo

        coefs["shards"] = halo.shard_coefs(spec, coefs)
    return coefs


def _coarsen_coef_at(spec: LevelMGSpec, d: int, c):
    """Depth d's coefficient from depth d-1's: whole, or shard by shard
    where d-1 is cut, resharded to depth d's cut where it differs (one
    coefficient join, then one coefficient split where d is cut)."""
    if not isinstance(c, ShardSet):
        return st.coarsen_coef(c, spec.avg_type)
    box = spec.boxes[d]
    counts = _shard_counts(spec, d)
    if any(n % 2 for n in c.n_loc):
        # a shard's edge inside a coarse cell (15 planes a shard of 60):
        # joined, then coarsened whole (depth d is not cut alike)
        whole = st.coarsen_coef(c.join(what="coef_joins"), spec.avg_type)
    else:
        coarse = c.like({k: st.coarsen_coef(s, spec.avg_type)
                         for k, s in c.shards.items()}, box.shape, box.lo)
        if counts == c.counts:
            return coarse
        whole = coarse.join(what="coef_joins")
    if counts == (1, 1, 1):
        return whole
    return ShardSet.split(whole, spec.mesh, counts, box.lo, "coef_splits")


def _bottom_inverse(spec: LevelMGSpec, coefs: dict):
    """Dense inverse of the homogeneous-BC operator at the coarsest depth,
    built by applying the operator to the whole identity basis at once
    (a leading batch axis) and inverting with `torch.linalg.inv`."""
    d = spec.ndepths - 1
    shape = tuple(spec.boxes[d].shape)
    m = shape[0] * shape[1] * shape[2]
    a = coefs["a"][d]
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    # row i = A @ e_i = column i of A
    cols = apply_homog(spec, coefs, d, eye.reshape((m,) + shape)).reshape(m, m)
    return torch.linalg.inv(cols.T)


def _ghost(spec: LevelMGSpec, d: int, u):
    from mg_ic_code_tpu_torch.parallel.shards import require_whole

    require_whole(u, "the whole-level ghost fill")
    return fill_ghosts_homogeneous(u, spec.kinds, spec.rho[d])


def gsrb_half_sweep(spec: LevelMGSpec, coefs: dict, d: int, u, rhs, color):
    """One colour of a GSRB sweep, preceded by its ghost refresh (levelGSRB's
    per-colour CFInterp/exchange/BC sequence)."""
    u_gh = _ghost(spec, d, u)
    return st.gsrb_color(
        u_gh, rhs, coefs["a"][d], coefs["b"][d], coefs["lam"][d],
        spec.alpha, spec.beta, spec.dx[d], spec.boxes[d].lo, color,
    )


def gsrb_sweep(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    """One full red+black GSRB sweep at depth d."""
    for color in (0, 1):
        u = gsrb_half_sweep(spec, coefs, d, u, rhs, color)
    return u


def _kernels_allowed_for(spec: LevelMGSpec, dtype, device_type: str) -> bool:
    """Kernel smoothers run on the f32 (mixed-precision preconditioner)
    path; 'auto' additionally requires a CUDA tensor ('pallas' forces the
    kernel path, which on a CPU tensor is the kernels' plain versions —
    what the tests use)."""
    if spec.smoother == "xla":
        return False
    if dtype != torch.float32:
        return False
    return spec.smoother == "pallas" or device_type == "cuda"


def _kernels_allowed(spec: LevelMGSpec, u) -> bool:
    return _kernels_allowed_for(spec, u.dtype, u.device.type)


def _shard_counts(spec: LevelMGSpec, d: int) -> tuple[int, int, int]:
    """(x, y, z) shard counts of the explicit-halo path at depth d: an axis
    is cut only where the mesh axis divides this depth's extent into shards
    of at least MIN_LOCAL_NX cells (parallel/mesh.shard_counts). Depths too
    coarse to cut run the single-device path — the analogue of Chombo's
    gather of coarse MG levels onto few ranks."""
    if spec.mesh is None:
        return 1, 1, 1
    from mg_ic_code_tpu_torch.parallel.mesh import shard_counts

    return shard_counts(spec.mesh, spec.boxes[d].shape)


def _shard_count(spec: LevelMGSpec, d: int) -> int:
    """x-slab shard count (the path of halo.sharded_relax): only where
    nothing but x is cut; pencils and blocks go through _shard_counts. The
    JAX package's API: relax and residual_homog dispatch on _shard_counts,
    and only tests/test_torch_parallel.py asks this."""
    sx, sy, sz = _shard_counts(spec, d)
    return sx if sy == 1 and sz == 1 else 1


def plan_for(spec: LevelMGSpec, shape, dtype, device_type: str, n: int,
             const_b: bool = True):
    """relax_kernel_plan in terms of what it looks at: the level's shape,
    dtype and device type and whether bCoef is constant (so the decision
    table can be read without a tensor on the card)."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

    if n <= 0:
        return []
    if not _kernels_allowed_for(spec, dtype, device_type):
        return [("xla", n)]
    if device_type == "cuda" and const_b:
        s = fs.multisweep_plan(tuple(shape), n, spec.kinds)
        if s is not None:
            rung = "multisweep" if spec.kinds[0][0] == PERIODIC else "wave"
            return [(rung, s)] * (n // s)
    return [("resident", n)]


def relax_kernel_plan(spec: LevelMGSpec, u, n: int, const_b: bool = True):
    """THE single source of truth for the smoother dispatch: the launch
    sequence relax() runs for n homogeneous GSRB sweeps of `u`, as
    (kind, nsweeps) entries. Rungs in order of preference:
      "wave"     — the one-launch multisweep kernel through
                   ops/wavefront.wavefront_relax, one launch per chunk of
                   sweeps: a CUDA f32 level with non-periodic x and constant
                   bCoef that ops/fused_sweeps.multisweep_supported takes
                   (too big to stay in L2 between colour passes);
      "multisweep" — the same kernel through
                   ops/fused_sweeps.multisweep_relax: the same kind of
                   level with PERIODIC x (one predicate, two names, so that
                   the counters tell the two paths apart). The JAX
                   package's rungs "tiled", "pipelined" and "flatp" fold
                   into this one: they are three TPU tilings of the function
                   this kernel computes; its "slab", "flat" and "legacy"
                   rungs have no counterpart because `gsrb_relax` takes
                   every shape;
      "resident" — the whole-level GSRB kernel, all sweeps in one launch,
                   which takes every level shape (on a CPU tensor, with
                   `smoother = pallas`, its plain version);
      "xla"      — the staged ghost-fill body, for f64 operands or
                   `smoother = xla`.
    relax() executes this plan verbatim on a depth of one device; a depth
    cut over a mesh (_shard_counts) is routed before it, to parallel/halo."""
    return plan_for(spec, u.shape, u.dtype, u.device.type, n, const_b)


def _level_kw(spec: LevelMGSpec, d: int) -> dict:
    return dict(
        kinds=spec.kinds, rho=spec.rho[d], alpha=spec.alpha, beta=spec.beta,
        dx=spec.dx[d],
    )


def relax(spec: LevelMGSpec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black sweeps with homogeneous ghosts, executed per
    relax_kernel_plan: the wavefront or the multisweep kernel (big levels
    on the card, x open or periodic), the GSRB kernel (constant or variable
    bCoef), or the staged body — a ghost refresh and one colour update per
    pass."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
    from mg_ic_code_tpu_torch.ops import wavefront as wf

    if n <= 0:
        return u
    b = coefs["b"][d]
    if _shard_counts(spec, d) != (1, 1, 1):
        # a depth cut over the mesh: the halo kernels or the plain sharded
        # ops on its shards (parallel/halo.relax; whole tensors are split
        # and joined per call)
        from mg_ic_code_tpu_torch.parallel import halo

        return halo.relax(spec, coefs, d, u, rhs, n)
    for kind, s in relax_kernel_plan(spec, u, n, const_b=b is None):
        if kind in ("wave", "multisweep"):
            # the rungs of constant b: the bf16 tier as the JAX package's
            # fused families take it
            one_launch = (wf.wavefront_relax if kind == "wave"
                          else fs.multisweep_relax)
            u = one_launch(
                u.contiguous(), rhs.contiguous(), coefs["a"][d], nsweeps=s,
                lo=spec.boxes[d].lo, compute_dtype=spec.smoother_compute,
                **_level_kw(spec, d),
            )
        elif kind == "resident":
            # the bf16 tier for constant b only (the JAX package's variable-b
            # resident call takes none)
            u = fs.gsrb_relax(
                u.contiguous(), rhs.contiguous(), coefs["a"][d], b,
                nsweeps=s, lo=spec.boxes[d].lo, **_level_kw(spec, d),
                compute_dtype=spec.smoother_compute if b is None else None,
            )
        else:
            for i in range(2 * s):
                u = gsrb_half_sweep(spec, coefs, d, u, rhs, i % 2)
    return u


def relax_batch(specs, coefs_list, d: int, us, rhss, n: int) -> list:
    """`relax` of same-shape sibling patches (a batch group of
    solver/composite.py: one shape, face kinds, dx and parity, constant
    bCoef, on one device), patch k by specs[k], coefs_list[k], us[k] and
    rhss[k]: the counterpart of the JAX package's vmapped `relax_xla`.
    The group takes the route relax_kernel_plan gives ONE of its patches,
    in its batched form: the GSRB kernel's batch (fs.gsrb_relax_batch, one
    launch for the group), the staged body on the stacked patches (a
    leading patch axis through the ghost fill and the colour update), or,
    on the wave and multisweep rungs, which have no batched form, one
    march launch per patch. Every patch gets bit for bit what `relax`
    gives it alone."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
    from mg_ic_code_tpu_torch.ops import wavefront as wf

    out = list(us)
    if n <= 0:
        return out
    spec = specs[0]
    assert all(c["b"][d] is None for c in coefs_list), (
        "relax_batch: constant bCoef only")
    for kind, s in relax_kernel_plan(spec, out[0], n):
        if kind in ("wave", "multisweep"):
            one_launch = (wf.wavefront_relax if kind == "wave"
                          else fs.multisweep_relax)
            out = [one_launch(
                u.contiguous(), rhs.contiguous(), c["a"][d], nsweeps=s,
                lo=sp.boxes[d].lo, **_level_kw(spec, d))
                for sp, c, u, rhs in zip(specs, coefs_list, out, rhss)]
        elif kind == "resident":
            out = fs.gsrb_relax_batch(
                [u.contiguous() for u in out],
                [rhs.contiguous() for rhs in rhss],
                [c["a"][d] for c in coefs_list], nsweeps=s,
                los=[sp.boxes[d].lo for sp in specs], **_level_kw(spec, d))
        else:
            u = torch.stack(out)
            rhs = torch.stack(list(rhss))
            a = torch.stack([c["a"][d] for c in coefs_list])
            lam = torch.stack([c["lam"][d] for c in coefs_list])
            for i in range(2 * s):
                u = st.gsrb_color(
                    fill_ghosts_homogeneous(u, spec.kinds, spec.rho[d]), rhs,
                    a, None, lam, spec.alpha, spec.beta, spec.dx[d],
                    spec.boxes[d].lo, i % 2)
            out = list(u.unbind(0))
    return out


def residual_restrict_batch(specs, coefs_list, d: int, us, rhss,
                            outs=None) -> list:
    """`residual_restrict_homog` of the patches of a batch group (as
    relax_batch), each restricted residual into outs[k] (e.g. its parent's
    covered part) or a new tensor: the residual kernel's batch on the
    kernel path (fs.residual_restrict_batch, one launch for the group),
    else restrict_full of the staged residual on the stacked patches. Bit
    for bit residual_restrict_homog of each patch."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

    spec = specs[0]
    assert all(c["b"][d] is None for c in coefs_list), (
        "residual_restrict_batch: constant bCoef only")
    if _kernels_allowed(spec, us[0]):
        return fs.residual_restrict_batch(
            [u.contiguous() for u in us], [rhs.contiguous() for rhs in rhss],
            [c["a"][d] for c in coefs_list], outs=outs, **_level_kw(spec, d))
    res = st.residual(
        fill_ghosts_homogeneous(torch.stack(list(us)), spec.kinds,
                                spec.rho[d]),
        torch.stack(list(rhss)), torch.stack([c["a"][d] for c in coefs_list]),
        None, spec.alpha, spec.beta, spec.dx[d])
    rcs = st.restrict_full(res).unbind(0)
    outs = [None] * len(rcs) if outs is None else outs
    return [rc if o is None else o.copy_(rc) for rc, o in zip(rcs, outs)]


def relax_cf(
    spec: LevelMGSpec, coefs: dict, u, rhs, n: int,
    geom: HierarchyGeom, level: int, coarse_u,
):
    """AMR-level relaxation with coarse-fine ghosts interpolated from the
    (now known) coarse correction — the up-sweep post-smooth of AMR-FAC.

    Using homogeneous CF ghosts after prolongation leaves an O(e_coarse)
    ghost error that the operator amplifies by 1/dx^2 per level; with 7
    levels that turns the V-cycle into an amplifier. Physical BCs stay
    homogeneous (correction equation).

    Implementation: the quadratic CF ghost is w0*u0 + w1*u1 + (8/15)*phi_c
    with phi_c CONSTANT during the post-smooth, and the GSRB update is
    linear in the ghost — so the coarse term folds exactly into the rhs
    (rhs += beta/dx^2 * (8/15)*phi_c at CF-face cells) and the smoothing
    itself runs through `relax`'s homogeneous kernels instead of a per-pass
    ghost-fill loop."""
    if n <= 0:
        return u

    b = coefs["b"][0]
    if b is None and level > 0:
        # a level the mesh cuts folds its rhs shard by shard
        rhs_cf = cf_folded_rhs(spec, geom, level, rhs, coarse_u)
        return relax(spec, coefs, 0, u, rhs_cf, n)

    # variable bCoef: no folded identity — per-pass ghost-fill loop; where
    # the level or its parent is cut, shard by shard with the coarse face
    # planes read once (one level window)
    from mg_ic_code_tpu_torch.ops.ghosts import fill_ghosts

    if isinstance(u, ShardSet) or isinstance(coarse_u, ShardSet):
        from mg_ic_code_tpu_torch.ops.cf_interp import cf_faces
        from mg_ic_code_tpu_torch.parallel import halo

        planes = halo.cf_planes(geom, level, coarse_u, u,
                                cf_faces(geom, level))
        for i in range(2 * n):
            u_gh = halo.fill_ghosts(u, geom, level, None, True,
                                    planes=planes)
            if isinstance(u, ShardSet):
                u = halo.gsrb_color(spec, coefs, u, u_gh, rhs, i % 2)
            else:
                u = st.gsrb_color(
                    u_gh, rhs, coefs["a"][0], coefs["b"][0],
                    coefs["lam"][0], spec.alpha, spec.beta, spec.dx[0],
                    spec.boxes[0].lo, i % 2)
        return u

    for i in range(2 * n):
        u_gh = fill_ghosts(
            u, geom, level, coarse_u=coarse_u, homogeneous_phys=True
        )
        u = st.gsrb_color(
            u_gh, rhs, coefs["a"][0], coefs["b"][0], coefs["lam"][0],
            spec.alpha, spec.beta, spec.dx[0], spec.boxes[0].lo, i % 2,
        )
    return u


def cf_folded_rhs(spec: LevelMGSpec, geom: HierarchyGeom, level: int,
                  rhs, coarse_u):
    """Fold the (constant-during-post-smooth) coarse CF ghost term into the
    rhs: rhs += beta/dx^2 * (8/15)*phi_c at CF-face cells — letting the
    smoothing itself run through `relax`'s homogeneous kernels. The face
    walk (cf_interp.cf_faces) includes non-spanning periodic faces at the
    domain boundary, whose coarse neighbour wraps."""
    from mg_ic_code_tpu_torch.ops import cf_interp as _cfi

    b_inv = spec.beta / (spec.dx[0] * spec.dx[0])
    return _cfi.add_cf_coarse_term(rhs, geom, level, coarse_u, b_inv)


def residual_homog(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    """rhs - L(u) with homogeneous ghosts: the residual kernel on the
    kernel path, else the staged ghost-fill form. The one residual kernel
    has no residency limit: it is the counterpart both of the JAX package's
    `fused_sweeps.resident_residual` and, at the big levels, of its
    `pallas_kernels.residual`. A depth cut over a mesh takes the sharded
    residual (plain ops with the exchanged ghost planes, parallel/halo)."""
    if _shard_counts(spec, d) != (1, 1, 1):
        from mg_ic_code_tpu_torch.parallel import halo

        return halo.residual(spec, coefs, d, u, rhs)
    if _kernels_allowed(spec, u):
        from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

        return fs.residual(
            u.contiguous(), rhs.contiguous(), coefs["a"][d], coefs["b"][d],
            **_level_kw(spec, d),
        )
    return st.residual(
        _ghost(spec, d, u), rhs, coefs["a"][d], coefs["b"][d],
        spec.alpha, spec.beta, spec.dx[d],
    )


def residual_restrict_homog(spec: LevelMGSpec, coefs: dict, d: int, u, rhs,
                            out=None, keep: bool = False):
    """restrict_full(rhs - L(u)) with homogeneous ghosts, into `out` (an
    (nx/2, ny/2, nz/2) tensor or view, e.g. the covered part of a parent
    level) or a new tensor: on the kernel path of a depth on one device the
    residual kernel's restricted form (one launch, the fine residual never
    written), else restrict_full of residual_homog. A depth cut over a
    mesh restricts every shard's residual on its own device
    (parallel/halo.residual_restrict: shard sets in, the next depth's shard
    set out where it is cut alike). The one dispatch of both places that
    restrict a residual: the AMR downsweep and the staged depths of
    mg_vcycle. `keep` (a cut depth's shard sets): the restricted shards
    stay on their devices (halo.residual_restrict)."""
    if _shard_counts(spec, d) != (1, 1, 1):
        from mg_ic_code_tpu_torch.parallel import halo

        return halo.residual_restrict(spec, coefs, d, u, rhs, out=out,
                                      keep=keep)
    if _kernels_allowed(spec, u):
        from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

        return fs.residual_restrict(
            u.contiguous(), rhs.contiguous(), coefs["a"][d], coefs["b"][d],
            out=out, **_level_kw(spec, d),
        )
    rc = st.restrict_full(residual_homog(spec, coefs, d, u, rhs))
    return rc if out is None else out.copy_(rc)


def apply_homog(spec: LevelMGSpec, coefs: dict, d: int, u):
    """L(u) with homogeneous ghosts; a depth held as a shard set shard by
    shard (parallel/halo.apply_homog: bit for bit the whole level's)."""
    if isinstance(u, ShardSet):
        from mg_ic_code_tpu_torch.parallel import halo

        return halo.apply_homog(spec, coefs, d, u)
    return st.apply_op(
        _ghost(spec, d, u), coefs["a"][d], coefs["b"][d],
        spec.alpha, spec.beta, spec.dx[d],
    )


def jacobi_sweep(spec: LevelMGSpec, coefs: dict, d: int, u, rhs,
                 weight: float = 0.5):
    """Weighted Jacobi relaxation: u += w * lambda * (rhs - L(u)) — the
    reference's levelJacobi alternative smoother
    (VariableCoeffPoissonOperator.cpp:360-385, weight 0.5). No path of the
    solve calls it, as in the JAX package."""
    res = residual_homog(spec, coefs, d, u, rhs)
    return u + weight * coefs["lam"][d] * res


def level_precond(spec: LevelMGSpec, coefs: dict, d: int, rhs):
    """The reference's smoother-grade preconditioner: u = lambda * rhs
    followed by 2 GSRB relaxations (preCond)."""
    u = coefs["lam"][d] * rhs
    return relax(spec, coefs, d, u, rhs, 2)


def bottom_solve(spec: LevelMGSpec, coefs: dict, d: int, u, rhs):
    """Coarsest-depth solve: dense direct solve when precomputed (small
    bottom boxes — one matrix product), else BiCGStab preconditioned by the
    level preCond (Chombo's AMRMultiGrid default bottom solver is
    BiCGStab)."""
    res = residual_homog(spec, coefs, d, u, rhs)
    if coefs.get("binv") is not None:
        # one step of iterative refinement: e <- e + X(r - A e) contracts
        # the error by ||I - AX|| per step, so an inverse carried in
        # reduced precision still yields a near-exact bottom solve
        binv = coefs["binv"]
        e = (binv @ res.reshape(-1)).reshape(res.shape)
        r2 = res - apply_homog(spec, coefs, d, e)
        e = e + (binv @ r2.reshape(-1)).reshape(res.shape)
        return u + e
    # f32 (mixed-precision preconditioner) cannot reach the f64 bottom
    # tolerance; stop at what the precision supports
    tol = spec.bottom_tol if u.dtype == torch.float64 else max(
        spec.bottom_tol, 1.0e-6
    )
    out = bicgstab(
        functools.partial(apply_homog, spec, coefs, d),
        res,
        precond_fn=functools.partial(level_precond, spec, coefs, d),
        tol=tol,
        max_iter=spec.bottom_iters,
    )
    return u + out.x


def prolong_inc(u, ec):
    """u + the piecewise-constant prolongation of the coarse correction:
    shard by shard where u is a shard set (parallel/halo.prolong_inc)."""
    if isinstance(u, ShardSet):
        from mg_ic_code_tpu_torch.parallel import halo

        return halo.prolong_inc(u, ec)
    return st.prolong_inc(u, ec)


def mg_vcycle(spec: LevelMGSpec, coefs: dict, u, rhs, d: int = 0):
    """Correction-scheme gamma-cycle over the depth chain: pre-smooth, fused
    restrict(residual), recurse gamma times (gamma = spec.num_mg: 1 gives
    the V-cycle, 2 the W-cycle — Chombo's numMG), piecewise-constant
    prolong, post-smooth.

    On the kernel path, where the remaining sub-chain is a constant-bCoef
    V-cycle of even shapes, the whole tower below runs as the down-pass and
    up-pass kernels around the bottom solve (ops/coarse_tower) instead of
    the staged per-depth recursion. The tower runs only where no depth from
    d down is cut over a mesh.

    A depth cut over a mesh stays on its shards (parallel/shards.ShardSet)
    through the smoother, the residual and its restriction: shard sets in,
    shard sets out, and the next depth's shards stay where they are when it
    is cut alike. Where the next depth is not cut, or is cut otherwise, the
    restricted residual is joined once and the chain goes on whole; a cut
    depth taken up whole (u and rhs tensors) is split on entry and joined
    on return."""
    if _shard_counts(spec, d) != (1, 1, 1) and not isinstance(u, ShardSet):
        from mg_ic_code_tpu_torch.parallel import halo

        return mg_vcycle(spec, coefs, halo.split_level(spec, d, u),
                         halo.split_level(spec, d, rhs), d).join()
    if _kernels_allowed(spec, u) and all(
        _shard_counts(spec, dd) == (1, 1, 1)
        for dd in range(d, spec.ndepths)
    ):
        from mg_ic_code_tpu_torch.ops import coarse_tower as ct

        if ct.tower_supported(spec, coefs, d, u.element_size()):
            return ct.tower_vcycle(spec, coefs, d, u, rhs)
    u = relax(spec, coefs, d, u, rhs, spec.nsmooth)
    if d + 1 < spec.ndepths:
        rc = residual_restrict_homog(spec, coefs, d, u, rhs)
        ec = (rc.zeros_like() if isinstance(rc, ShardSet)
              else torch.zeros_like(rc))
        for _ in range(max(spec.num_mg, 1)):
            ec = mg_vcycle(spec, coefs, ec, rc, d + 1)
        u = prolong_inc(u, ec)
        u = relax(spec, coefs, d, u, rhs, spec.nsmooth)
    elif isinstance(u, ShardSet):
        # a bottom depth the mesh cuts: the direct solve takes it whole
        from mg_ic_code_tpu_torch.parallel import halo

        u = halo.split_level(spec, d, bottom_solve(spec, coefs, d, u.join(),
                                                   rhs.join()))
    else:
        u = bottom_solve(spec, coefs, d, u, rhs)
    return u
