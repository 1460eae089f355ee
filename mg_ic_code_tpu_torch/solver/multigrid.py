"""Single-level geometric multigrid: smoothing, depth chain, bottom solve.

Port of the per-level half of Chombo's AMRMultiGrid + the reference
operator's level contract (VariableCoeffPoissonOperator.cpp):
  * relax            — numMGsmooth red-black GSRB sweeps, each colour
                       preceded by a homogeneous ghost refresh (levelGSRB)
  * residual/restrict— fused residual + full-weighting restriction
                       (restrictResidual)
  * mg_vcycle        — V-cycle down the depth chain built by MGnewOp, with
                       coefficients pre-coarsened arithmetically or
                       harmonically
  * bottom_solve     — dense direct solve, or BiCGStab at the coarsest depth
                       with the reference's preCond (dpsi = lambda*rhs then
                       2 GSRB relaxes) as its preconditioner

The f32 (mixed-precision preconditioner) path runs relax / residual /
mg_vcycle through the hand-written kernels of ops/fused_sweeps and
ops/coarse_tower; everything else is the staged ghost-fill body in plain
PyTorch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.ops.ghosts import (
    CF, PHYS_DIRICHLET, FaceKinds, face_kinds, fill_ghosts_homogeneous,
)
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
    # reduced-precision colour passes ("bfloat16"): the field keeps its
    # place, but the kernels sweep at operand precision and
    # composite.make_amr_spec refuses smoother_precision = bfloat16
    smoother_compute: str | None = None

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
    build, so this is exact, not approximate."""
    a_chain, b_chain, lam_chain = [a0], [b0], []
    for d in range(1, spec.ndepths):
        a_chain.append(st.coarsen_coef(a_chain[-1], spec.avg_type))
        b_chain.append(
            None if b0 is None else st.coarsen_coef(b_chain[-1], spec.avg_type)
        )
    for d in range(spec.ndepths):
        lam_chain.append(
            st.gsrb_lambda(a_chain[d], spec.alpha, spec.beta, spec.dx[d])
        )
    coefs = {"a": tuple(a_chain), "b": tuple(b_chain), "lam": tuple(lam_chain)}
    if _use_direct_bottom(spec):
        coefs["binv"] = _bottom_inverse(spec, coefs)
    return coefs


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


def _kernels_allowed(spec: LevelMGSpec, u) -> bool:
    """Kernel smoothers run on the f32 (mixed-precision preconditioner)
    path; 'auto' additionally requires a CUDA tensor ('pallas' forces the
    kernel path, which on a CPU tensor is the kernels' plain versions —
    what the tests use)."""
    if spec.smoother == "xla":
        return False
    if u.dtype != torch.float32:
        return False
    return spec.smoother == "pallas" or u.is_cuda


def relax_kernel_plan(spec: LevelMGSpec, u, n: int):
    """THE single source of truth for the smoother dispatch: the launch
    sequence relax() issues for n homogeneous GSRB sweeps of `u`, as
    (kind, nsweeps) entries. Today one rung: "resident" — the whole-level
    GSRB kernel, which takes every level shape (the card has no residency
    limit) — and "xla", the staged ghost-fill body, for f64 operands or
    `smoother = xla`. relax() executes this plan verbatim."""
    if n <= 0:
        return []
    if _kernels_allowed(spec, u):
        return [("resident", n)]
    return [("xla", n)]


def _level_kw(spec: LevelMGSpec, d: int) -> dict:
    return dict(
        kinds=spec.kinds, rho=spec.rho[d], alpha=spec.alpha, beta=spec.beta,
        dx=spec.dx[d],
    )


def relax(spec: LevelMGSpec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black sweeps with homogeneous ghosts, executed per
    relax_kernel_plan: the GSRB kernel (constant or variable bCoef), or the
    staged body — a ghost refresh and one colour update per pass."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

    for kind, s in relax_kernel_plan(spec, u, n):
        if kind == "resident":
            u = fs.gsrb_relax(
                u.contiguous(), rhs.contiguous(), coefs["a"][d],
                coefs["b"][d], nsweeps=s, lo=spec.boxes[d].lo,
                **_level_kw(spec, d),
            )
        else:
            for i in range(2 * s):
                u = gsrb_half_sweep(spec, coefs, d, u, rhs, i % 2)
    return u


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
        rhs_cf = cf_folded_rhs(spec, geom, level, rhs, coarse_u)
        return relax(spec, coefs, 0, u, rhs_cf, n)

    # variable bCoef: no folded identity — per-pass ghost-fill loop
    from mg_ic_code_tpu_torch.ops.ghosts import fill_ghosts

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
    kernel path, else the staged ghost-fill form."""
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


def apply_homog(spec: LevelMGSpec, coefs: dict, d: int, u):
    return st.apply_op(
        _ghost(spec, d, u), coefs["a"][d], coefs["b"][d],
        spec.alpha, spec.beta, spec.dx[d],
    )


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


def mg_vcycle(spec: LevelMGSpec, coefs: dict, u, rhs, d: int = 0):
    """Correction-scheme gamma-cycle over the depth chain: pre-smooth, fused
    restrict(residual), recurse gamma times (gamma = spec.num_mg: 1 gives
    the V-cycle, 2 the W-cycle — Chombo's numMG), piecewise-constant
    prolong, post-smooth.

    On the kernel path, where the remaining sub-chain is a constant-bCoef
    V-cycle of even shapes, the whole tower below runs as the down-pass and
    up-pass kernels around the bottom solve (ops/coarse_tower) instead of
    the staged per-depth recursion."""
    if _kernels_allowed(spec, u):
        from mg_ic_code_tpu_torch.ops import coarse_tower as ct

        if ct.tower_supported(spec, coefs, d):
            return ct.tower_vcycle(spec, coefs, d, u, rhs)
    u = relax(spec, coefs, d, u, rhs, spec.nsmooth)
    if d + 1 < spec.ndepths:
        rc = st.restrict_residual(
            _ghost(spec, d, u), rhs, coefs["a"][d], coefs["b"][d],
            spec.alpha, spec.beta, spec.dx[d],
        )
        ec = torch.zeros_like(rc)
        for _ in range(max(spec.num_mg, 1)):
            ec = mg_vcycle(spec, coefs, ec, rc, d + 1)
        u = st.prolong_inc(u, ec)
        u = relax(spec, coefs, d, u, rhs, spec.nsmooth)
    else:
        u = bottom_solve(spec, coefs, d, u, rhs)
    return u
