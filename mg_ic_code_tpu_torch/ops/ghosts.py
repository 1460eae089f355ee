"""Unified one-ring ghost filling for level arrays.

Composes the physical BC rules, periodic wrap, and coarse-fine
interpolation (ops/cf_interp.py) into the two fills the solver needs:

* `fill_ghosts` — the full inhomogeneous fill used when applying the
  composite operator at AMR level depth 0 (physical BC values + quadratic CF
  interpolation from the coarser level; reference: applyOpI + QuadCFInterp).
* `fill_ghosts_homogeneous` — the cheap fill used inside MG smoothing and
  residual/restriction at every MG depth (reference: levelGSRB's
  homogeneousCFInterp + homogeneous ParseBC).

At MG depth d below an AMR level, the coarse-fine ghost formula generalises:
with rho = dxCrse / dx_depth (in fine-cell units the coarse parent centre
sits at -rho/2), the quadratic homogeneous weights are

    ghost = 2(rho-1)/(1+rho) * u0 + (1-rho)/(3+rho) * u1

(rho=2 gives the familiar 2/3, -1/5). Chombo's AMRPoissonOp keeps m_dxCrse
fixed while m_dx doubles with depth, which is exactly this rho dependence.

Spatial axes are the LAST three of `u` (leading batch axes pass through
the homogeneous fill).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mg_ic_code_tpu_torch.ops import cf_interp as _cf
from mg_ic_code_tpu_torch.config import BC_DIRICHLET, BC_NEUMANN
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom

# face kind tags
PHYS_DIRICHLET = "dirichlet"
PHYS_NEUMANN = "neumann"
PERIODIC = "periodic"
CF = "cf"

FaceKinds = tuple[tuple[str, str], ...]  # [axis][side]


def face_kinds(geom: HierarchyGeom, level: int) -> FaceKinds:
    """Static per-face classification for an AMR level (reused at all MG
    depths below it, whose boxes coarsen but keep the same face types)."""
    out = []
    box, dom = geom.boxes[level], geom.domain_boxes[level]
    for axis in range(3):
        kinds = []
        for side in (0, 1):
            at_dom = (
                box.lo[axis] == dom.lo[axis]
                if side == 0
                else box.hi[axis] == dom.hi[axis]
            )
            if geom.bc.periodic:
                spans = (
                    box.lo[axis] == dom.lo[axis] and box.hi[axis] == dom.hi[axis]
                )
                kinds.append(PERIODIC if spans else CF)
            elif not at_dom:
                kinds.append(CF)
            else:
                flag = geom.bc.bc_lo[axis] if side == 0 else geom.bc.bc_hi[axis]
                if flag == BC_DIRICHLET:
                    kinds.append(PHYS_DIRICHLET)
                elif flag == BC_NEUMANN:
                    kinds.append(PHYS_NEUMANN)
                else:
                    raise ValueError(f"bogus bc flag {flag}")
        out.append(tuple(kinds))
    return tuple(out)


def cf_homog_weights(rho: float) -> tuple[float, float]:
    w0 = 2.0 * (rho - 1.0) / (1.0 + rho)
    w1 = (1.0 - rho) / (3.0 + rho)
    return w0, w1


def ghost_plane(kind: str, u0, u1, rho: float):
    """THE homogeneous one-ring ghost rule from the two interior planes —
    the single shared definition every smoother path imports; a formula fix
    must land here and nowhere else. Dirichlet/Neumann per SetBCs.cpp;
    CF = generalized-rho homogeneous quadratic."""
    if kind == PHYS_DIRICHLET:
        return -2.0 * u0 + (1.0 / 3.0) * u1
    if kind == PHYS_NEUMANN:
        return u0
    if kind == CF:
        w0, w1 = cf_homog_weights(rho)
        return w0 * u0 + w1 * u1
    raise AssertionError(kind)


def _take(g, axis: int, i: int):
    """One plane of `g` along spatial `axis` (0..2, counted over the last
    three dims), keepdims."""
    return g.narrow(g.ndim - 3 + axis, i, 1)


def fill_ghosts_homogeneous(
    u: torch.Tensor, kinds: FaceKinds, rho: float = 2.0
) -> torch.Tensor:
    """Grow `u` by one ghost plane per face, each filled with its
    homogeneous rule: Dirichlet quadratic with face value 0; Neumann zero
    gradient; periodic wrap; CF homogeneous quadratic with coarse term 0.

    Assembled by per-axis concatenation of computed planes: every plane
    depends only on interior data along its own axis, and the edge/corner
    cells (never read by the 7-point stencil family) get the rule applied
    to ghost data."""
    g = u
    for axis in range(3):
        n = g.shape[g.ndim - 3 + axis]
        if kinds[axis][0] == PERIODIC:
            lo, hi = _take(g, axis, n - 1), _take(g, axis, 0)
        else:
            lo = ghost_plane(
                kinds[axis][0], _take(g, axis, 0), _take(g, axis, 1), rho
            )
            hi = ghost_plane(
                kinds[axis][1], _take(g, axis, n - 1), _take(g, axis, n - 2),
                rho,
            )
        g = torch.cat([lo, g, hi], dim=g.ndim - 3 + axis)
    return g


def _edge_pad(plane: torch.Tensor, pads) -> torch.Tensor:
    """Edge-replicate pad of a 3-D array; `pads` = [(lo, hi)] per axis."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(plane[None, None], flat, mode="replicate")[0, 0]


def face_class(geom: HierarchyGeom, level: int, axis: int, side: int):
    """How the depth-0 ghost plane of the (axis, side) face is filled:
    ("wrap", False) a periodic face the level spans; ("cf", wrap) a
    coarse-fine face (any non-spanning periodic face included, `wrap` where
    it sits AT the domain boundary and its coarse neighbour wraps around);
    ("phys", False) a physical face."""
    if geom.bc.periodic:
        box, dom = geom.boxes[level], geom.domain_boxes[level]
        spans = box.lo[axis] == dom.lo[axis] and box.hi[axis] == dom.hi[axis]
        if spans:
            return "wrap", False
        # ANY non-spanning periodic face is a CF face — including one AT
        # the domain boundary, whose coarse neighbour wraps around
        at_dom = (
            box.lo[axis] == dom.lo[axis]
            if side == 0
            else box.hi[axis] == dom.hi[axis]
        )
        return "cf", at_dom
    if geom.face_is_cf(level, axis, side):
        return "cf", False
    return "phys", False


def face_ghost(geom, level, axis, side, cls: str, u0, u1, plane,
               homogeneous_phys, dirichlet_shift):
    """THE depth-0 ghost rule of a CF or physical face from the two
    interior planes u0, u1 (keepdims): the quadratic CF interpolation with
    the coarse term W_COARSE * plane (None: homogeneous CF), or the
    physical Dirichlet / Neumann value fill. The whole level's fill and
    the per-shard one (parallel/halo.fill_ghosts) both apply it."""
    if cls == "cf":
        ghost = _cf.W_U0 * u0 + _cf.W_U1 * u1
        if plane is not None:
            ghost = ghost + _cf.W_COARSE * plane
        return ghost

    # physical face
    bc = geom.bc
    flag = bc.bc_lo[axis] if side == 0 else bc.bc_hi[axis]
    val = 0.0 if homogeneous_phys else bc.bc_value
    if flag == BC_DIRICHLET:
        dval = val if homogeneous_phys else val + dirichlet_shift
        return (8.0 / 3.0) * dval - 2.0 * u0 + (1.0 / 3.0) * u1
    if flag == BC_NEUMANN:
        sign = -1.0 if side == 0 else 1.0
        return u0 + sign * geom.dx[level] * val
    raise ValueError(f"bogus bc flag {flag}")


def _inhomog_plane(
    u, geom, level, axis, side, coarse_u, homogeneous_phys, dirichlet_shift,
    tang_grown,
):
    """One inhomogeneous ghost plane (keepdims) of `u` along (axis, side):
    quadratic CF interpolation from the coarse level, physical
    Dirichlet/Neumann value fills, or periodic wrap. `tang_grown` marks
    tangential axes already grown by one ghost (the CF coarse plane must be
    edge-padded to match)."""
    n = u.shape[axis]
    i0, i1 = (0, 1) if side == 0 else (n - 1, n - 2)
    u0, u1 = _take(u, axis, i0), _take(u, axis, i1)

    cls, wrap = face_class(geom, level, axis, side)
    if cls == "wrap":
        return _take(u, axis, n - 1 if side == 0 else 0)

    plane = None
    if cls == "cf" and coarse_u is not None:
        plane = _cf._coarse_plane_for_face(
            coarse_u, geom, level, axis, side, wrap=wrap
        ).to(u.dtype)
        pads = [(0, 0)] * 3
        for t in range(3):
            if t != axis and tang_grown[t]:
                pads[t] = (1, 1)
        plane = plane.unsqueeze(axis)
        if any(p != (0, 0) for p in pads):
            plane = _edge_pad(plane, pads)
    return face_ghost(geom, level, axis, side, cls, u0, u1, plane,
                      homogeneous_phys, dirichlet_shift)


def fill_ghosts(
    u: torch.Tensor,
    geom: HierarchyGeom,
    level: int,
    coarse_u: torch.Tensor | None,
    homogeneous_phys: bool = False,
    dirichlet_shift: float = 0.0,
) -> torch.Tensor:
    """Full (depth-0) ghost fill: quadratic CF interpolation from the
    coarser level (None for homogeneous CF) plus physical BCs, assembled
    per axis by concatenation like fill_ghosts_homogeneous.

    A level cut over the mesh (a shard set: `u`, or the coarse level of a
    whole `u`) is filled shard by shard (parallel/halo.fill_ghosts): its
    face ghosts are the whole level's, bit for bit; its edge and corner
    ghosts, which no 7-point stencil reads, are not filled."""
    if _cf._placed(u, coarse_u):
        from mg_ic_code_tpu_torch.parallel import halo

        return halo.fill_ghosts(u, geom, level, coarse_u, homogeneous_phys,
                                dirichlet_shift)
    g = u
    tang_grown = [False, False, False]
    for axis in range(3):
        lo = _inhomog_plane(
            g, geom, level, axis, 0, coarse_u, homogeneous_phys,
            dirichlet_shift, tang_grown,
        )
        hi = _inhomog_plane(
            g, geom, level, axis, 1, coarse_u, homogeneous_phys,
            dirichlet_shift, tang_grown,
        )
        g = torch.cat([lo, g, hi], dim=axis)
        tang_grown[axis] = True
    return g
