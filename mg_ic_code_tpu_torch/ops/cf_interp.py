"""Coarse-fine interface ghost interpolation.

Replaces Chombo's QuadCFInterp (inhomogeneous fills at level boundaries)
and AMRPoissonOp's homogeneousCFInterp (used inside smoothing). For
refinement ratio 2 the ghost value along the face normal is the quadratic
through the parent coarse cell centre (at -1 in fine-cell units from the
interface) and the first two fine interior cells (+0.5, +1.5), evaluated at
the ghost centre (-0.5):

    ghost = (8/15) * phi_coarse + (2/3) * u0 - (1/5) * u1

The coarse value is first interpolated tangentially to the fine column with
cell-centred quadratics (matching QuadCFInterp's tangential order; one-sided
degradation at clipped slab edges uses edge-replication). The homogeneous
variant zeroes the coarse term.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom

_I = slice(1, -1)

# normal-direction quadratic weights for ref ratio 2 (derived above)
W_COARSE = 8.0 / 15.0
W_U0 = 2.0 / 3.0
W_U1 = -1.0 / 5.0


def _upsample2(c: torch.Tensor, axis: int, order: int = 2) -> torch.Tensor:
    """Refine a coarse axis by 2 with cell-centred interpolation.

    Fine children sit at offsets -/+ dx_c/4 from the coarse centre.
    order=2: quadratic through C[c-1], C[c], C[c+1] (weights 5/32, 30/32,
    -3/32 and mirrored — matching QuadCFInterp's tangential quadratics);
    order=1: linear 3/4-1/4. Input must carry one extra coarse cell on each
    end of `axis` (edge padding is the caller's job); output length is
    2*(n-2).
    """
    c = torch.movedim(c, axis, 0)
    mid, lo, hi = c[1:-1], c[:-2], c[2:]
    if order == 1:
        even = 0.75 * mid + 0.25 * lo  # child at 2c   (offset -dx_c/4)
        odd = 0.75 * mid + 0.25 * hi  # child at 2c+1 (offset +dx_c/4)
    else:
        even = (5.0 / 32.0) * lo + (30.0 / 32.0) * mid - (3.0 / 32.0) * hi
        odd = -(3.0 / 32.0) * lo + (30.0 / 32.0) * mid + (5.0 / 32.0) * hi
    out = torch.stack([even, odd], dim=1).reshape((-1,) + tuple(mid.shape[1:]))
    return torch.movedim(out, 0, axis)


def _coarse_plane_for_face(
    coarse_u: torch.Tensor, geom: HierarchyGeom, level: int, axis: int,
    side: int, wrap: bool = False,
) -> torch.Tensor:
    """Coarse values tangentially interpolated onto the fine ghost plane of
    the (axis, side) face of `level`'s box. Returns a 2D array shaped like
    the face's tangential fine extent.

    `wrap` handles a fine face AT a periodic domain boundary (the CF
    neighbour lives on the far side of the domain): the normal parent
    index wraps modulo the domain extent. Requires the parent level to
    span the domain along `axis`."""
    fine_box = geom.boxes[level]
    crse_box = geom.boxes[geom.parent[level]]
    assert fine_box.coarsenable(2), "fine level box must be 2-coarsenable"

    # parent coarse plane along the normal
    g = fine_box.lo[axis] - 1 if side == 0 else fine_box.hi[axis] + 1
    cg = g // 2
    if wrap:
        crse_dom = geom.domain_boxes[geom.parent[level]]
        if not (crse_box.lo[axis] == crse_dom.lo[axis]
                and crse_box.hi[axis] == crse_dom.hi[axis]):
            raise NotImplementedError(
                "periodic CF ghost through a domain face needs the parent "
                f"level to span the domain along axis {axis} "
                f"(parent box {crse_box}, domain {crse_dom})"
            )
        n_ax = crse_dom.hi[axis] - crse_dom.lo[axis] + 1
        cg = crse_dom.lo[axis] + (cg - crse_dom.lo[axis]) % n_ax
    # guaranteed by HierarchyGeom's nesting-radius check; a violation here
    # would otherwise wrap to the opposite end of the coarse array silently
    assert crse_box.lo[axis] <= cg <= crse_box.hi[axis], (
        f"CF ghost parent cell {cg} outside coarse box {crse_box} "
        f"(axis {axis}, side {side}): fine level not properly nested"
    )

    taxes = [t for t in range(3) if t != axis]
    # coarse tangential ranges grown by 1 for the interpolation stencil
    want_lo = [fine_box.lo[t] // 2 - 1 for t in taxes]
    want_hi = [fine_box.hi[t] // 2 + 1 for t in taxes]

    idx: list = [None, None, None]
    idx[axis] = cg - crse_box.lo[axis]
    pads = []
    for t, wlo, whi in zip(taxes, want_lo, want_hi):
        alo = max(wlo, crse_box.lo[t])
        ahi = min(whi, crse_box.hi[t])
        idx[t] = slice(alo - crse_box.lo[t], ahi - crse_box.lo[t] + 1)
        pads.append((alo - wlo, whi - ahi))

    plane = coarse_u[tuple(idx)]  # 2D, tangential coarse extent (+available pad)
    if any(p != (0, 0) for p in pads):
        # clipped at the coarse box / domain edge: extend with edge values
        flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
        plane = F.pad(plane[None, None], flat, mode="replicate")[0, 0]

    plane = _upsample2(plane, 0)
    plane = _upsample2(plane, 1)
    return plane


def cf_faces(geom: HierarchyGeom, level: int) -> tuple:
    """[(axis, side, wrap)] of this level's faces whose ghost couples to
    the coarser level — the same classification ghosts._inhomog_plane
    applies plane by plane: every non-domain face of a refined level, plus
    (periodic domains) non-spanning faces AT the domain boundary, whose
    coarse neighbour wraps around (wrap=True)."""
    if level == 0:
        return ()
    out = []
    box, dom = geom.boxes[level], geom.domain_boxes[level]
    for axis in range(3):
        spans = box.lo[axis] == dom.lo[axis] and box.hi[axis] == dom.hi[axis]
        for side in (0, 1):
            if geom.bc.periodic:
                if spans:
                    continue
                at_dom = (
                    box.lo[axis] == dom.lo[axis]
                    if side == 0
                    else box.hi[axis] == dom.hi[axis]
                )
                out.append((axis, side, at_dom))
            elif geom.face_is_cf(level, axis, side):
                out.append((axis, side, False))
    return tuple(out)


def add_cf_coarse_term(
    arr: torch.Tensor,
    geom: HierarchyGeom,
    level: int,
    coarse_u: torch.Tensor,
    scale,
    b_coef: torch.Tensor | None = None,
):
    """arr + scale * bCoef * W_COARSE * plane(coarse_u) at every CF face
    cell — the coarse-ghost contribution of the composite operator, which
    is LINEAR in the ghost and therefore separable from the homogeneous
    part: L_full(u, coarse) = L_homog(u) - (beta/dx^2)·bCoef·W_COARSE·plane
    at face cells (pass scale = -beta/dx^2 for L, +beta/dx^2 for residuals
    and rhs folds). Returns a new tensor; `arr` is not modified."""
    faces = cf_faces(geom, level)
    if not faces:
        return arr
    arr = arr.clone()
    for axis, side, wrap in faces:
        plane = _coarse_plane_for_face(
            coarse_u, geom, level, axis, side, wrap=wrap
        ).to(arr.dtype)
        idx: list = [slice(None)] * 3
        idx[axis] = 0 if side == 0 else arr.shape[axis] - 1
        term = scale * W_COARSE * plane
        if b_coef is not None:
            term = term * b_coef[tuple(idx)]
        arr[tuple(idx)] += term
    return arr


def fill_cf_ghosts(
    u_gh: torch.Tensor,
    geom: HierarchyGeom,
    level: int,
    coarse_u: torch.Tensor | None,
) -> torch.Tensor:
    """Fill every coarse-fine face ghost plane of this level's padded array
    (returns a new tensor).

    `coarse_u` is the (ghost-free) coarser-level array; pass None for the
    homogeneous variant (coarse contribution = 0), as used during MG
    smoothing.
    """
    if level == 0:
        return u_gh
    u_gh = u_gh.clone()
    n = u_gh.shape
    for axis in range(3):
        for side in (0, 1):
            if not geom.face_is_cf(level, axis, side):
                continue
            idx: list = [_I, _I, _I]
            in0: list = [_I, _I, _I]
            in1: list = [_I, _I, _I]
            if side == 0:
                idx[axis], in0[axis], in1[axis] = 0, 1, 2
            else:
                m = n[axis]
                idx[axis], in0[axis], in1[axis] = m - 1, m - 2, m - 3
            ghost = W_U0 * u_gh[tuple(in0)] + W_U1 * u_gh[tuple(in1)]
            if coarse_u is not None:
                phi_c = _coarse_plane_for_face(coarse_u, geom, level, axis, side)
                ghost = ghost + W_COARSE * phi_c.to(u_gh.dtype)
            u_gh[tuple(idx)] = ghost
    return u_gh
