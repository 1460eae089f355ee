"""Physical boundary-condition ghost fills.

Replaces the reference's BCHolder machinery: ParseBC dispatching constant
Dirichlet / constant Neumann per direction per side, with a homogeneous mode
for MG smoothing (reference: SetBCs.cpp:49-131). Periodic wrap replaces
Chombo's periodic ProblemDomain handling.

All fills operate on an already zero-padded array `u_gh` (one ghost ring)
and return a NEW array with the requested faces set. Dirichlet uses the
one-sided quadratic fill (ghost = 8/3 v - 2 u0 + 1/3 u1, exact for
quadratics through the face value); Neumann imposes a constant outward
gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mg_ic_code_tpu_torch.config import BC_DIRICHLET, BC_NEUMANN
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom

_I = slice(1, -1)


def pad1(u: torch.Tensor) -> torch.Tensor:
    """Zero-pad with one ghost ring on every axis."""
    return F.pad(u, (1, 1, 1, 1, 1, 1))


def _set_face(u_gh, axis: int, side: int, values):
    idx = [_I, _I, _I]
    idx[axis] = 0 if side == 0 else u_gh.shape[axis] - 1
    out = u_gh.clone()
    out[tuple(idx)] = values
    return out


def _interior_plane(u_gh, axis: int, side: int, depth: int):
    """Interior plane `depth` cells in from the (axis, side) face."""
    idx = [_I, _I, _I]
    idx[axis] = 1 + depth if side == 0 else u_gh.shape[axis] - 2 - depth
    return u_gh[tuple(idx)]


def dirichlet_face(u_gh, axis: int, side: int, value, order: int = 2):
    """ghost so the face value equals `value`; quadratic by default."""
    u0 = _interior_plane(u_gh, axis, side, 0)
    if order == 1:
        ghost = 2.0 * value - u0
    else:
        u1 = _interior_plane(u_gh, axis, side, 1)
        ghost = (8.0 / 3.0) * value - 2.0 * u0 + (1.0 / 3.0) * u1
    return _set_face(u_gh, axis, side, ghost)


def neumann_face(u_gh, axis: int, side: int, gradient, dx):
    """ghost imposing constant gradient d u / d x_axis = `gradient`."""
    u0 = _interior_plane(u_gh, axis, side, 0)
    sign = -1.0 if side == 0 else 1.0
    return _set_face(u_gh, axis, side, u0 + sign * dx * gradient)


def periodic_wrap_axis(u_gh, axis: int):
    """Wrap ghosts on both faces of an axis (valid when the level box spans
    the whole domain along that axis)."""
    first = _interior_plane(u_gh, axis, 0, 0)
    last = _interior_plane(u_gh, axis, 1, 0)
    u_gh = _set_face(u_gh, axis, 0, last)
    u_gh = _set_face(u_gh, axis, 1, first)
    return u_gh


def fill_physical_ghosts(
    u_gh: torch.Tensor,
    geom: HierarchyGeom,
    level: int,
    homogeneous: bool,
    dirichlet_shift: float = 0.0,
    order: int = 2,
) -> torch.Tensor:
    """Fill all physical (and periodic) faces of this level's padded array.

    `homogeneous=True` uses value/gradient 0 (MG smoothing mode).
    `dirichlet_shift` offsets the Dirichlet value — used when ghosting
    psi = psi_init + accumulated dpsi, whose boundary value is 1 + bc_value
    rather than bc_value.

    Coarse-fine faces are left untouched (see ops/cf_interp.py).
    """
    bc = geom.bc
    dxl = geom.dx[level]
    box, dom = geom.boxes[level], geom.domain_boxes[level]

    for axis in range(3):
        if bc.periodic:
            spans = box.lo[axis] == dom.lo[axis] and box.hi[axis] == dom.hi[axis]
            if spans:
                u_gh = periodic_wrap_axis(u_gh, axis)
            continue  # non-spanning periodic faces are CF faces
        for side in (0, 1):
            if not geom.face_is_physical(level, axis, side):
                continue
            flag = bc.bc_lo[axis] if side == 0 else bc.bc_hi[axis]
            val = 0.0 if homogeneous else bc.bc_value
            if flag == BC_DIRICHLET:
                dval = val if homogeneous else val + dirichlet_shift
                u_gh = dirichlet_face(u_gh, axis, side, dval, order)
            elif flag == BC_NEUMANN:
                u_gh = neumann_face(u_gh, axis, side, val, dxl)
            else:
                raise ValueError(f"bogus bc flag {flag}")
    return u_gh
