"""Composite (multi-level) reductions excluding fine-covered regions.

Equivalents of Chombo's computeNorm / computeSum / the volume-weighted
dotProduct of MultilevelLinearOp: cells of a coarse level covered by the
next finer level are excluded, and integral-type reductions are weighted by
each level's cell volume dx^3. Every reduction returns a 0-d tensor on the
operands' device (no host synchronisation here).
"""

from __future__ import annotations

import torch

from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom


def covered_mask(shape, geom: HierarchyGeom, l: int, device=None):
    """Boolean mask of `l`'s cells covered by its children (None when the
    entry has no children)."""
    kids = geom.children(l)
    if not kids:
        return None
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for c in kids:
        mask[geom.child_slices(l, c)] = True
    return mask


def mask_covered(u_list, geom: HierarchyGeom, fill=0.0):
    """Values with the fine-covered region of each entry replaced by `fill`
    (identity on childless entries). Multi-patch entries mask the
    (disjoint) region under every child patch."""
    out = []
    for l, u in enumerate(u_list):
        kids = geom.children(l)
        if not kids:
            out.append(u)
            continue
        u = u.clone()
        for c in kids:
            u[geom.child_slices(l, c)] = fill
        out.append(u)
    return out


def composite_max_norm(u_list, geom: HierarchyGeom):
    """Max-norm over valid (uncovered) cells — computeNorm with p=0 /
    BiCGStab normType 0."""
    vals = [torch.max(torch.abs(u)) for u in mask_covered(u_list, geom)]
    return torch.max(torch.stack(vals))


def composite_norm(u_list, geom: HierarchyGeom, p: int = 2):
    """computeNorm: (sum over valid cells of |u|^p * dx^D)^(1/p); p=0 gives
    the max norm (Chombo convention)."""
    if p == 0:
        return composite_max_norm(u_list, geom)
    tot = 0.0
    for l, u in enumerate(mask_covered(u_list, geom)):
        vol = geom.dx[l] ** 3
        tot = tot + vol * torch.sum(torch.abs(u) ** p)
    return tot ** (1.0 / p)


def composite_sum(u_list, geom: HierarchyGeom):
    """computeSum: volume-weighted integral over valid cells."""
    tot = 0.0
    for l, u in enumerate(mask_covered(u_list, geom)):
        tot = tot + geom.dx[l] ** 3 * torch.sum(u)
    return tot


def composite_dot(u_list, v_list, geom: HierarchyGeom):
    """Volume-weighted inner product over valid cells (MultilevelLinearOp::
    dotProduct semantics)."""
    tot = 0.0
    masked_u = mask_covered(u_list, geom)
    for l, (u, v) in enumerate(zip(masked_u, v_list)):
        tot = tot + geom.dx[l] ** 3 * torch.sum(u * v)
    return tot
