"""Composite (multi-level) reductions excluding fine-covered regions.

Equivalents of Chombo's computeNorm / computeSum / the volume-weighted
dotProduct of MultilevelLinearOp: cells of a coarse level covered by the
next finer level are excluded, and integral-type reductions are weighted by
each level's cell volume dx^3. Every reduction returns a 0-d tensor on the
operands' device (no host synchronisation here).

A level the mesh cuts (a parallel/shards.ShardSet) is reduced shard by
shard: each shard masks the covered cells of its own region, and its
partial result (a 0-d tensor) goes to the home, where the partials are
combined in a fixed order — the shard keys sorted, x index first, then y,
then z — so that two runs give the same bits. A maximum is the whole
level's exactly; a sum reassociates (((p0 + p1) + p2) + ... instead of one
sum over the level): its value differs from the whole level's by a few
ulps of the sum (tests/test_torch_resident_solve.py reads it).

Over several processes every process gathers every shard's partial (an
all-gather of the bits, parallel/transport.allgather_parts, not an
all-reduce, whose order the backend picks) and adds them in the same key
order: every process holds the one-process result bit for bit, so that
every decision taken on a reduced value (BiCGStab's convergence and
breakdown tests, the Picard stop) is the same on all of them.
"""

from __future__ import annotations

import torch

from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom
from mg_ic_code_tpu_torch.parallel import transport
from mg_ic_code_tpu_torch.parallel.shards import ShardSet


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


def _covered_in(geom: HierarchyGeom, l: int, org, n) -> list:
    """The slices, local to the part [org, org + n) of entry l's array, of
    the cells its children cover there (one per child that reaches it)."""
    out = []
    for c in geom.children(l):
        sl = geom.child_slices(l, c)
        lo = [max(s.start, o) for s, o in zip(sl, org)]
        hi = [min(s.stop, o + m) for s, o, m in zip(sl, org, n)]
        if all(a < b for a, b in zip(lo, hi)):
            out.append(tuple(slice(a - o, b - o)
                             for a, b, o in zip(lo, hi, org)))
    return out


def _mask_shards(u: ShardSet, geom: HierarchyGeom, l: int, fill) -> dict:
    """Every shard of `u` with the covered cells of its region replaced by
    `fill` (the shard itself where none is covered)."""
    out = {}
    for k, s in u.shards.items():
        covered = _covered_in(geom, l, u.origin(k), u.n_loc)
        if covered:
            s = s.clone()
            for sl in covered:
                s[sl] = fill
        out[k] = s
    return out


def mask_covered(u_list, geom: HierarchyGeom, fill=0.0):
    """Values with the fine-covered region of each entry replaced by `fill`
    (identity on childless entries). Multi-patch entries mask the
    (disjoint) region under every child patch; a cut entry is masked
    shard by shard."""
    out = []
    for l, u in enumerate(u_list):
        kids = geom.children(l)
        if not kids:
            out.append(u)
            continue
        if isinstance(u, ShardSet):
            out.append(u.like(_mask_shards(u, geom, l, fill)))
            continue
        u = u.clone()
        for c in kids:
            u[geom.child_slices(l, c)] = fill
        out.append(u)
    return out


def _gathered(u: ShardSet, partials: dict, dtype) -> dict:
    """Every shard's partial (this process's in `partials`) at the home."""
    return transport.allgather_parts(u.mesh, u.pos, partials, dtype, u.home)


def _home_sum(u: ShardSet, partials: dict, dtype):
    """The partials of every shard at the home, added in key order."""
    tot = None
    every = _gathered(u, partials, dtype)
    for k in sorted(every):
        p = every[k]
        tot = p if tot is None else tot + p
    return tot


def _level_sum(u, fn):
    """sum(fn(u)) over a whole level, or the ordered sum of its shards'."""
    if isinstance(u, ShardSet):
        parts = {k: torch.sum(fn(s, k)) for k, s in u.shards.items()}
        dtype = next(iter(parts.values())).dtype if parts else u.dtype
        return _home_sum(u, parts, dtype)
    return torch.sum(fn(u, None))


def composite_max_norm(u_list, geom: HierarchyGeom):
    """Max-norm over valid (uncovered) cells — computeNorm with p=0 /
    BiCGStab normType 0."""
    vals = []
    for u in mask_covered(u_list, geom):
        if isinstance(u, ShardSet):
            every = _gathered(u, {k: torch.max(torch.abs(s)) for k, s in
                                  u.shards.items()}, u.dtype)
            vals += [every[k] for k in sorted(every)]
        else:
            vals.append(torch.max(torch.abs(u)))
    return torch.max(torch.stack(vals))


def composite_norm(u_list, geom: HierarchyGeom, p: int = 2):
    """computeNorm: (sum over valid cells of |u|^p * dx^D)^(1/p); p=0 gives
    the max norm (Chombo convention)."""
    if p == 0:
        return composite_max_norm(u_list, geom)
    tot = 0.0
    for l, u in enumerate(mask_covered(u_list, geom)):
        vol = geom.dx[l] ** 3
        tot = tot + vol * _level_sum(u, lambda x, _: torch.abs(x) ** p)
    return tot ** (1.0 / p)


def composite_sum(u_list, geom: HierarchyGeom):
    """computeSum: volume-weighted integral over valid cells."""
    tot = 0.0
    for l, u in enumerate(mask_covered(u_list, geom)):
        tot = tot + geom.dx[l] ** 3 * _level_sum(u, lambda x, _: x)
    return tot


def composite_dot(u_list, v_list, geom: HierarchyGeom):
    """Volume-weighted inner product over valid cells (MultilevelLinearOp::
    dotProduct semantics)."""
    tot = 0.0
    masked_u = mask_covered(u_list, geom)
    for l, (u, v) in enumerate(zip(masked_u, v_list)):
        shards = v.shards if isinstance(v, ShardSet) else None
        tot = tot + geom.dx[l] ** 3 * _level_sum(
            u, lambda x, k: x * (v if shards is None else shards[k]))
    return tot
