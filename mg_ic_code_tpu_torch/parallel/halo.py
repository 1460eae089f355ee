"""Explicit halo exchange for levels cut into shards over a device mesh.

Port of the JAX package's `parallel/halo.py`: the counterpart of the
reference's per-smooth MPI ghost exchange (`dpsi.exchange(...)` before
every GSRB colour, VariableCoeffPoissonOperator.cpp:301). Each shard owns a
block of the dense level; before each half-sweep (plain ops) or each chunk
of sweeps (the halo kernels) its neighbours' boundary planes are copied to
it, while the faces of the domain take their physical / coarse-fine rule
locally. The GSRB parity stays GLOBAL: every shard offsets its
checkerboard by its origin in the level.

Where the JAX package runs one body per device under `shard_map` and moves
planes with `ppermute`, this module loops over the shards. The two keep
the same semantics:
  * every exchange of a step is made before any shard's update, and each
    plane a shard receives is a fresh COPY on its device (a shard's later
    update can never change what its neighbour read, even where two shards
    share one device);
  * `jnp.where(idx == 0, fill, ...)` on the shard index becomes a branch.

The solver's entry points (`relax`, `residual`, `residual_restrict`) take
a depth of a level as a `ShardSet` (parallel/shards.py) and return one:
the preconditioner keeps every depth the mesh cuts on its shards between
calls, and only the pads cross between shards. Handed whole tensors they
split them, work on the shards and join the result (the per-call form,
counted like any other split and join). Coefficients come cut and padded
from `shard_coefs`, once per coefficient build (multigrid.build_level_coefs
stores them under coefs["shards"]); coefficients that carry none are cut
per call. Shards are keyed by their (ix, iy, iz) position; a mesh axis
that does not cut the level puts every shard at its coordinate 0 (the JAX
package's replicas along that axis compute the same values, and the port
computes them once).

Over several processes (parallel/mesh.py) each process runs the loops over
its own shards, and every exchange is one plan of copies that every
process derives from the layout (`lay`: a shard set, or shards.Layout —
the mesh, the counts, this process's devices and every shard's position)
and carries out through parallel/transport.py: the planes a shard reads
from another process's shard arrive as messages, all of one exchange in
one batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.ops.ghosts import PERIODIC, ghost_plane
from mg_ic_code_tpu_torch.parallel.mesh import AXIS
from mg_ic_code_tpu_torch.parallel import transport
from mg_ic_code_tpu_torch.parallel.shards import (
    ShardSet, copy_to, count_event, layout, parts, window,
)

_I = slice(1, -1)


def _neighbour(k, axis: int, step: int, nshards: int):
    k = list(k)
    k[axis] = (k[axis] + step) % nshards
    return tuple(k)


# ------------------------------------------------------------ ghost rules


def _bc_plane(kind: str, u0, u1, rho: float):
    """Homogeneous ghost plane from the two interior planes (the single
    shared rule, ops/ghosts.ghost_plane)."""
    return ghost_plane(kind, u0, u1, rho)


def _fill_local_yz(u_gh, kinds, rho: float, x_slice=_I):
    """Fill the y and z ghost faces of one shard's padded array, in place
    (entirely shard-local). `x_slice` selects the x rows carrying real data
    (slice(1,-1) when the x axis is halo-padded, slice(None) when not)."""
    for axis in (1, 2):
        if kinds[axis][0] == PERIODIC:
            idx0 = [x_slice, _I, _I]
            idx1 = [x_slice, _I, _I]
            src0 = [x_slice, _I, _I]
            src1 = [x_slice, _I, _I]
            idx0[axis], src0[axis] = 0, u_gh.shape[axis] - 2
            idx1[axis], src1[axis] = u_gh.shape[axis] - 1, 1
            u_gh[tuple(idx0)] = u_gh[tuple(src0)]
            u_gh[tuple(idx1)] = u_gh[tuple(src1)]
            continue
        for side in (0, 1):
            kind = kinds[axis][side]
            i0 = [x_slice, _I, _I]
            i1 = [x_slice, _I, _I]
            tgt = [x_slice, _I, _I]
            if side == 0:
                tgt[axis], i0[axis], i1[axis] = 0, 1, 2
            else:
                m = u_gh.shape[axis]
                tgt[axis], i0[axis], i1[axis] = m - 1, m - 2, m - 3
            u_gh[tuple(tgt)] = _bc_plane(kind, u_gh[tuple(i0)],
                                         u_gh[tuple(i1)], rho)
    return u_gh


def _sharded_ghost(u_locs: dict, kinds, rho: float, nshards: int,
                   periodic_x: bool, lay) -> dict:
    """Each shard's one-ring ghosted array: x neighbour planes (the 1-D
    instance of _axis_planes: mesh-edge shards take the physical / CF rule)
    and local y/z fills."""
    from_left, from_right = _axis_planes(
        u_locs, 0, kinds[0][0], kinds[0][1], rho, periodic_x, nshards, lay)
    out = {}
    for k, u_loc in u_locs.items():
        u_ext = torch.cat([from_left[k], u_loc, from_right[k]], dim=0)
        out[k] = _fill_local_yz(F.pad(u_ext, (1, 1, 1, 1)), kinds, rho)
    return out


def _pad_yz(block, kinds, rho: float):
    """Pad axes 1, 2 by one and fill those faces with their ghost rules (no
    x padding; x neighbours are supplied separately)."""
    return _fill_local_yz(F.pad(block, (1, 1, 1, 1)), kinds, rho,
                          x_slice=slice(None))


def _ring_exchange_axis(shards: dict, axis: int, nshards: int, lay,
                        depth: int = 1, wrap: bool = True):
    """The `depth`-deep boundary slabs of every shard along array `axis`,
    each copied to the neighbour that reads it: (from_lo, from_hi), where
    from_lo[k] is the top of k's lower neighbour along the ring and
    from_hi[k] the bottom of its upper one (this process's shards' k;
    `shards` holds this process's shards, all of one shape). Without
    `wrap` (the axis is not periodic) the first shard gets no from_lo and
    the last no from_hi: the caller fills the domain faces. All copies are
    made before anything is updated. One pad exchange."""
    count_event(lay.mesh, "pad_exchanges")
    from_lo, from_hi = {}, {}
    # a slab's shape and dtype, for a receiver: its own shard's (a process
    # with no shard here is neither end of any of these transfers)
    first = next(iter(shards.values()), None)
    shape = dtype = None
    if first is not None:
        shape = tuple(depth if ax == axis else n
                      for ax, n in enumerate(first.shape))
        dtype = first.dtype
    plan = []

    def slab(got, k, src, start):
        def get():
            t = shards[src]
            return t.narrow(axis, t.shape[axis] - depth if start else 0,
                            depth)
        return transport.Transfer(
            lay.pos[src], lay.pos[k], shape, dtype, get,
            lambda t: got.__setitem__(k, copy_to(t, lay.devs[k])))

    for k in sorted(lay.pos):
        if wrap or k[axis] > 0:
            plan.append(slab(from_lo, k, _neighbour(k, axis, -1, nshards),
                             True))
        if wrap or k[axis] < nshards - 1:
            plan.append(slab(from_hi, k, _neighbour(k, axis, 1, nshards),
                             False))
    transport.exchange(lay.mesh, plan)
    return from_lo, from_hi


def _axis_planes(shards: dict, axis: int, kind_lo: str, kind_hi: str,
                 rho: float, periodic: bool, nshards: int, lay):
    """The two ghost planes of every shard along `axis`: the neighbours'
    planes over the ring when the axis is cut (nshards > 1), else the local
    wrap / BC rule; shards at a non-periodic domain face take the physical
    or CF rule there instead of the wrapped plane."""
    def pl(arr, i0):
        return arr.narrow(axis, i0, 1)

    if nshards > 1:
        from_lo, from_hi = _ring_exchange_axis(shards, axis, nshards, lay,
                                               wrap=periodic)
        if not periodic:
            for k, arr in shards.items():
                n = arr.shape[axis]
                if k[axis] == 0:
                    from_lo[k] = _bc_plane(kind_lo, pl(arr, 0), pl(arr, 1),
                                           rho)
                if k[axis] == nshards - 1:
                    from_hi[k] = _bc_plane(kind_hi, pl(arr, n - 1),
                                           pl(arr, n - 2), rho)
        return from_lo, from_hi
    lo, hi = {}, {}
    for k, arr in shards.items():
        n = arr.shape[axis]
        if periodic:
            lo[k], hi[k] = pl(arr, n - 1), pl(arr, 0)
        else:
            lo[k] = _bc_plane(kind_lo, pl(arr, 0), pl(arr, 1), rho)
            hi[k] = _bc_plane(kind_hi, pl(arr, n - 1), pl(arr, n - 2), rho)
    return lo, hi


def _block_ghost(spec, d: int, counts, uu: dict, lay) -> dict:
    """Each shard's one-ring ghosted array on a pencil or block cut: the
    one-cell planes of every cut axis exchanged one axis after the other on
    the progressively extended array, so corner and edge values ride along
    (the reference's full-boundary Copier exchange,
    VariableCoeffPoissonOperatorFactory.cpp:82-96)."""
    kinds, rho = spec.kinds, spec.rho[d]
    ext = uu
    for ax in range(3):
        lo, hi = _axis_planes(ext, ax, kinds[ax][0], kinds[ax][1], rho,
                              kinds[ax][0] == PERIODIC, counts[ax], lay)
        ext = {k: torch.cat([lo[k], e, hi[k]], dim=ax)
               for k, e in ext.items()}
    return ext


# ------------------------------------------------------- plain level ops


def _slab_ops(spec, d: int, nshards: int, lay, nsweeps: int,
              overlap: bool = True):
    """The x-slab plain ops on shard dicts: (relax_shards(a, lam, uu, rhs),
    residual_shards(a, uu, rhs)), see make_sharded_level_ops."""
    kinds = spec.kinds
    periodic_x = kinds[0][0] == PERIODIC
    rho = spec.rho[d]
    dx = spec.dx[d]
    alpha, beta = spec.alpha, spec.beta
    inv_dx2 = 1.0 / (dx * dx)
    box = spec.boxes[d]
    nx_loc = box.shape[0] // nshards
    assert box.shape[0] % nshards == 0, "x extent must divide the mesh"
    overlap = overlap and nx_loc >= 3  # need a nonempty interior

    def lo_sum(k):
        return sum(box.lo) + k[0] * nx_loc

    def masked(upd, uc, row0, color):
        mask = st.color_mask(uc.shape, (row0, 0, 0), color, device=uc.device)
        return torch.where(mask, upd, uc)

    def update(uc, x_lo, x_hi, a_s, lam_s, rhs_s):
        """GSRB update of a row block given its x-neighbour planes."""
        gh = _pad_yz(uc, kinds, rho)
        yz = (gh[:, 2:, 1:-1] + gh[:, :-2, 1:-1]
              + gh[:, 1:-1, 2:] + gh[:, 1:-1, :-2])
        lap = (x_lo + x_hi + yz - 6.0 * uc) * inv_dx2
        lofu = alpha * a_s * uc - beta * lap
        return uc - lam_s * (lofu - rhs_s)

    def half_plain(i, uu, a, lam, rhs):
        u_gh = _sharded_ghost(uu, kinds, rho, nshards, periodic_x, lay)
        out = {}
        for k, u in uu.items():
            lofu = st.apply_op(u_gh[k], a[k], None, alpha, beta, dx)
            out[k] = masked(u - lam[k] * (lofu - rhs[k]), u, lo_sum(k), i % 2)
        return out

    def half_overlap(i, uu, a, lam, rhs):
        color = i % 2
        # 1. the exchange of the boundary planes
        from_left, from_right = _axis_planes(
            uu, 0, kinds[0][0], kinds[0][1], rho, periodic_x, nshards, lay)
        out = {}
        for k, u in uu.items():
            s0 = lo_sum(k)
            # 2. interior rows 1..m-2: local
            inner = masked(update(u[1:-1], u[:-2], u[2:], a[k][1:-1],
                                  lam[k][1:-1], rhs[k][1:-1]),
                           u[1:-1], s0 + 1, color)
            # 3. the boundary rows consume the halo planes
            first = masked(update(u[:1], from_left[k], u[1:2], a[k][:1],
                                  lam[k][:1], rhs[k][:1]), u[:1], s0, color)
            last = masked(update(u[-1:], u[-2:-1], from_right[k], a[k][-1:],
                                 lam[k][-1:], rhs[k][-1:]),
                          u[-1:], s0 + nx_loc - 1, color)
            out[k] = torch.cat([first, inner, last], dim=0)
        return out

    half = half_overlap if overlap else half_plain

    def relax_shards(a, lam, uu, rhs):
        for i in range(2 * nsweeps):
            uu = half(i, uu, a, lam, rhs)
        return uu

    def residual_shards(a, uu, rhs):
        u_gh = _sharded_ghost(uu, kinds, rho, nshards, periodic_x, lay)
        return {k: st.residual(u_gh[k], rhs[k], a[k], None, alpha, beta, dx)
                for k in uu}

    return relax_shards, residual_shards


def _block_ops(spec, d: int, counts, lay, nsweeps: int):
    """The pencil / block plain ops on shard dicts, bCoef `b` None or
    variable: (relax_shards(a, b, lam, uu, rhs),
    residual_shards(a, b, uu, rhs)), see make_sharded_level_ops_2d."""
    alpha, beta, dx = spec.alpha, spec.beta, spec.dx[d]
    box = spec.boxes[d]
    n_loc = tuple(box.shape[ax] // counts[ax] for ax in range(3))

    def lo_sum(k):
        return sum(box.lo) + sum(k[ax] * n_loc[ax] for ax in range(3)
                                 if counts[ax] > 1)

    def relax_shards(a, b, lam, uu, rhs):
        for i in range(2 * nsweeps):
            u_gh = _block_ghost(spec, d, counts, uu, lay)
            out = {}
            for k, uc in uu.items():
                lofu = st.apply_op(u_gh[k], a[k], None if b is None else b[k],
                                   alpha, beta, dx)
                upd = uc - lam[k] * (lofu - rhs[k])
                mask = st.color_mask(uc.shape, (lo_sum(k), 0, 0), i % 2,
                                     device=uc.device)
                out[k] = torch.where(mask, upd, uc)
            uu = out
        return uu

    def residual_shards(a, b, uu, rhs):
        u_gh = _block_ghost(spec, d, counts, uu, lay)
        return {k: st.residual(u_gh[k], rhs[k], a[k],
                               None if b is None else b[k], alpha, beta, dx)
                for k in uu}

    return relax_shards, residual_shards


def make_sharded_level_ops(spec, mesh, d: int = 0, nsweeps: int | None = None,
                           overlap: bool = True):
    """Relax / residual for depth `d` of a level cut into x-slabs over the
    mesh's x axis: (relax_fn(a, lam, u, rhs), residual_fn(a, u, rhs)), each
    taking and returning whole levels (the JAX package's signature: every
    call splits its operands and joins its result); relax runs `nsweeps`
    (default spec.nsmooth) red+black sweeps, each colour after a plane
    exchange.

    With `overlap=True` each half-sweep updates the interior rows 1..m-2
    (no halo needed) apart from the two boundary rows, which consume the
    exchanged planes: on the JAX package's devices the form that lets the
    exchange hide under the interior work. Here the shards run one after
    the other, so it hides nothing; it is the default because it is the
    JAX package's, whose order of additions it keeps. `overlap=False` (one
    ghosted update per shard) differs only in that order: no path of the
    port asks for it, and tests/test_torch_parallel.py holds both forms
    against the JAX package's."""
    if nsweeps is None:
        nsweeps = spec.nsmooth
    counts = (mesh.shape[AXIS], 1, 1)
    lo = spec.boxes[d].lo
    relax_s, residual_s = _slab_ops(spec, d, counts[0], layout(mesh, counts),
                                    nsweeps, overlap)

    def cut(t, what="level_splits"):
        return ShardSet.split(t, mesh, counts, lo, what)

    def relax_fn(a, lam, u, rhs):
        uu = cut(u)
        return uu.like(relax_s(cut(a, "coef_splits").shards,
                               cut(lam, "coef_splits").shards, uu.shards,
                               cut(rhs).shards)).join()

    def residual_fn(a, u, rhs):
        uu = cut(u)
        return uu.like(residual_s(cut(a, "coef_splits").shards, uu.shards,
                                  cut(rhs).shards)).join()

    return relax_fn, residual_fn


def make_sharded_level_ops_2d(spec, mesh, d: int = 0,
                              nsweeps: int | None = None,
                              with_b: bool = False):
    """Relax / residual for a level cut over a 2-D (x, y) pencil or 3-D
    (x, y, z) block mesh, taking and returning whole levels: per half-sweep
    the one-cell boundary planes of every cut axis are exchanged
    (_block_ghost).

    Axes whose shard count is 1 (mesh axis absent, too small, or not
    dividing: multigrid._shard_counts) are treated locally. `with_b`
    widens the signatures to a variable bCoef, which is cell-centred and
    needs no halo of its own: relax_fn(a, b, lam, u, rhs),
    residual_fn(a, b, u, rhs); else relax_fn(a, lam, u, rhs),
    residual_fn(a, u, rhs)."""
    from mg_ic_code_tpu_torch.solver.multigrid import _shard_counts

    if nsweeps is None:
        nsweeps = spec.nsmooth
    counts = _shard_counts(spec, d)
    lo = spec.boxes[d].lo
    relax_s, residual_s = _block_ops(spec, d, counts, layout(mesh, counts),
                                     nsweeps)

    def cut(t, what="level_splits"):
        return None if t is None else ShardSet.split(t, mesh, counts, lo,
                                                     what)

    def coef(t):
        return None if t is None else cut(t, "coef_splits").shards

    def relax_body(a, b, lam, u, rhs):
        uu = cut(u)
        return uu.like(relax_s(coef(a), coef(b), coef(lam), uu.shards,
                               cut(rhs).shards)).join()

    def residual_body(a, b, u, rhs):
        uu = cut(u)
        return uu.like(residual_s(coef(a), coef(b), uu.shards,
                                  cut(rhs).shards)).join()

    if with_b:
        return relax_body, residual_body
    return (lambda a, lam, u, rhs: relax_body(a, None, lam, u, rhs),
            lambda a, u, rhs: residual_body(a, None, u, rhs))


# ------------------------------------------------------- the halo kernels


def _exchange_rows(shards: dict, H: int, nshards: int, periodic_x: bool,
                   lay, lo_fill=None, hi_fill=None) -> dict:
    """(2H, ny, nz) halo pad of every x-slab: rows [0,H) = the lower
    neighbour's top H rows, rows [H,2H) = the upper neighbour's bottom H
    rows (the deep-halo generalisation of the reference's face Copiers).
    Unless x is periodic (the ring wrap IS the boundary rule), the first
    shard takes `lo_fill(its shard)` below and the last `hi_fill(its
    shard)` above."""
    from_left, from_right = _ring_exchange_axis(shards, 0, nshards, lay,
                                                depth=H, wrap=periodic_x)
    if not periodic_x:
        for k, s in shards.items():
            if k[0] == 0:
                from_left[k] = lo_fill(s)
            if k[0] == nshards - 1:
                from_right[k] = hi_fill(s)
    return {k: torch.cat([from_left[k], from_right[k]], dim=0)
            for k in shards}


def _metas(devs: dict, counts, n_loc, periodic_x: bool) -> dict:
    """The halo kernels' meta of every shard: [lo_edge, hi_edge, x_off,
    y_off] — which x faces are the domain's (none where x is periodic: the
    pads carry the wrap) and the shard's origin in the level."""
    edge = 0 if periodic_x else 1
    sx = counts[0]
    return {k: (edge if k[0] == 0 else 0, edge if k[0] == sx - 1 else 0,
                k[0] * n_loc[0], k[1] * n_loc[1]) for k in devs}


def _u_rows(u_s: dict, kinds, rho: float, H: int, nshards: int,
            lay) -> dict:
    """The u pads of every x-slab for a chunk of H/2 sweeps: the
    neighbours' rows, and at a non-periodic domain face the face's ghost
    plane H deep (the kernel applies the face's rule itself; the JAX
    kernel reads the plane next to the slab at its first pass)."""
    def rows(u):
        return (H,) + tuple(u.shape[1:])

    return _exchange_rows(
        u_s, H, nshards, kinds[0][0] == PERIODIC, lay,
        lambda u: _bc_plane(kinds[0][0], u[:1], u[1:2], rho).expand(rows(u)),
        lambda u: _bc_plane(kinds[0][1], u[-1:], u[-2:-1],
                            rho).expand(rows(u)))


def _coef_rows(arr_s: dict, H: int, nshards: int, periodic_x: bool,
               lay) -> dict:
    """The rhs or aCoef pads of every x-slab: the neighbours' rows, zeros
    beyond a non-periodic domain face."""
    def zeros(a):
        return torch.zeros((H,) + tuple(a.shape[1:]), dtype=a.dtype,
                           device=a.device)
    return _exchange_rows(arr_s, H, nshards, periodic_x, lay, zeros, zeros)


def _deep_pad_axis(shards: dict, axis: int, H: int, nshards: int, kinds,
                   rho: float, fill: str, lay):
    """(lo_pad, hi_pad) dicts of depth H along `axis`: the neighbour
    shards' slabs when the axis is cut, else the local wrap (periodic) or
    the fill rule; shards at a non-periodic domain face take the fill rule
    there instead of the wrapped slab:

      fill="ghost" — the one-ring ghost plane replicated H deep (u along x:
                     the kernel applies the face's rule itself, so deeper
                     rows are never read)
      fill="zero"  — zeros (rhs/aCoef everywhere, and ALL y pads: the
                     kernel's y fold is a one-way barrier at the domain
                     face)
    """
    periodic = kinds[axis][0] == PERIODIC

    def fill_pads(arr):
        n = arr.shape[axis]
        shape = list(arr.shape)
        shape[axis] = H
        if fill == "zero":
            z = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
            return z, z
        lo_g = _bc_plane(kinds[axis][0], arr.narrow(axis, 0, 1),
                         arr.narrow(axis, 1, 1), rho)
        hi_g = _bc_plane(kinds[axis][1], arr.narrow(axis, n - 1, 1),
                         arr.narrow(axis, n - 2, 1), rho)
        return lo_g.expand(shape), hi_g.expand(shape)

    if nshards == 1:
        lo, hi = {}, {}
        for k, arr in shards.items():
            n = arr.shape[axis]
            if periodic:
                lo[k] = arr.narrow(axis, n - H, H)
                hi[k] = arr.narrow(axis, 0, H)
            else:
                lo[k], hi[k] = fill_pads(arr)
        return lo, hi

    from_lo, from_hi = _ring_exchange_axis(shards, axis, nshards, lay,
                                           depth=H, wrap=periodic)
    if not periodic:
        for k, arr in shards.items():
            if k[axis] == 0:
                from_lo[k] = fill_pads(arr)[0]
            if k[axis] == nshards - 1:
                from_hi[k] = fill_pads(arr)[1]
    return from_lo, from_hi


def _prepad(arr_s: dict, H: int, x_fill: str, kinds, rho: float, counts,
            lay) -> dict:
    """Every pencil prepadded by H on both sides of x and y: a deep x
    exchange, then a deep y exchange of the x-EXTENDED array, so that the
    diagonal neighbours' corners ride along (x_fill: _deep_pad_axis)."""
    x_lo, x_hi = _deep_pad_axis(arr_s, 0, H, counts[0], kinds, rho, x_fill,
                                lay)
    ext = {k: torch.cat([x_lo[k], a, x_hi[k]], dim=0)
           for k, a in arr_s.items()}
    y_lo, y_hi = _deep_pad_axis(ext, 1, H, counts[1], kinds, rho, "zero",
                                lay)
    return {k: torch.cat([y_lo[k], e, y_hi[k]], dim=1)
            for k, e in ext.items()}


# ------------------------------------- coefficient shards, once per build


# the halo kernels' chunk of sweeps is fixed (fused_sweeps.sharded_plan),
# so one pad depth serves every call: the pads are built at it
def _kernel_pad_depth() -> int:
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

    return 2 * fs.MULTISWEEP_PLAN_CHUNK


def _route(spec, d: int, b_none: bool, dtype, device_type: str,
           n: int) -> str:
    """How a relax of n sweeps at cut depth d runs: "slab_kernel" /
    "pencil_kernel" (the halo kernels: f32, kernels allowed, constant
    bCoef, a sweep count the chunks divide, no odd periodic extent, z not
    cut) or "slab_plain" / "block_plain" (the plain sharded ops; variable
    bCoef always takes the block ops)."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    sx, sy, sz = mg._shard_counts(spec, d)
    slab = b_none and sy == 1 and sz == 1
    kernel = (b_none and sz == 1
              and mg._kernels_allowed_for(spec, dtype, device_type)
              and fs.sharded_plan(tuple(spec.boxes[d].shape), n,
                                  spec.kinds) is not None)
    if slab:
        return "slab_kernel" if kernel else "slab_plain"
    return "pencil_kernel" if kernel else "block_plain"


def _coef_item(spec, coefs: dict, d: int, entry: dict, name: str):
    """entry[name], made where it is missing: "a", "lam", "b" the
    coefficient's shards (the coefficient itself where it was made on the
    shards, else one coefficient split each), "apad" the x-slabs'
    aCoef pads, "apre" the pencils' prepadded aCoef (one pad build each),
    at the halo kernels' pad depth."""
    if name in entry:
        return entry[name]
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    counts = mg._shard_counts(spec, d)
    if name in ("a", "lam", "b"):
        t = coefs[name][d]
        if isinstance(t, ShardSet):  # made on the shards: nothing to cut
            assert t.counts == counts, (t.counts, counts)
            entry[name] = t
        else:
            entry[name] = None if t is None else ShardSet.split(
                t, spec.mesh, counts, spec.boxes[d].lo, "coef_splits")
        return entry[name]
    a_s = _coef_item(spec, coefs, d, entry, "a")
    H = _kernel_pad_depth()
    count_event(spec.mesh, "coef_pad_builds")
    kinds = spec.kinds
    if name == "apad":
        entry[name] = _coef_rows(a_s.shards, H, counts[0],
                                 kinds[0][0] == PERIODIC, a_s)
    else:
        entry[name] = _prepad(a_s.shards, H, "zero", kinds, spec.rho[d],
                              counts, a_s)
    return entry[name]


def shard_coefs(spec, coefs: dict) -> dict:
    """{d: entry} for every depth of `coefs`' chain that spec's mesh cuts:
    the shards of aCoef, and of lambda and bCoef where the plain sharded
    ops read them, and the aCoef pads the halo kernels read, for a relax of
    spec.nsmooth sweeps. Made once per coefficient build
    (multigrid.build_level_coefs, composite.build_coefs for its f32 set);
    a new build makes new shards and pads, so none can outlive the
    coefficients it was cut from."""
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    out = {}
    for d in range(spec.ndepths):
        if mg._shard_counts(spec, d) == (1, 1, 1):
            continue
        a, b = coefs["a"][d], coefs["b"][d]
        route = _route(spec, d, b is None, a.dtype, a.device.type,
                       spec.nsmooth)
        names = {"slab_kernel": ("a", "apad"),
                 "pencil_kernel": ("a", "apre"),
                 "slab_plain": ("a", "lam"),
                 "block_plain": ("a", "lam", "b")}[route]
        entry: dict = {}
        for name in names:
            _coef_item(spec, coefs, d, entry, name)
        out[d] = entry
    return out


def _coef_entry(coefs: dict, d: int) -> dict:
    """The cut coefficients of depth d made at the coefficient build, or
    an empty entry (filled per call) where `coefs` carries none."""
    cache = coefs.get("shards")
    if cache is not None and d in cache:
        return cache[d]
    return {}


# ---------------------------------------------- the solver's entry points


def _cut_of(spec, d: int):
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    return mg._shard_counts(spec, d)


def _resident(spec, d: int, *arrays):
    """The arrays as shard sets of depth d: shard sets as they are (they
    must be this depth's), whole tensors split (the per-call form). Returns
    (shard sets, whether the caller handed whole tensors)."""
    counts = _cut_of(spec, d)
    whole = not isinstance(arrays[0], ShardSet)
    out = []
    for t in arrays:
        if whole:
            t = ShardSet.split(t, spec.mesh, counts, spec.boxes[d].lo)
        assert isinstance(t, ShardSet) and t.counts == counts and (
            t.shape == tuple(spec.boxes[d].shape)), (
            "operands of one call must be shards of this depth")
        out.append(t)
    return out, whole


def sharded_relax(spec, coefs: dict, d: int, u: ShardSet, rhs: ShardSet,
                  n: int) -> ShardSet:
    """n red+black GSRB sweeps on an x-sharded depth through the halo
    kernel: each shard runs `fused_sweeps.multisweep_relax(halo=...)` on its
    slab with pads holding the neighbour shards' rows. Per chunk of S
    sweeps, 2S u-rows are exchanged per side; the rhs pads once per call
    and the aCoef pads once per coefficient build (shard_coefs), both
    built at the deepest chunk's depth and sliced per chunk; the kernel's
    meta marks which of the slab's x faces are the domain's (the ghost
    rule) and which are seams (the pads), and places the slab in the
    global frame. The halo recompute evaluates every seam row as the owning
    shard does, so the joined result is the unsharded kernel's up to the
    order of additions (bit for bit in the bf16 tier, which every shard's
    launch takes from the spec's smoother_compute)."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

    shape = tuple(spec.boxes[d].shape)
    nshards = u.counts[0]
    kinds, rho = spec.kinds, spec.rho[d]
    periodic_x = kinds[0][0] == PERIODIC
    chunk = fs.sharded_plan(shape, n, kinds)
    chunks = [chunk] * (n // chunk)
    entry = _coef_entry(coefs, d)
    a_s = _coef_item(spec, coefs, d, entry, "a").shards
    apad = _coef_item(spec, coefs, d, entry, "apad")
    h_max = _kernel_pad_depth()
    assert 2 * max(chunks) <= h_max
    kw = dict(kinds=kinds, rho=rho, alpha=spec.alpha, beta=spec.beta,
              dx=spec.dx[d], lo=spec.boxes[d].lo)
    meta = _metas(u.devs, u.counts, u.n_loc, periodic_x)
    # rhs does not change while relaxing: its pads once, at the deepest
    # chunk's depth, and sliced per chunk (as aCoef's)
    rpad = _coef_rows(rhs.shards, h_max, nshards, periodic_x, u)
    u_s = u.shards
    for c in chunks:
        H = 2 * c
        upad = _u_rows(u_s, kinds, rho, H, nshards, u)
        sl = slice(h_max - H, h_max + H)
        u_s = {k: fs.multisweep_relax(
            u_s[k], rhs.shards[k], a_s[k], nsweeps=c,
            halo=(upad[k], rpad[k][sl], apad[k][sl], meta[k]),
            compute_dtype=spec.smoother_compute, **kw)
            for k in u_s}
    return u.like(u_s)


def sharded_relax_2d(spec, coefs: dict, d: int, u: ShardSet, rhs: ShardSet,
                     n: int) -> ShardSet:
    """n red+black GSRB sweeps on an (x, y) pencil-cut depth through the
    prepadded halo kernel (`fused_sweeps.multisweep_relax_tiled_pre`) on
    each pencil. Per chunk of S sweeps each shard assembles its prepadded
    u (a 2S-deep halo on x AND y): a deep x exchange, then a deep y
    exchange of the x-EXTENDED array, so the diagonal neighbours' corners
    ride along; rhs is prepadded once per call and aCoef once per
    coefficient build (shard_coefs). The kernel's meta places the pencil
    in the global frame, so the checkerboard and the y face fold stay
    global, and the halo recompute evaluates every seam cell as its owning
    shard does. Every launch takes the spec's bf16 tier (smoother_compute)."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs

    shape = tuple(spec.boxes[d].shape)
    kinds, rho = spec.kinds, spec.rho[d]
    chunk = fs.sharded_plan(shape, n, kinds)
    H = 2 * chunk
    assert H == _kernel_pad_depth()
    counts = u.counts
    entry = _coef_entry(coefs, d)
    a_pre = _coef_item(spec, coefs, d, entry, "apre")
    kw = dict(kinds=kinds, rho=rho, alpha=spec.alpha, beta=spec.beta,
              dx=spec.dx[d], lo=spec.boxes[d].lo)
    meta = _metas(u.devs, counts, u.n_loc, kinds[0][0] == PERIODIC)
    r_pre = _prepad(rhs.shards, H, "zero", kinds, rho, counts, u)
    u_s = u.shards
    for _ in range(n // chunk):
        u_pre = _prepad(u_s, H, "ghost", kinds, rho, counts, u)
        u_s = {k: fs.multisweep_relax_tiled_pre(
            u_pre[k], r_pre[k], a_pre[k], meta[k], ny_global=shape[1],
            nsweeps=chunk, compute_dtype=spec.smoother_compute, **kw)
            for k in u_s}
    return u.like(u_s)


def relax(spec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black sweeps at a depth the mesh cuts (multigrid.relax routes
    here), by _route: the halo kernels (x-slabs, pencils), in the spec's
    bf16 tier where it has one, or the plain sharded ops (f64, `smoother =
    xla`, a sweep count the chunks do not divide, an odd periodic extent, a
    cut z axis, variable bCoef), which take no tier, as the JAX package's
    XLA fallbacks take none. Shard sets in, a shard set out; whole tensors
    in, the per-call form: split, relax, join."""
    if n <= 0:
        return u
    (u_s, rhs_s), whole = _resident(spec, d, u, rhs)
    b = coefs["b"][d]
    route = _route(spec, d, b is None, u_s.dtype, u_s.device.type, n)
    if route == "slab_kernel":
        out = sharded_relax(spec, coefs, d, u_s, rhs_s, n)
    elif route == "pencil_kernel":
        out = sharded_relax_2d(spec, coefs, d, u_s, rhs_s, n)
    else:
        entry = _coef_entry(coefs, d)
        a = _coef_item(spec, coefs, d, entry, "a").shards
        lam = _coef_item(spec, coefs, d, entry, "lam").shards
        if route == "slab_plain":
            relax_s, _ = _slab_ops(spec, d, u_s.counts[0], u_s, n)
            shards = relax_s(a, lam, u_s.shards, rhs_s.shards)
        else:
            b_s = _coef_item(spec, coefs, d, entry, "b")
            relax_s, _ = _block_ops(spec, d, u_s.counts, u_s, n)
            shards = relax_s(a, None if b_s is None else b_s.shards, lam,
                             u_s.shards, rhs_s.shards)
        out = u_s.like(shards)
    return out.join() if whole else out


def _residual_shards(spec, coefs: dict, d: int, u_s: ShardSet,
                     rhs_s: ShardSet) -> dict:
    """rhs - L(u) of every shard with the exchanged ghost planes (plain
    ops, as the JAX package's sharded residual): x-slabs exchange x planes
    only, pencils and blocks (and variable bCoef) every cut axis."""
    entry = _coef_entry(coefs, d)
    a = _coef_item(spec, coefs, d, entry, "a").shards
    b = coefs["b"][d]
    counts = u_s.counts
    if b is None and counts[1] == 1 and counts[2] == 1:
        _, residual_s = _slab_ops(spec, d, counts[0], u_s, 0)
        return residual_s(a, u_s.shards, rhs_s.shards)
    b_s = None if b is None else _coef_item(spec, coefs, d, entry,
                                            "b").shards
    _, residual_s = _block_ops(spec, d, counts, u_s, 0)
    return residual_s(a, b_s, u_s.shards, rhs_s.shards)


def residual(spec, coefs: dict, d: int, u, rhs):
    """res = rhs - L(u) at a depth the mesh cuts (the sharded counterpart
    of multigrid.residual_homog): shard sets in, a shard set out; whole
    tensors in, split and joined per call."""
    (u_s, rhs_s), whole = _resident(spec, d, u, rhs)
    out = u_s.like(_residual_shards(spec, coefs, d, u_s, rhs_s))
    return out.join() if whole else out


def residual_restrict(spec, coefs: dict, d: int, u, rhs, out=None,
                      keep: bool = False):
    """restrict_full(rhs - L(u)) at a depth the mesh cuts: every shard's
    residual (exchanged ghost planes) restricted on its own device, where
    each shard's edges fall on coarse-cell edges (an even local extent on
    every axis); else the shards' residual joined once and restricted
    whole (15 planes a shard of 60: the next depth is not cut alike; not
    with `keep`). Where the caller holds shard sets, no
    `out` is given and depth d+1 is cut as d is, the coarse shards stay
    where they are (the shard set of d+1); otherwise they are joined once,
    into `out` (e.g. the covered part of a parent level) or a new tensor
    on the home device. `keep`: the coarse shards stay where they are, as
    a shard set of this depth's cut and half its shape (the AMR
    downsweep writes it into the parent's covered part by a level
    window)."""
    (u_s, rhs_s), whole = _resident(spec, d, u, rhs)
    res = _residual_shards(spec, coefs, d, u_s, rhs_s)
    if any(n % 2 for n in u_s.n_loc):
        assert not keep, f"keep needs even local extents, got {u_s.n_loc}"
        rc = st.restrict_full(u_s.like(res).join())
        return rc if out is None else out.copy_(rc)
    coarse = {k: st.restrict_full(r) for k, r in res.items()}
    if keep:
        assert not whole and out is None
        return u_s.like(coarse, tuple(n // 2 for n in u_s.shape),
                        tuple(l // 2 for l in u_s.lo))
    if not whole and out is None and d + 1 < spec.ndepths and (
            _cut_of(spec, d + 1) == u_s.counts):
        return u_s.like(coarse, tuple(spec.boxes[d + 1].shape),
                        spec.boxes[d + 1].lo)
    shape = tuple(n // 2 for n in u_s.shape)
    return u_s.like(coarse, shape).join(out)


def split_level(spec, d: int, t) -> ShardSet:
    """Depth d of a level, whole, as a shard set of the mesh's cut: one
    level split."""
    return ShardSet.split(t, spec.mesh, _cut_of(spec, d), spec.boxes[d].lo)


def prolong_inc(u: ShardSet, ec) -> ShardSet:
    """u + the piecewise-constant prolongation of the coarse correction
    `ec`, shard by shard: ec a shard set of the same cut (the next depth
    of a chain cut alike), or whole (a strided view included): then the
    part under each shard is copied to it (one level split); where a
    shard's edge lies inside a coarse cell (an odd local extent), the part
    of ec prolonged whole."""
    if not isinstance(ec, ShardSet) and any(n % 2 for n in u.n_loc):
        up = u.region(st.upsample2(ec))
        return u.like({k: s + up[k] for k, s in u.shards.items()})
    ec_s = ec.shards if isinstance(ec, ShardSet) else u.region(ec)
    return u.like({k: st.prolong_inc(s, ec_s[k])
                   for k, s in u.shards.items()})


# ----------------------------------- the composite operator on the shards


def apply_homog(spec, coefs: dict, d: int, u: ShardSet) -> ShardSet:
    """L(u) with homogeneous ghosts at a depth the mesh cuts, shard by
    shard: each shard's one-ring ghost planes from its neighbours (a plane
    exchange per cut axis) and the face rules at the level's faces
    (_block_ghost), then the whole level's per-cell expression
    (st.apply_op). Each shard is the whole-level operator's
    (multigrid.apply_homog) on that shard, bit for bit: the same ghost
    values, the same arithmetic."""
    entry = _coef_entry(coefs, d)
    a = _coef_item(spec, coefs, d, entry, "a").shards
    b = None
    if coefs["b"][d] is not None:
        b = _coef_item(spec, coefs, d, entry, "b").shards
    gh = _block_ghost(spec, d, u.counts, u.shards, u)
    return u.like({k: st.apply_op(gh[k], a[k], None if b is None else b[k],
                                  spec.alpha, spec.beta, spec.dx[d])
                   for k in u.shards})


def cf_planes(geom, level: int, coarse_u, like, faces) -> dict:
    """{(k, axis, side): the coarse term's fine ghost plane of face (axis,
    side) over part k of `like`} for every part of the placed level `like`
    (a shard set, or a whole level whose parent is cut) that lies on one of
    `faces` (cf_interp.cf_faces). Each part's plane is the whole face's
    (cf_interp._coarse_plane_for_face) over the part's tangential extent,
    bit for bit: the parent cells it reads — the normal coarse plane and a
    ring of one cell around the part's coarse extent, clipped at the
    parent's box — come in ONE level window for all parts and faces, and
    the clipped edges are replicated as the whole face's are."""
    from mg_ic_code_tpu_torch.ops import cf_interp as cfi

    box = geom.boxes[level]
    shape = like.shape if isinstance(like, ShardSet) else tuple(like.shape)
    regions, devs, pos, reads = {}, {}, {}, {}
    for axis, side, wrap in faces:
        taxes = [t for t in range(3) if t != axis]
        for k, (_, org, n, dev, p) in parts(like).items():
            if (org[axis] != 0 if side == 0
                    else org[axis] + n[axis] != shape[axis]):
                continue
            fine = [(box.lo[tt] + org[tt], box.lo[tt] + org[tt] + n[tt] - 1)
                    for tt in taxes]
            idx, pads = cfi.coarse_plane_read(geom, level, axis, side, wrap,
                                              fine)
            lo = tuple(i if ax == axis else i.start for ax, i in
                       enumerate(idx))
            hi = tuple(i + 1 if ax == axis else i.stop for ax, i in
                       enumerate(idx))
            key = (k, axis, side)
            regions[key], devs[key], pos[key] = (lo, hi), dev, p
            reads[key] = (pads, fine)
    if not regions:
        return {}
    mesh = next((x.mesh for x in (like, coarse_u) if isinstance(x, ShardSet)),
                None)
    out = {}
    for key, w in window(coarse_u, regions, devs, pos, mesh).items():
        pads, fine = reads[key]
        plane = cfi.plane_from_read(w.squeeze(key[1]), pads)
        # the read refines to fine cells [2 (lo // 2), 2 (hi // 2) + 1]
        out[key] = plane[tuple(slice(f0 - 2 * (f0 // 2),
                                     f1 - 2 * (f0 // 2) + 1)
                               for f0, f1 in fine)]
    return out


def add_cf_coarse_term(arr, geom, level: int, coarse_u, scale, b_coef,
                       faces):
    """cf_interp.add_cf_coarse_term where `arr` (or its parent `coarse_u`)
    is a level cut over the mesh: the term on every face cell of every
    part of `arr` that lies on a CF face, in cf_faces' order, from the face
    planes of cf_planes (one level window). Each shard is the whole level's
    result on that shard, bit for bit."""
    from mg_ic_code_tpu_torch.ops import cf_interp as cfi

    planes = cf_planes(geom, level, coarse_u, arr, faces)
    out = arr.clone()
    b_parts = None if b_coef is None else parts(b_coef)
    for axis, side, _ in faces:
        for k, (t, _, _, _, _) in parts(out).items():
            plane = planes.get((k, axis, side))
            if t is None or plane is None:
                continue
            idx: list = [slice(None)] * 3
            idx[axis] = 0 if side == 0 else t.shape[axis] - 1
            term = scale * cfi.W_COARSE * plane.to(t.dtype)
            if b_parts is not None:
                term = term * b_parts[k][0][tuple(idx)]
            t[tuple(idx)] += term
    return out


def fill_ghosts(u, geom, level: int, coarse_u, homogeneous_phys: bool = False,
                dirichlet_shift: float = 0.0, planes: dict | None = None):
    """ghosts.fill_ghosts where `u` (or its parent `coarse_u`) is a level
    cut over the mesh: every part of `u` with a one-ring ghost. A seam
    takes the neighbour's plane (one plane exchange per cut axis, the wrap
    included where the level spans a periodic axis); a face of the level
    takes ghosts.face_ghost with the part's own planes and, on a CF face,
    the coarse plane of cf_planes (`planes`, or one level window here).
    The face ghosts are the whole level's, bit for bit; edge and corner
    ghosts are left 0 (no 7-point stencil reads them)."""
    from mg_ic_code_tpu_torch.ops import cf_interp as cfi
    from mg_ic_code_tpu_torch.ops.ghosts import face_class, face_ghost

    if planes is None and coarse_u is not None:
        planes = cf_planes(geom, level, coarse_u, u,
                           cfi.cf_faces(geom, level))
    cut = isinstance(u, ShardSet)
    counts = u.counts if cut else (1, 1, 1)
    pieces = {k: p.t for k, p in parts(u).items() if p.t is not None}
    out = {k: F.pad(t, (1, 1, 1, 1, 1, 1)) for k, t in pieces.items()}
    for axis in range(3):
        n = counts[axis]
        periodic = face_class(geom, level, axis, 0)[0] == "wrap"
        seams = ({}, {})
        if n > 1:
            seams = _ring_exchange_axis(u.shards, axis, n, u,
                                        wrap=periodic)
        for k, t in pieces.items():
            m = t.shape[axis]
            for side in (0, 1):
                edge = k[axis] == (0 if side == 0 else n - 1)
                if not edge or (periodic and n > 1):
                    plane = seams[side][k]
                elif periodic:
                    plane = t.narrow(axis, m - 1 if side == 0 else 0, 1)
                else:
                    cls, _ = face_class(geom, level, axis, side)
                    i0, i1 = (0, 1) if side == 0 else (m - 1, m - 2)
                    cplane = None
                    if cls == "cf" and planes:
                        cplane = planes[(k, axis, side)].to(
                            t.dtype).unsqueeze(axis)
                    plane = face_ghost(
                        geom, level, axis, side, cls, t.narrow(axis, i0, 1),
                        t.narrow(axis, i1, 1), cplane, homogeneous_phys,
                        dirichlet_shift)
                idx: list = [_I, _I, _I]
                idx[axis] = slice(0, 1) if side == 0 else slice(m + 1, m + 2)
                out[k][tuple(idx)] = plane
    return u.like(out) if cut else out[(0, 0, 0)]


def gsrb_color(spec, coefs: dict, u: ShardSet, u_gh: ShardSet,
               rhs: ShardSet, color: int) -> ShardSet:
    """st.gsrb_color at depth 0 on every shard of a ghosted level
    (fill_ghosts), the checkerboard in the level's global frame (each
    shard offset by its origin)."""
    entry = _coef_entry(coefs, 0)
    a = _coef_item(spec, coefs, 0, entry, "a").shards
    lam = _coef_item(spec, coefs, 0, entry, "lam").shards
    b = _coef_item(spec, coefs, 0, entry, "b")
    lo = spec.boxes[0].lo
    return u.like({k: st.gsrb_color(
        u_gh.shards[k], rhs.shards[k], a[k], None if b is None else
        b.shards[k], lam[k], spec.alpha, spec.beta, spec.dx[0],
        tuple(l + o for l, o in zip(lo, u.origin(k))), color)
        for k in u.shards})
