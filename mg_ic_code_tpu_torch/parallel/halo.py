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

A level comes in whole (on the mesh's home device, mesh.py) and goes back
whole: each function cuts it into per-shard tensors on the shards' devices,
works on those and joins the result on the home device. Shards are keyed by
their (ix, iy, iz) position; a mesh axis that does not cut the level puts
every shard at its coordinate 0 (the JAX package's replicas along that
axis compute the same values, and the port computes them once).
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from mg_ic_code_tpu_torch.ops import stencils as st
from mg_ic_code_tpu_torch.ops.ghosts import PERIODIC, ghost_plane
from mg_ic_code_tpu_torch.parallel.mesh import AXES, AXIS

_I = slice(1, -1)


# ------------------------------------------------------------ shard grids


def _grid(mesh, counts) -> dict:
    """{(ix, iy, iz): device} of a level cut counts[axis] ways per axis."""
    return {
        k: mesh.device_at({AXES[ax]: k[ax] for ax in range(3)
                           if counts[ax] > 1})
        for k in itertools.product(*(range(c) for c in counts))
    }


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device`, never a view or `t` itself."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _split(arr, counts, devs: dict) -> dict:
    """The shards of a whole level, each copied to its device."""
    n_loc = [arr.shape[ax] // counts[ax] for ax in range(3)]
    return {
        k: _copy_to(arr[tuple(slice(k[ax] * n_loc[ax], (k[ax] + 1) * n_loc[ax])
                              for ax in range(3))], dev)
        for k, dev in devs.items()
    }


def _join(shards: dict, counts, home) -> torch.Tensor:
    """The whole level on `home` from its shards."""
    def block(prefix, ax):
        if ax == 3:
            return shards[prefix].to(home)
        return torch.cat([block(prefix + (i,), ax + 1)
                          for i in range(counts[ax])], dim=ax)
    return block((), 0)


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
                   periodic_x: bool, devs: dict) -> dict:
    """Each shard's one-ring ghosted array: x neighbour planes (the 1-D
    instance of _axis_planes: mesh-edge shards take the physical / CF rule)
    and local y/z fills."""
    from_left, from_right = _axis_planes(
        u_locs, 0, kinds[0][0], kinds[0][1], rho, periodic_x, nshards, devs)
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


def _ring_exchange_axis(shards: dict, axis: int, nshards: int, devs: dict,
                        depth: int = 1):
    """The `depth`-deep boundary slabs of every shard along array `axis`,
    each copied to the neighbour that reads it: (from_lo, from_hi), where
    from_lo[k] is the top of k's lower neighbour along the ring and
    from_hi[k] the bottom of its upper one. All copies are made before
    anything is updated."""
    from_lo, from_hi = {}, {}
    for k in shards:
        lo = shards[_neighbour(k, axis, -1, nshards)]
        hi = shards[_neighbour(k, axis, 1, nshards)]
        from_lo[k] = _copy_to(lo.narrow(axis, lo.shape[axis] - depth, depth),
                              devs[k])
        from_hi[k] = _copy_to(hi.narrow(axis, 0, depth), devs[k])
    return from_lo, from_hi


def _axis_planes(shards: dict, axis: int, kind_lo: str, kind_hi: str,
                 rho: float, periodic: bool, nshards: int, devs: dict):
    """The two ghost planes of every shard along `axis`: the neighbours'
    planes over the ring when the axis is cut (nshards > 1), else the local
    wrap / BC rule; shards at a non-periodic domain face take the physical
    or CF rule there instead of the wrapped plane."""
    def pl(arr, i0):
        return arr.narrow(axis, i0, 1)

    if nshards > 1:
        from_lo, from_hi = _ring_exchange_axis(shards, axis, nshards, devs)
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


# ------------------------------------------------------- plain level ops


def make_sharded_level_ops(spec, mesh, d: int = 0, nsweeps: int | None = None,
                           overlap: bool = True):
    """Relax / residual for depth `d` of a level cut into x-slabs over the
    mesh's x axis: (relax_fn(a, lam, u, rhs), residual_fn(a, u, rhs)), each
    taking and returning whole levels; relax runs `nsweeps` (default
    spec.nsmooth) red+black sweeps, each colour after a plane exchange.

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
    nshards = mesh.shape[AXIS]
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
    counts = (nshards, 1, 1)
    devs = _grid(mesh, counts)

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
        u_gh = _sharded_ghost(uu, kinds, rho, nshards, periodic_x, devs)
        out = {}
        for k, u in uu.items():
            lofu = st.apply_op(u_gh[k], a[k], None, alpha, beta, dx)
            out[k] = masked(u - lam[k] * (lofu - rhs[k]), u, lo_sum(k), i % 2)
        return out

    def half_overlap(i, uu, a, lam, rhs):
        color = i % 2
        # 1. the exchange of the boundary planes
        from_left, from_right = _axis_planes(
            uu, 0, kinds[0][0], kinds[0][1], rho, periodic_x, nshards, devs)
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

    def relax_fn(a, lam, u, rhs):
        a_s, lam_s, rhs_s = (_split(t, counts, devs) for t in (a, lam, rhs))
        uu = _split(u, counts, devs)
        for i in range(2 * nsweeps):
            uu = half(i, uu, a_s, lam_s, rhs_s)
        return _join(uu, counts, u.device)

    def residual_fn(a, u, rhs):
        a_s, u_s, rhs_s = (_split(t, counts, devs) for t in (a, u, rhs))
        u_gh = _sharded_ghost(u_s, kinds, rho, nshards, periodic_x, devs)
        res = {k: st.residual(u_gh[k], rhs_s[k], a_s[k], None, alpha, beta,
                              dx) for k in u_s}
        return _join(res, counts, u.device)

    return relax_fn, residual_fn


def make_sharded_level_ops_2d(spec, mesh, d: int = 0,
                              nsweeps: int | None = None,
                              with_b: bool = False):
    """Relax / residual for a level cut over a 2-D (x, y) pencil or 3-D
    (x, y, z) block mesh: per half-sweep the one-cell boundary planes of
    every cut axis are exchanged, one axis after the other on the
    progressively extended array, so corner and edge values ride along
    (the reference's full-boundary Copier exchange,
    VariableCoeffPoissonOperatorFactory.cpp:82-96).

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
    kinds = spec.kinds
    rho = spec.rho[d]
    dx = spec.dx[d]
    alpha, beta = spec.alpha, spec.beta
    box = spec.boxes[d]
    n_loc = tuple(box.shape[ax] // counts[ax] for ax in range(3))
    devs = _grid(mesh, counts)

    def ghost(uu):
        ext = uu
        for ax in range(3):
            lo, hi = _axis_planes(
                ext, ax, kinds[ax][0], kinds[ax][1], rho,
                kinds[ax][0] == PERIODIC, counts[ax], devs)
            ext = {k: torch.cat([lo[k], e, hi[k]], dim=ax)
                   for k, e in ext.items()}
        return ext

    def lo_sum(k):
        return sum(box.lo) + sum(k[ax] * n_loc[ax] for ax in range(3)
                                 if counts[ax] > 1)

    def relax_body(a, b, lam, u, rhs):
        a_s, lam_s, rhs_s, uu = (_split(t, counts, devs)
                                 for t in (a, lam, rhs, u))
        b_s = None if b is None else _split(b, counts, devs)
        for i in range(2 * nsweeps):
            u_gh = ghost(uu)
            out = {}
            for k, uc in uu.items():
                lofu = st.apply_op(u_gh[k], a_s[k],
                                   None if b_s is None else b_s[k],
                                   alpha, beta, dx)
                upd = uc - lam_s[k] * (lofu - rhs_s[k])
                mask = st.color_mask(uc.shape, (lo_sum(k), 0, 0), i % 2,
                                     device=uc.device)
                out[k] = torch.where(mask, upd, uc)
            uu = out
        return _join(uu, counts, u.device)

    def residual_body(a, b, u, rhs):
        a_s, u_s, rhs_s = (_split(t, counts, devs) for t in (a, u, rhs))
        b_s = None if b is None else _split(b, counts, devs)
        u_gh = ghost(u_s)
        res = {k: st.residual(u_gh[k], rhs_s[k], a_s[k],
                              None if b_s is None else b_s[k],
                              alpha, beta, dx) for k in u_s}
        return _join(res, counts, u.device)

    if with_b:
        return relax_body, residual_body
    return (lambda a, lam, u, rhs: relax_body(a, None, lam, u, rhs),
            lambda a, u, rhs: residual_body(a, None, u, rhs))


# ------------------------------------------------------- the halo kernels


def _exchange_rows(shards: dict, H: int, nshards: int, periodic_x: bool,
                   devs: dict, lo_fill=None, hi_fill=None) -> dict:
    """(2H, ny, nz) halo pad of every x-slab: rows [0,H) = the lower
    neighbour's top H rows, rows [H,2H) = the upper neighbour's bottom H
    rows (the deep-halo generalisation of the reference's face Copiers).
    Unless x is periodic (the ring wrap IS the boundary rule), the first
    shard takes `lo_fill` below and the last `hi_fill` above."""
    from_left, from_right = _ring_exchange_axis(shards, 0, nshards, devs,
                                                depth=H)
    if not periodic_x:
        for k in shards:
            if k[0] == 0:
                from_left[k] = lo_fill
            if k[0] == nshards - 1:
                from_right[k] = hi_fill
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
            devs: dict) -> dict:
    """The u pads of every x-slab for a chunk of H/2 sweeps: the
    neighbours' rows, and at a non-periodic domain face the face's ghost
    plane H deep (the kernel applies the face's rule itself; the JAX
    kernel reads the plane next to the slab at its first pass)."""
    periodic_x = kinds[0][0] == PERIODIC
    lo_fill = hi_fill = None
    if not periodic_x:
        ul, uh = u_s[(0, 0, 0)], u_s[(nshards - 1, 0, 0)]
        rows = (H,) + tuple(ul.shape[1:])
        lo_fill = _bc_plane(kinds[0][0], ul[:1], ul[1:2], rho).expand(rows)
        hi_fill = _bc_plane(kinds[0][1], uh[-1:], uh[-2:-1], rho).expand(rows)
    return _exchange_rows(u_s, H, nshards, periodic_x, devs, lo_fill,
                          hi_fill)


def _coef_rows(arr_s: dict, H: int, nshards: int, periodic_x: bool,
               devs: dict) -> dict:
    """The rhs or aCoef pads of every x-slab: the neighbours' rows, zeros
    beyond a non-periodic domain face."""
    def zeros(k):
        a = arr_s[k]
        return torch.zeros((H,) + tuple(a.shape[1:]), dtype=a.dtype,
                           device=a.device)
    return _exchange_rows(arr_s, H, nshards, periodic_x, devs,
                          zeros((0, 0, 0)), zeros((nshards - 1, 0, 0)))


def sharded_relax(spec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black GSRB sweeps on an x-sharded level through the halo
    kernel: each shard runs `fused_sweeps.multisweep_relax(halo=...)` on its
    slab with pads holding the neighbour shards' rows. Per chunk of S
    sweeps, 2S u-rows are exchanged per side (rhs/aCoef pads once, at the
    deepest chunk's depth: they do not change while relaxing), and the
    kernel's meta marks which of the slab's x faces are the domain's (the
    ghost rule) and which are seams (the pads), and places the slab in the
    global frame. The halo recompute evaluates every seam row as the owning
    shard does, so the joined result is the unsharded kernel's up to the
    order of additions.

    Where the kernel path is not taken (f64, `smoother = xla`, a sweep
    count the chunks do not divide, an odd periodic extent, variable
    bCoef) the plain sharded ops run (make_sharded_level_ops)."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    mesh = spec.mesh
    nshards = mesh.shape[AXIS]
    shape = tuple(spec.boxes[d].shape)
    nx_loc = shape[0] // nshards
    kinds, rho = spec.kinds, spec.rho[d]
    periodic_x = kinds[0][0] == PERIODIC
    a = coefs["a"][d]

    chunk = None
    if mg._kernels_allowed(spec, u) and coefs["b"][d] is None:
        chunk = fs.sharded_plan(shape, n, kinds)
    if chunk is None:
        relax_fn, _ = make_sharded_level_ops(spec, mesh, d, nsweeps=n)
        return relax_fn(a, coefs["lam"][d], u, rhs)

    chunks = [chunk] * (n // chunk)
    h_max = 2 * max(chunks)
    counts = (nshards, 1, 1)
    devs = _grid(mesh, counts)
    kw = dict(kinds=kinds, rho=rho, alpha=spec.alpha, beta=spec.beta,
              dx=spec.dx[d], lo=spec.boxes[d].lo)
    meta = _metas(devs, counts, (nx_loc, 0, 0), periodic_x)
    u_s, rhs_s, a_s = (_split(t, counts, devs) for t in (u, rhs, a))
    # rhs and aCoef do not change while relaxing: their pads once, at the
    # deepest chunk's depth, and sliced per chunk
    rpad = _coef_rows(rhs_s, h_max, nshards, periodic_x, devs)
    apad = _coef_rows(a_s, h_max, nshards, periodic_x, devs)
    for c in chunks:
        H = 2 * c
        upad = _u_rows(u_s, kinds, rho, H, nshards, devs)
        sl = slice(h_max - H, h_max + H)
        u_s = {k: fs.multisweep_relax(
            u_s[k], rhs_s[k], a_s[k], nsweeps=c,
            halo=(upad[k], rpad[k][sl], apad[k][sl], meta[k]), **kw)
            for k in u_s}
    return _join(u_s, counts, u.device)


def _deep_pad_axis(shards: dict, axis: int, H: int, nshards: int, kinds,
                   rho: float, fill: str, devs: dict):
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

    from_lo, from_hi = _ring_exchange_axis(shards, axis, nshards, devs,
                                           depth=H)
    if not periodic:
        for k, arr in shards.items():
            if k[axis] == 0:
                from_lo[k] = fill_pads(arr)[0]
            if k[axis] == nshards - 1:
                from_hi[k] = fill_pads(arr)[1]
    return from_lo, from_hi


def _prepad(arr_s: dict, H: int, x_fill: str, kinds, rho: float, counts,
            devs: dict) -> dict:
    """Every pencil prepadded by H on both sides of x and y: a deep x
    exchange, then a deep y exchange of the x-EXTENDED array, so that the
    diagonal neighbours' corners ride along (x_fill: _deep_pad_axis)."""
    x_lo, x_hi = _deep_pad_axis(arr_s, 0, H, counts[0], kinds, rho, x_fill,
                                devs)
    ext = {k: torch.cat([x_lo[k], a, x_hi[k]], dim=0)
           for k, a in arr_s.items()}
    y_lo, y_hi = _deep_pad_axis(ext, 1, H, counts[1], kinds, rho, "zero",
                                devs)
    return {k: torch.cat([y_lo[k], e, y_hi[k]], dim=1)
            for k, e in ext.items()}


def sharded_relax_2d(spec, coefs: dict, d: int, u, rhs, n: int):
    """n red+black GSRB sweeps on an (x, y) pencil-cut level through the
    prepadded halo kernel (`fused_sweeps.multisweep_relax_tiled_pre`) on
    each pencil. Per chunk of S sweeps each shard assembles its prepadded
    array (a 2S-deep halo on x AND y): a deep x exchange, then a deep y
    exchange of the x-EXTENDED array, so the diagonal neighbours' corners
    ride along. The kernel's meta places the pencil in the global frame,
    so the checkerboard and the y face fold stay global, and the halo
    recompute evaluates every seam cell as its owning shard does.

    Where the pencil cannot take the kernel (a cut z axis, f64,
    `smoother = xla`, variable bCoef, a sweep count the chunks do not
    divide, an odd periodic extent) the plain pencil ops run
    (make_sharded_level_ops_2d)."""
    from mg_ic_code_tpu_torch.ops import fused_sweeps as fs
    from mg_ic_code_tpu_torch.solver import multigrid as mg

    mesh = spec.mesh
    sx, sy, sz = mg._shard_counts(spec, d)
    shape = tuple(spec.boxes[d].shape)
    nx_loc, ny_loc = shape[0] // sx, shape[1] // sy
    kinds, rho = spec.kinds, spec.rho[d]

    chunk = None
    if (sz == 1  # the kernel keeps z whole
            and mg._kernels_allowed(spec, u)
            and coefs["b"][d] is None):
        chunk = fs.sharded_plan(shape, n, kinds)
    if chunk is None:
        relax_fn, _ = make_sharded_level_ops_2d(spec, mesh, d, nsweeps=n)
        return relax_fn(coefs["a"][d], coefs["lam"][d], u, rhs)

    chunks = [chunk] * (n // chunk)
    counts = (sx, sy, 1)
    devs = _grid(mesh, counts)
    kw = dict(kinds=kinds, rho=rho, alpha=spec.alpha, beta=spec.beta,
              dx=spec.dx[d], lo=spec.boxes[d].lo)
    meta = _metas(devs, counts, (nx_loc, ny_loc, 0),
                  kinds[0][0] == PERIODIC)
    u_s, rhs_s, a_s = (_split(t, counts, devs)
                       for t in (u, rhs, coefs["a"][d]))
    for c in chunks:
        H = 2 * c
        u_pre = _prepad(u_s, H, "ghost", kinds, rho, counts, devs)
        r_pre = _prepad(rhs_s, H, "zero", kinds, rho, counts, devs)
        a_pre = _prepad(a_s, H, "zero", kinds, rho, counts, devs)
        u_s = {k: fs.multisweep_relax_tiled_pre(
            u_pre[k], r_pre[k], a_pre[k], meta[k], ny_global=shape[1],
            nsweeps=c, **kw) for k in u_s}
    return _join(u_s, counts, u.device)


def sharded_residual(spec, coefs: dict, d: int, u, rhs):
    """res = rhs - L(u) on an x-sharded level with the exchanged ghost
    planes (the sharded counterpart of multigrid.residual_homog)."""
    _, residual_fn = make_sharded_level_ops(spec, spec.mesh, d)
    return residual_fn(coefs["a"][d], u, rhs)
